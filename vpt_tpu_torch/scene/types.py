"""Host scene description and the device-resident scene containers.

Host types (`Scene`, `Mesh`, `Instance`, `Material`, `Volume`,
`default_textures`) are jax-free copies of vpt_tpu/scene/types.py.  The device containers hold
torch tensors and carry only the fields the ported render path reads; the
JAX package's TPU-only layouts (the lane-interleaved `tris_rk` blocks and
the group DMA table) are not carried; the sub-block boxes that `tris_rk`
holds in its metadata rows are a table of their own, `sub_aabbs`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host types


@dataclasses.dataclass
class Material:
    """Mirrors PathTracer::Material (PathTracer.h:12-34)."""

    name: str = "material"
    base_color: tuple = (1.0, 1.0, 1.0)
    emissive_color: tuple = (0.0, 0.0, 0.0)
    specular_color: tuple = (1.0, 1.0, 1.0)
    medium_color: tuple = (1.0, 1.0, 1.0)
    medium_emissive_color: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    transmission: float = 0.0
    anisotropy: float = 0.0
    anisotropy_rotation: float = 0.0
    medium_density: float = 0.0
    medium_anisotropy: float = 0.0
    base_color_texture: int = 0  # indices into the scene texture list
    normal_texture: int = 1
    roughness_texture: int = 2
    metallic_texture: int = 2
    emissive_texture: int = 2


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh, P3/N3/UV2."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (I,) u32, triples
    name: str = "mesh"

    @property
    def n_tris(self) -> int:
        return int(self.indices.shape[0] // 3)


@dataclasses.dataclass
class Instance:
    mesh: int  # index into Scene.meshes
    material: int  # index into Scene.materials
    transform: np.ndarray  # (4, 4) f32 object->world
    name: str = "instance"


@dataclasses.dataclass
class Volume:
    """Host volume description; mirrors PathTracer::Volume (PathTracer.h:36-74).

    `density_grid` / `temperature_grid` are optional dense (D, H, W) float32
    arrays."""

    corner_min: tuple = (-1.0, -1.0, -1.0)
    corner_max: tuple = (1.0, 1.0, 1.0)
    position: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    color: tuple = (0.8, 0.8, 0.8)
    emissive_color: tuple = (0.0, 0.0, 0.0)
    temperature_color: tuple = (1.0, 0.5, 0.0)
    density: float = 1.0
    anisotropy: float = 0.0
    alpha: float = 1.0
    droplet_size: float = 20.0
    use_blackbody: bool = True
    temperature_gamma: float = 1.0
    temperature_scale: float = 1.0
    emissive_color_gamma: float = 1.0
    kelvin_min: int = 500
    kelvin_max: int = 8000
    approximated_scattering_for_clouds: bool = False
    approximated_scattering_falloff: float = 0.8
    grid_sharpness: float = 1.0
    density_grid: Optional[np.ndarray] = None  # (D, H, W) f32
    temperature_grid: Optional[np.ndarray] = None

    def world_corners(self):
        """Position and scale applied like VolumeGPU's constructor (PathTracer.h:396-397)."""
        pos = np.asarray(self.position, np.float32)
        scl = np.asarray(self.scale, np.float32)
        return (
            pos + np.asarray(self.corner_min, np.float32) * scl,
            pos + np.asarray(self.corner_max, np.float32) * scl,
        )


@dataclasses.dataclass
class Scene:
    meshes: list
    instances: list
    materials: list
    textures: list  # (H, W, 4) float32 in [0, 1]; slots 0/1/2 are the defaults
    camera_view: Optional[np.ndarray] = None  # (4, 4) view matrix
    camera_fov_deg: float = 45.0
    camera_aspect: float = 16.0 / 9.0
    env_map: Optional[np.ndarray] = None  # (H, W, >=3) float32 radiance
    name: str = "scene"

    def __post_init__(self):
        if not self.textures:
            self.textures = default_textures()


def default_textures():
    """Slot 0: white RGBA, slot 1: flat normal, slot 2: white single-channel."""
    white = np.ones((1, 1, 4), np.float32)
    flat_normal = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32), (1, 1, 1))
    return [white, flat_normal, white.copy()]


# ---------------------------------------------------------------------------
# Device containers

# Packed per-triangle attribute row (SceneData.tri_attr):
#   0:3 p0 | 3:6 e1 | 6:9 e2 | 9:12 n0 | 12:15 n1 | 15:18 n2
#   18:20 uv0 | 20:22 uv1 | 22:24 uv2
#   24 material id | 25 local tri | 26 instance id
#   27 emissive tri count of the instance (0 = not emissive) | 28:32 pad
TRI_ATTR_COLS = 32

# Packed per-material row (SceneData.material_attr):
#   0:3 base_color | 3:6 emissive_color | 6:9 specular_color
#   9:12 medium_color | 12:15 medium_emissive_color
#   15 metallic | 16 roughness | 17 ior | 18 transmission | 19 anisotropy
#   20 anisotropy_rotation | 21 medium_density | 22 medium_anisotropy
#   23 base_color_tex | 24 normal_tex | 25 roughness_tex | 26 metallic_tex
#   27 emissive_tex | 28:32 pad
MAT_ATTR_COLS = 32


class ClusterData(NamedTuple):
    """Two-level (group -> cluster) tables with instancing.

    `tris` holds one block per unique-mesh cluster in mesh-local space; the
    per-cluster tables are per instance-cluster with world boxes and the
    instance's world->local affine.  Group g = clusters
    [g * GROUP_SIZE, (g + 1) * GROUP_SIZE)."""

    aabbs: torch.Tensor  # (C, 6) f32 world boxes [min.xyz, max.xyz]
    group_min: torch.Tensor  # (G, 3)
    group_max: torch.Tensor  # (G, 3)
    start: torch.Tensor  # (C,) i32 virtual triangle-id base
    count: torch.Tensor  # (C,) i32 triangles in the cluster (0 = pad slot)
    block_id: torch.Tensor  # (C,) i32 row of `tris`
    inst: torch.Tensor  # (C,) i32 owning instance
    inv_rows: torch.Tensor  # (n_inst, 12) f32 row-major [R | T] world->local
    tris: torch.Tensor  # (B, 16, K) f32 rows 0-8 = p0.xyz, e1.xyz, e2.xyz
    sub_aabbs: torch.Tensor  # (B, 8, 6) f32 mesh-local box of each K / 8-triangle
    # sub-block [lo.xyz, hi.xyz]; lo = 3e9, hi = -3e9 where the sub-block is empty

    @property
    def p0(self):
        return self.tris[:, 0:3, :]

    @property
    def e1(self):
        return self.tris[:, 3:6, :]

    @property
    def e2(self):
        return self.tris[:, 6:9, :]

    @property
    def n_clusters(self) -> int:
        return int(self.aabbs.shape[0])


class EnvMapData(NamedTuple):
    image: torch.Tensor  # (H, W, 4) f32; alpha = sampling PDF
    alias: torch.Tensor  # (H*W, 2) f32 packed [importance, alias index]
    quad: torch.Tensor  # (H, W, 16) 2x2 neighbourhoods, or a (1, 1, 16) sentinel


class EmissiveTable(NamedTuple):
    attr: torch.Tensor  # (EM, 4) f32 [tri_count, offset, instance, material]
    slot_table: torch.Tensor  # (sum tri_count,) i32 virtual triangle ids
    tri_rows: torch.Tensor  # (sum tri_count, TRI_ATTR_COLS) f32


class VolumeTable(NamedTuple):
    """AABB participating media (reference: VolumeGPU, PathTracer.h:341-400)."""

    corner_min: torch.Tensor  # (NV, 3)
    corner_max: torch.Tensor  # (NV, 3)
    color: torch.Tensor  # (NV, 3)
    emissive_color: torch.Tensor  # (NV, 3)
    temperature_color: torch.Tensor  # (NV, 3)
    density: torch.Tensor  # (NV,)
    anisotropy: torch.Tensor
    alpha: torch.Tensor
    droplet_size: torch.Tensor
    density_grid_index: torch.Tensor  # (NV,) i32; -1 = homogeneous
    max_density: torch.Tensor  # (NV,)
    use_blackbody: torch.Tensor  # (NV,) i32
    has_temperature: torch.Tensor  # (NV,) i32
    temperature_gamma: torch.Tensor
    temperature_scale: torch.Tensor
    emissive_color_gamma: torch.Tensor
    kelvin_min: torch.Tensor
    kelvin_max: torch.Tensor
    approx_cloud_scattering: torch.Tensor  # (NV,) i32
    approx_scattering_falloff: torch.Tensor
    grid_sharpness: torch.Tensor
    # Dense bricks of the heterogeneous volumes, padded to a common shape:
    density_grids: torch.Tensor  # (G, D, H, W) f32 (G may be 0)
    temperature_grids: torch.Tensor  # (G, D, H, W) f32, normalised to [0, 1]
    max_density_blocks: torch.Tensor  # (G, 32, 32, 32) f32 empty-space skipping


class SceneData(NamedTuple):
    tri_p0: torch.Tensor  # (T', 3) world space, padded by LEAF_SIZE
    tri_e1: torch.Tensor  # (T', 3)
    tri_e2: torch.Tensor  # (T', 3)
    tri_attr: torch.Tensor  # (T', TRI_ATTR_COLS)
    clusters: ClusterData
    material_attr: torch.Tensor  # (M, MAT_ATTR_COLS)
    emissive: EmissiveTable
    env: EnvMapData
    textures: torch.Tensor  # (P,) i64 packed RGBA8 texels (r | g<<8 | b<<16 | a<<24)
    texture_dims: torch.Tensor  # (K, 3) i32 (height, width, pool offset)
    volumes: VolumeTable
    lookup_reflect: torch.Tensor  # (7, 11, 13) Chebyshev coefficients
    lookup_refract_out: torch.Tensor
    lookup_refract_in: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts (see vpt_tpu/scene/types.py SceneMeta)."""

    n_tris: int
    n_instances: int
    n_materials: int
    n_emissive: int
    n_volumes: int
    n_het_volumes: int
    use_brute_force: bool
    has_textures: bool = True
    name: str = "scene"
    scene_scale: float = 1.0
    scene_center: tuple = (0.0, 0.0, 0.0)


def tree_to_device(tree, device):
    """Map every numpy leaf of a (nested) NamedTuple to a tensor on `device`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_device(x, device) for x in tree))
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)  # torch has no general uint32 arithmetic
    return torch.tensor(arr, device=device)
