"""Carry a scene compiled by the JAX package into the port.

`scene_from_numpy(tree, meta, device)` takes the JAX package's `SceneData`
with numpy leaves (for example `jax.tree.map(np.asarray, data)`) and its
`SceneMeta`, and returns the port's `SceneData` on `device` and `SceneMeta`.
It reads fields by name and imports nothing from the JAX package, so both
packages can trace the identical scene, its volume table included.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.accel.cluster import N_SUB
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.scene.types import (
    ClusterData, EmissiveTable, EnvMapData, SceneData, SceneMeta, VolumeTable, tree_to_device,
)


def _pick(cls, src):
    return cls(*(getattr(src, f) for f in cls._fields))


def clusters_from_numpy(cl) -> ClusterData:
    """The port's cluster tables (numpy leaves) from the JAX package's
    `ClusterData`: fields by name, and `sub_aabbs` from the metadata rows of
    its lane-interleaved blocks (`tris_rk[:, K/8 + s, 0:6]` is sub-block s's
    [lo.xyz, hi.xyz]; `tris_rk` carries trailing zero blocks that `tris`
    does not)."""
    tris_rk = np.asarray(cl.tris_rk)
    n_blocks, k = np.asarray(cl.tris).shape[0], np.asarray(cl.tris).shape[2]
    sub = k // N_SUB
    fields = {f: np.asarray(getattr(cl, f)) for f in ClusterData._fields if f != "sub_aabbs"}
    return ClusterData(**fields, sub_aabbs=np.ascontiguousarray(tris_rk[:n_blocks, sub : sub + N_SUB, 0:6]))


def scene_from_numpy(tree, meta, device):
    host = SceneData(
        tri_p0=tree.tri_p0,
        tri_e1=tree.tri_e1,
        tri_e2=tree.tri_e2,
        tri_attr=tree.tri_attr,
        clusters=clusters_from_numpy(tree.clusters),
        material_attr=tree.materials.attr,
        emissive=_pick(EmissiveTable, tree.emissive),
        env=_pick(EnvMapData, tree.env),
        textures=tree.textures,
        texture_dims=tree.texture_dims,
        volumes=_pick(VolumeTable, tree.volumes),
        lookup_reflect=tree.lookup_reflect,
        lookup_refract_out=tree.lookup_refract_out,
        lookup_refract_in=tree.lookup_refract_in,
    )
    port_meta = SceneMeta(**{f: getattr(meta, f) for f in SceneMeta.__dataclass_fields__})
    return tree_to_device(host, resolve_device(device)), port_meta
