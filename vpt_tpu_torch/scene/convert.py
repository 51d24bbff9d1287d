"""Carry a scene compiled by the JAX package into the port.

`scene_from_numpy(tree, meta, device)` takes the JAX package's `SceneData`
with numpy leaves (for example `jax.tree.map(np.asarray, data)`) and its
`SceneMeta`, and returns the port's `SceneData` on `device` and `SceneMeta`.
It reads fields by name and imports nothing from the JAX package, so both
packages can trace the identical scene.  Scenes with volumes convert, but
the port's integrator refuses to render them until volumes are ported.
"""

from __future__ import annotations

from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.scene.types import (
    ClusterData, EmissiveTable, EnvMapData, SceneData, SceneMeta, tree_to_device,
)


def _pick(cls, src):
    return cls(*(getattr(src, f) for f in cls._fields))


def scene_from_numpy(tree, meta, device):
    host = SceneData(
        tri_p0=tree.tri_p0,
        tri_e1=tree.tri_e1,
        tri_e2=tree.tri_e2,
        tri_attr=tree.tri_attr,
        clusters=_pick(ClusterData, tree.clusters),
        material_attr=tree.materials.attr,
        emissive=_pick(EmissiveTable, tree.emissive),
        env=_pick(EnvMapData, tree.env),
        textures=tree.textures,
        texture_dims=tree.texture_dims,
        lookup_reflect=tree.lookup_reflect,
        lookup_refract_out=tree.lookup_refract_out,
        lookup_refract_in=tree.lookup_refract_in,
    )
    port_meta = SceneMeta(**{f: getattr(meta, f) for f in SceneMeta.__dataclass_fields__})
    return tree_to_device(host, resolve_device(device)), port_meta
