"""The port's jax-free scene compilation against vpt_tpu.scene.build, leaf by
leaf and exactly (the numpy code is the same), and the JAX -> port scene
conversion."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_trace import use_native_jax_bvh
from vpt_tpu.scene import build as jbuild
from vpt_tpu.scene import procedural as jproc
from vpt_tpu_torch.scene import build as tbuild
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.convert import clusters_from_numpy, scene_from_numpy

torch.set_num_threads(1)

SCENES = {
    "colonnade": {},
    "cornell_box": {},
    "sphere_garden": {"grid": 3},
}


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from _leaves(sub, f"{prefix}{name}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_matches_jax_leaf_by_leaf(name):
    use_native_jax_bvh()  # both sides' BVHs come from the same C++ builder
    jdata, jmeta, jaux = jbuild.compile_scene(getattr(jproc, name)(**SCENES[name]))
    want, want_meta = scene_from_numpy(jax.tree.map(np.asarray, jdata), jmeta, "cpu")
    got, meta, aux = tbuild.compile_scene(getattr(tproc, name)(**SCENES[name]), device="cpu")
    assert meta == want_meta
    np.testing.assert_array_equal(aux["camera_view"], jaux["camera_view"])
    assert (aux["camera_fov_deg"], aux["camera_aspect"]) == (jaux["camera_fov_deg"], jaux["camera_aspect"])
    for (path, a), (path_b, b) in zip(_leaves(got), _leaves(want)):
        assert path == path_b
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), f"{name}: leaf {path} differs"


def test_scene_from_numpy_round_trip():
    jdata, jmeta, _ = jbuild.compile_scene(jproc.cornell_box())
    tree = jax.tree.map(np.asarray, jdata)
    data, meta = scene_from_numpy(tree, jmeta, "cpu")
    assert meta.n_tris == jmeta.n_tris and meta.use_brute_force == jmeta.use_brute_force
    assert dataclasses.asdict(meta) == {f: getattr(jmeta, f) for f in dataclasses.asdict(meta)}
    sources = {
        "material_attr": tree.materials.attr,
        "clusters": clusters_from_numpy(tree.clusters),  # sub_aabbs from tris_rk's metadata rows
        "emissive": tree.emissive,
        "env": tree.env,
        "volumes": tree.volumes,
    }
    for path, leaf in _leaves(data):
        head, _, rest = path.partition(".")
        src = sources.get(head, tree)
        src = getattr(src, rest) if rest else (src if head in sources else getattr(tree, head))
        src = np.asarray(src)
        if src.dtype == np.uint32:
            src = src.astype(np.int64)
        np.testing.assert_array_equal(leaf.numpy(), src, err_msg=path)
