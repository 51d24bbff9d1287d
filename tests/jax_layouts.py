"""The JAX package at a cluster layout, for tests/test_torch_layouts.py: an
instanced random scene's cluster tables, its closest hits and shadow
queries on seeded rays, the reduced colonnade's compiled cluster tables
and, with --render, one dispatch of it.  The group size binds at import in
four JAX modules (VPT_GROUP_SIZE), so the test runs this file in a process
of its own per group size:

    VPT_GROUP_SIZE=4 JAX_PLATFORMS=cpu python tests/jax_layouts.py OUT.npz [--render]

The test imports the same functions (scene, rays, render) for the layouts
that can be set in one process (the cluster size, the sort key, the packet
size)."""

import sys

import numpy as np

N_TRIS = 3000
N_RAYS = 1500
SIZE = 16  # the render's width and height (tests/test_torch_render.py's)
SEED = 2654435761  # its frame seed
DEPTH = 3


def triangles():
    """(v0, v1, v2) of the instanced scene's mesh, seeded."""
    rng = np.random.default_rng(25)
    v0 = rng.uniform(-3, 3, (N_TRIS, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (N_TRIS, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (N_TRIS, 3)).astype(np.float32)
    return v0, v1, v2


def second_instance():
    """The second instance's transform (the first is the identity)."""
    m = np.diag([0.7, 1.4, 0.9, 1.0]).astype(np.float32)
    m[:3, 3] = [6.0, -1.0, 2.0]
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(0.6)
    rot[0, 2] = np.sin(0.6)
    rot[2, 0] = -np.sin(0.6)
    return m @ rot


def clusters(build_bvh, build_mesh_clusters, assemble_clusters, leaf_size, **kw):
    """The scene's cluster tables through one package's builders (`kw` is
    passed to build_mesh_clusters): two instances of one mesh."""
    v0, v1, v2 = triangles()
    bvh = build_bvh(v0, v1, v2)
    order = bvh.tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((leaf_size,) + a.shape[1:], a.dtype)])

    mc = build_mesh_clusters(bvh, pad(v0[order]), pad((v1 - v0)[order]), pad((v2 - v0)[order]), **kw)
    return assemble_clusters([mc, mc], [(0, np.eye(4, dtype=np.float32), 0),
                                        (1, second_instance(), int(mc.start.max()) + 10000)])


def jax_clusters(**kw):
    """The JAX package's tables of the scene at its module layout."""
    from test_torch_trace import use_native_jax_bvh
    from vpt_tpu.accel.bvh import LEAF_SIZE, build_bvh
    from vpt_tpu.accel.cluster import assemble_clusters, build_mesh_clusters

    use_native_jax_bvh()
    return clusters(build_bvh, build_mesh_clusters, assemble_clusters, LEAF_SIZE, **kw)


def rays():
    """Seeded rays, two thirds aimed at triangle centroids of either
    instance, an active mask, and the shadow queries' tmax and exclude ids
    (a third exclude a triangle near the ray's aim)."""
    rng = np.random.default_rng(7)
    v0, v1, v2 = triangles()
    org = rng.uniform(-9, 9, (N_RAYS, 3)).astype(np.float32)
    pick = rng.integers(0, N_TRIS, N_RAYS)
    target = ((v0 + v1 + v2) / 3)[pick]
    second = rng.uniform(size=N_RAYS) < 0.5
    m = second_instance()
    target = np.where(second[:, None], target @ m[:3, :3].T + m[:3, 3], target).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d = np.where((np.arange(N_RAYS) % 3 != 0)[:, None], target - org, d)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    active = rng.uniform(size=N_RAYS) < 0.9
    tmax = rng.uniform(0.5, 25.0, N_RAYS).astype(np.float32)
    extri = np.where(np.arange(N_RAYS) % 3 == 0, rng.integers(0, N_TRIS, N_RAYS), -1).astype(np.int32)
    return org, d, active, tmax, extri


def reduced_colonnade(procedural):
    """tests/test_torch_render.py's reduced colonnade (77,148 triangles)."""
    return procedural.colonnade(n_columns=2, column_res=(24, 8))


def jax_render(data, meta, aux):
    """One dispatch of a compiled scene through the JAX package: (image,
    segments), as tests/test_torch_render.py renders it."""
    import jax.numpy as jnp

    from vpt_tpu.api import _render_step
    from vpt_tpu.core.camera import perspective
    from vpt_tpu.render.params import RenderFlags, default_params

    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    img, segs = _render_step(data, meta, RenderFlags(max_depth=DEPTH, max_medium_events=8),
                             default_params(view_inv, proj_inv), jnp.uint32(SEED), (SIZE, SIZE),
                             jnp.zeros((SIZE, SIZE, 3), jnp.float32), jnp.int32(0), 1)
    return np.asarray(img), float(segs)


def jax_hits(cl):
    """The JAX package's closest hits (its CPU trace, intersect_clusters)
    and shadow queries (integrator.occlude) of rays() against `cl`."""
    import types

    import jax.numpy as jnp

    from vpt_tpu.accel.cluster import intersect_clusters
    from vpt_tpu.render import integrator

    org, d, active, tmax, extri = rays()
    hit = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, active=jnp.asarray(active), use_pallas=False)
    blocked = integrator.occlude(types.SimpleNamespace(clusters=cl), types.SimpleNamespace(use_brute_force=False),
                                 jnp.asarray(org), jnp.asarray(d), jnp.asarray(active), t_min=1e-4,
                                 t_max=jnp.asarray(tmax), exclude_tri=jnp.asarray(extri))
    return {"t": np.asarray(hit.t), "tri": np.asarray(hit.tri), "u": np.asarray(hit.u), "v": np.asarray(hit.v),
            "blocked": np.asarray(blocked)}


def main(out: str, render: bool) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")  # as tests/conftest.py: the CPU, whatever a site config pins

    from vpt_tpu.accel import visit_kernel
    from vpt_tpu.scene import procedural
    from vpt_tpu.scene.build import compile_scene

    arrays = {"group_size": np.int32(visit_kernel.GROUP_SIZE)}
    cl = jax_clusters()
    arrays.update({f"inst/{f}": np.asarray(getattr(cl, f)) for f in cl._fields})
    arrays.update({f"hit/{k}": v for k, v in jax_hits(cl).items()})
    data, meta, aux = compile_scene(reduced_colonnade(procedural))
    tree = jax.tree.map(np.asarray, data)
    arrays.update({f"col/{f}": getattr(tree.clusters, f) for f in tree.clusters._fields})
    if render:
        arrays["img"], arrays["segs"] = jax_render(data, meta, aux)
    np.savez(out, **arrays)


if __name__ == "__main__":
    main(sys.argv[1], "--render" in sys.argv[2:])
