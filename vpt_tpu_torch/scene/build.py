"""Scene compilation: host `Scene` -> `SceneData` on a device + `SceneMeta`
(jax-free copy of vpt_tpu/scene/build.py::compile_scene).

Each unique mesh gets one local-space BVH and cluster build; instances add
world cluster boxes and world->local transforms; shading reads packed
per-triangle rows indexed by virtual triangle id.  Everything is built in
numpy exactly as the JAX package builds it and moved to the device once at
the end.  Volumes and the energy-compensation table bake are not ported
yet: the lookups carry the constant fit.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu_torch.accel.cluster import CLUSTER_SIZE, assemble_clusters, build_mesh_clusters
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.render.lookup_fit import constant_fit
from vpt_tpu_torch.scene.envmap import constant_environment, default_sky, prepare_environment
from vpt_tpu_torch.scene.types import (
    MAT_ATTR_COLS, TRI_ATTR_COLS, EmissiveTable, Scene, SceneData, SceneMeta, tree_to_device,
)

BRUTE_FORCE_MAX_TRIS = 1024


def build_material_attr(materials) -> np.ndarray:
    """(M, MAT_ATTR_COLS) packed material rows."""
    attr = np.zeros((len(materials), MAT_ATTR_COLS), np.float32)
    for i, m in enumerate(materials):
        attr[i, 0:3] = m.base_color
        attr[i, 3:6] = m.emissive_color
        attr[i, 6:9] = m.specular_color
        attr[i, 9:12] = m.medium_color
        attr[i, 12:15] = m.medium_emissive_color
        attr[i, 15:23] = [
            m.metallic, m.roughness, m.ior, m.transmission, m.anisotropy,
            m.anisotropy_rotation, m.medium_density, m.medium_anisotropy,
        ]
        attr[i, 23:28] = [
            m.base_color_texture, m.normal_texture, m.roughness_texture,
            m.metallic_texture, m.emissive_texture,
        ]
    return attr


def pack_textures(textures) -> np.ndarray:
    """All textures row-major in one flat RGBA8 pool, one packed texel
    (r | g<<8 | b<<16 | a<<24) per element, padded to a multiple of 128."""
    chunks = []
    for t in textures:
        t = np.asarray(t, np.float32)
        if t.shape[-1] == 3:
            t = np.concatenate([t, np.ones_like(t[..., :1])], axis=-1)
        q = np.clip(np.rint(t * 255.0), 0, 255).astype(np.uint32)
        chunks.append((q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)).reshape(-1))
    pool = np.concatenate(chunks) if chunks else np.zeros(1, np.uint32)
    pad = (-len(pool)) % 128
    if pad:
        pool = np.concatenate([pool, np.zeros(pad, np.uint32)])
    return pool


def texture_dims(textures) -> np.ndarray:
    """(K, 3) i32 (height, width, pool offset) of each packed texture."""
    rows, off = [], 0
    for t in textures:
        rows.append([t.shape[0], t.shape[1], off])
        off += t.shape[0] * t.shape[1]
    return np.array(rows, np.int32)


def compile_scene(scene: Scene, device):
    """Returns (SceneData on `device`, SceneMeta, aux) where aux holds the
    camera's view matrix, field of view and aspect."""
    unique_meshes = sorted({inst.mesh for inst in scene.instances})
    mesh_slot = {mi: j for j, mi in enumerate(unique_meshes)}
    mesh_cache = {}
    for mi in unique_meshes:
        mesh = scene.meshes[mi]
        idx = np.asarray(mesh.indices).reshape(-1, 3)
        pos = np.asarray(mesh.positions, np.float32)
        lv0, lv1, lv2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        bvh_m = build_bvh(lv0, lv1, lv2)
        order_m = bvh_m.tri_order
        t = lv0.shape[0]
        inv_perm_m = np.empty(t, np.int32)
        inv_perm_m[order_m] = np.arange(t, dtype=np.int32)
        nrm = np.asarray(mesh.normals, np.float32)
        uv = np.asarray(mesh.uvs, np.float32)
        mesh_cache[mi] = dict(
            order=order_m, inv_perm=inv_perm_m,
            mc=build_mesh_clusters(
                bvh_m, lv0[order_m], (lv1 - lv0)[order_m], (lv2 - lv0)[order_m],
                cluster_size=CLUSTER_SIZE,
            ),
            lp=(lv0[order_m], lv1[order_m], lv2[order_m]),
            ln=(nrm[idx[:, 0]][order_m], nrm[idx[:, 1]][order_m], nrm[idx[:, 2]][order_m]),
            luv=(uv[idx[:, 0]][order_m], uv[idx[:, 1]][order_m], uv[idx[:, 2]][order_m]),
        )

    # Per-instance virtual triangle arrays (world space): virtual id =
    # instance base + mesh-local reordered slot, the id the tracer reports.
    cols = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat", "local", "inst")}
    virt_base, instance_specs = [], []
    offset = 0
    for ii, inst in enumerate(scene.instances):
        cache = mesh_cache[inst.mesh]
        m = np.asarray(inst.transform, np.float32)
        nrm_m = np.linalg.inv(m[:3, :3]).T

        def w_nrm(nl):
            nw = nl @ nrm_m.T
            return nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)

        for k, p in zip(("v0", "v1", "v2"), cache["lp"]):
            cols[k].append(p @ m[:3, :3].T + m[:3, 3])
        for k, nl in zip(("n0", "n1", "n2"), cache["ln"]):
            cols[k].append(w_nrm(nl))
        for k, uvk in zip(("uv0", "uv1", "uv2"), cache["luv"]):
            cols[k].append(uvk)
        t = cache["lp"][0].shape[0]
        cols["mat"].append(np.full(t, inst.material, np.int32))
        cols["local"].append(cache["order"].astype(np.int32))
        cols["inst"].append(np.full(t, ii, np.int32))
        virt_base.append(offset)
        instance_specs.append((mesh_slot[inst.mesh], inst.transform, offset))
        offset += t
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    v0, v1, v2 = (cat[k].astype(np.float32) for k in ("v0", "v1", "v2"))
    n_tris = v0.shape[0]

    def pad(a, pad_value=0.0):
        return np.concatenate([a, np.full((LEAF_SIZE,) + a.shape[1:], pad_value, a.dtype)])

    tri_p0, tri_e1, tri_e2 = pad(v0), pad(v1 - v0), pad(v2 - v0)
    clusters = assemble_clusters([mesh_cache[mi]["mc"] for mi in unique_meshes], instance_specs)

    # Emissive NEE table over emissive instances.
    em_instances = [
        ii for ii, inst in enumerate(scene.instances)
        if (np.asarray(scene.materials[inst.material].emissive_color, np.float32) > 0.0).any()
    ]
    em_count = len(em_instances)
    em_attr = np.zeros((max(em_count, 1), 4), np.float32)  # [tri_count, offset, instance, material]
    slots, cursor = [], 0
    for e, ii in enumerate(em_instances):
        inst = scene.instances[ii]
        t = scene.meshes[inst.mesh].n_tris
        em_attr[e] = (t, cursor, ii, inst.material)
        slots.append(virt_base[ii] + mesh_cache[inst.mesh]["inv_perm"])
        cursor += t
    slot_table = np.concatenate(slots) if slots else np.zeros(1, np.int32)

    if scene.env_map is not None:
        env = prepare_environment(scene.env_map)
    elif em_count > 0:
        env = constant_environment((0.0, 0.0, 0.0))
    else:
        env = prepare_environment(default_sky())

    em_tcount_by_inst = np.zeros(len(scene.instances), np.float32)
    for e, ii in enumerate(em_instances):
        em_tcount_by_inst[ii] = em_attr[e, 0]
    tp = tri_p0.shape[0]
    tri_attr = np.zeros((tp, TRI_ATTR_COLS), np.float32)
    tri_attr[:, 0:3] = tri_p0
    tri_attr[:, 3:6] = tri_e1
    tri_attr[:, 6:9] = tri_e2
    for c0, k in ((9, "n0"), (12, "n1"), (15, "n2")):
        tri_attr[:, c0 : c0 + 3] = pad(cat[k].astype(np.float32))
    for c0, k in ((18, "uv0"), (20, "uv1"), (22, "uv2")):
        tri_attr[:, c0 : c0 + 2] = pad(cat[k].astype(np.float32))
    tri_attr[:, 24] = pad(cat["mat"], 0).astype(np.float32)
    tri_attr[:, 25] = pad(cat["local"], -1).astype(np.float32)
    inst_padded = pad(cat["inst"], -1)
    tri_attr[:, 26] = inst_padded.astype(np.float32)
    tri_attr[:, 27] = np.where(inst_padded >= 0, em_tcount_by_inst[np.maximum(inst_padded, 0)], 0.0)

    lut = constant_fit(1.0)
    host = SceneData(
        tri_p0=tri_p0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_attr=tri_attr,
        clusters=clusters,
        material_attr=build_material_attr(scene.materials),
        emissive=EmissiveTable(
            attr=em_attr, slot_table=slot_table.astype(np.int32),
            tri_rows=tri_attr[np.clip(slot_table, 0, tp - 1)],
        ),
        env=env,
        textures=pack_textures(scene.textures),
        texture_dims=texture_dims(scene.textures),
        lookup_reflect=lut,
        lookup_refract_out=lut,
        lookup_refract_in=lut,
    )

    world_lo = np.minimum(np.minimum(v0.min(0), v1.min(0)), v2.min(0))
    world_hi = np.maximum(np.maximum(v0.max(0), v1.max(0)), v2.max(0))
    cornell_diag = 3.4641016  # 2-unit cube: all epsilons were tuned at this scale
    meta = SceneMeta(
        n_tris=n_tris,
        n_instances=len(scene.instances),
        n_materials=len(scene.materials),
        n_emissive=em_count,
        n_volumes=0,
        use_brute_force=n_tris <= BRUTE_FORCE_MAX_TRIS,
        has_textures=any(t.shape[0] > 1 or t.shape[1] > 1 for t in scene.textures),
        name=scene.name,
        scene_scale=float(np.linalg.norm(world_hi - world_lo)) / cornell_diag,
        scene_center=tuple(float(x) for x in (world_lo + world_hi) * 0.5),
    )
    aux = {
        "camera_view": scene.camera_view,
        "camera_fov_deg": scene.camera_fov_deg,
        "camera_aspect": scene.camera_aspect,
    }
    return tree_to_device(host, resolve_device(device)), meta, aux
