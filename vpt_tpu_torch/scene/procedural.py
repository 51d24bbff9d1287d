"""Procedural scenes (jax-free copy of vpt_tpu/scene/procedural.py):
`cornell_box`, `sphere_garden`, the `colonnade` benchmark scene and its
textured variant, and the furnace test's `furnace_sphere`, with the meshes
and textures they are built from.  The textures are numpy draws with the
JAX package's seeds and come out equal to its arrays."""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.core.camera import look_at
from vpt_tpu_torch.scene.types import Instance, Material, Mesh, Scene, default_textures


def _fix_winding(positions, normals, indices):
    """Flip triangles whose winding disagrees with their vertex normals, so
    cross(v1 - v0, v2 - v0) points along the surface normal."""
    idx = np.asarray(indices).reshape(-1, 3).copy()
    v0 = positions[idx[:, 0]]
    e1 = positions[idx[:, 1]] - v0
    e2 = positions[idx[:, 2]] - v0
    face_n = np.cross(e1, e2)
    avg_n = normals[idx[:, 0]] + normals[idx[:, 1]] + normals[idx[:, 2]]
    flip = (face_n * avg_n).sum(-1) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return idx.reshape(-1).astype(np.uint32)


def make_quad(p0, p1, p2, p3) -> Mesh:
    """Two-triangle quad; vertices CCW seen against the face normal."""
    pos = np.array([p0, p1, p2, p3], np.float32)
    n = np.cross(pos[1] - pos[0], pos[3] - pos[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return Mesh(pos, normals, uvs, indices, name="quad")


def make_box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> Mesh:
    """Axis-aligned box with outward normals."""
    sx, sy, sz = (s / 2.0 for s in size)
    cx, cy, cz = center
    face_defs = [
        ((-sx, -sy, sz), (2 * sx, 0, 0), (0, 2 * sy, 0)),  # +z
        ((sx, -sy, -sz), (-2 * sx, 0, 0), (0, 2 * sy, 0)),  # -z
        ((sx, -sy, sz), (0, 0, -2 * sz), (0, 2 * sy, 0)),  # +x
        ((-sx, -sy, -sz), (0, 0, 2 * sz), (0, 2 * sy, 0)),  # -x
        ((-sx, sy, sz), (2 * sx, 0, 0), (0, 0, -2 * sz)),  # +y
        ((-sx, -sy, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz)),  # -y
    ]
    positions, normals, uvs, indices = [], [], [], []
    for o, u, v in face_defs:
        o = np.array(o, np.float32)
        u = np.array(u, np.float32)
        v = np.array(v, np.float32)
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)
        base = len(positions)
        for corner in [o, o + u, o + u + v, o + v]:
            positions.append(corner + np.array([cx, cy, cz], np.float32))
            normals.append(n)
        uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return Mesh(
        np.array(positions, np.float32), np.array(normals, np.float32),
        np.array(uvs, np.float32), np.array(indices, np.uint32), name="box",
    )


def make_uv_sphere(radius=1.0, center=(0, 0, 0), n_lat=16, n_lon=32) -> Mesh:
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    normals = pts.copy()
    positions = pts * radius + np.asarray(center, np.float32)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                idx += [a, c, b]
            if i < n_lat - 1:
                idx += [b, c, d]
    indices = _fix_winding(positions, normals, np.array(idx, np.uint32))
    return Mesh(positions, normals, uv, indices, name="sphere")


def cornell_box(light_emission=(15.0, 15.0, 15.0), with_boxes=True, box_materials=None) -> Scene:
    """Classic Cornell box in [-1,1]^3 with an area light near the ceiling."""
    white = Material(name="white", base_color=(0.73, 0.73, 0.73))
    red = Material(name="red", base_color=(0.65, 0.05, 0.05))
    green = Material(name="green", base_color=(0.12, 0.45, 0.15))
    light = Material(name="light", base_color=(0.78, 0.78, 0.78), emissive_color=tuple(light_emission))
    materials = [white, red, green, light]
    meshes, instances = [], []

    def add(mesh, mat_idx, name):
        meshes.append(mesh)
        instances.append(Instance(mesh=len(meshes) - 1, material=mat_idx,
                                  transform=np.eye(4, dtype=np.float32), name=name))

    add(make_quad((-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)), 0, "floor")
    add(make_quad((-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)), 0, "ceiling")
    add(make_quad((-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)), 0, "back")
    add(make_quad((-1, -1, 1), (-1, -1, -1), (-1, 1, -1), (-1, 1, 1)), 1, "left-red")
    add(make_quad((1, -1, -1), (1, -1, 1), (1, 1, 1), (1, 1, -1)), 2, "right-green")
    s, y = 0.35, 0.999
    add(make_quad((-s, y, s), (s, y, s), (s, y, -s), (-s, y, -s)), 3, "light")

    if with_boxes:
        bm = box_materials or (0, 0)
        for size, ang_deg, pos, mat, name in (
            ((0.55, 1.1, 0.55), 18.0, [-0.35, -0.45, -0.35], bm[0], "tall-box"),
            ((0.55, 0.55, 0.55), -17.0, [0.35, -0.725, 0.3], bm[1], "short-box"),
        ):
            t = np.eye(4, dtype=np.float32)
            ang = np.radians(ang_deg)
            t[:3, :3] = np.array(
                [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]], np.float32
            )
            t[:3, 3] = pos
            meshes.append(make_box(size))
            instances.append(Instance(mesh=len(meshes) - 1, material=mat, transform=t, name=name))

    view = look_at((0.0, 0.0, 3.9), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    return Scene(
        meshes=meshes, instances=instances, materials=materials, textures=default_textures(),
        camera_view=view, camera_fov_deg=40.0, camera_aspect=1.0, name="cornell",
    )


def sphere_garden(grid=10, sphere_res=(16, 32), seed=5) -> Scene:
    """A grid^2 field of mixed-material sphere instances on a ground plane."""
    rng = np.random.default_rng(seed)
    meshes = [make_quad((-40, 0, 40), (40, 0, 40), (40, 0, -40), (-40, 0, -40))]
    instances = [Instance(mesh=0, material=0, transform=np.eye(4, dtype=np.float32), name="ground")]
    materials = [Material(name="ground", base_color=(0.55, 0.55, 0.55), roughness=0.9)]
    meshes.append(make_uv_sphere(radius=1.0, n_lat=sphere_res[0], n_lon=sphere_res[1]))
    for i in range(grid):
        for j in range(grid):
            kind = (i * grid + j) % 4
            hue = rng.uniform(0.2, 1.0, 3)
            if kind == 0:
                m = Material(name=f"diffuse{i}{j}", base_color=tuple(hue), roughness=1.0)
            elif kind == 1:
                m = Material(name=f"metal{i}{j}", base_color=tuple(hue), metallic=1.0,
                             roughness=float(rng.uniform(0.05, 0.5)))
            elif kind == 2:
                m = Material(name=f"glossy{i}{j}", base_color=tuple(hue),
                             roughness=float(rng.uniform(0.1, 0.6)))
            else:
                m = Material(name=f"glass{i}{j}", base_color=(1, 1, 1), transmission=1.0,
                             ior=1.5, roughness=float(rng.uniform(0.0, 0.2)))
            materials.append(m)
            t = np.eye(4, dtype=np.float32)
            r = float(rng.uniform(0.6, 1.4))
            t[:3, :3] *= r
            t[:3, 3] = [(i - grid / 2 + 0.5) * 3.5, r, (j - grid / 2 + 0.5) * 3.5]
            instances.append(Instance(mesh=1, material=len(materials) - 1, transform=t, name=f"s{i}{j}"))

    h, w = 64, 128
    ys = np.linspace(-1, 1, h)[:, None]
    sky = np.zeros((h, w, 3), np.float32)
    sky[...] = np.stack(
        [0.35 + 0.2 * (1 - ys), 0.5 + 0.25 * (1 - ys), 0.9 + 0.1 * (1 - ys)], axis=-1
    ) * np.ones((h, w, 3), np.float32)
    sky[12:16, 30:34] = 200.0
    view = look_at((14.0, 9.0, 22.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))
    return Scene(
        meshes=meshes, instances=instances, materials=materials, textures=default_textures(),
        camera_view=view, camera_fov_deg=45.0, camera_aspect=1.0, env_map=sky, name="sphere_garden",
    )


def make_fluted_column(radius=0.5, height=4.0, n_seg=64, n_rings=24, flutes=12, flute_depth=0.06) -> Mesh:
    """A fluted column with a square base and capital (~n_seg*n_rings*2 tris)."""
    ang = np.linspace(0.0, 2 * np.pi, n_seg + 1)
    ys = np.linspace(0.0, height, n_rings + 1)
    a, y = np.meshgrid(ang, ys, indexing="ij")
    taper = 1.0 - 0.15 * (y / height) ** 1.5
    r = radius * taper * (1.0 - flute_depth * (0.5 + 0.5 * np.cos(flutes * a)))
    x = r * np.cos(a)
    z = r * np.sin(a)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    nx = np.cos(a) + flute_depth * flutes * np.sin(flutes * a) * -np.sin(a)
    nz = np.sin(a) + flute_depth * flutes * np.sin(flutes * a) * np.cos(a)
    nrm = np.stack([nx, np.zeros_like(nx), nz], axis=-1).reshape(-1, 3)
    nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)).astype(np.float32)
    uv = np.stack([a / (2 * np.pi), y / height], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = n_rings + 1
    for i in range(n_seg):
        for j in range(n_rings):
            p = i * stride + j
            q = (i + 1) * stride + j
            idx += [p, q, p + 1, q, q + 1, p + 1]
    parts = [Mesh(pts, nrm, uv, _fix_winding(pts, nrm, np.array(idx, np.uint32)), name="column-shaft")]
    for cy, s in ((0.0, 1.5), (height, 1.3)):
        parts.append(make_box((radius * s * 2, radius * 0.5, radius * s * 2),
                              (0.0, cy + (0.125 if cy == 0 else -0.125) * radius, 0.0)))
    off, ind = 0, []
    for m in parts:
        ind.append(np.asarray(m.indices, np.uint32) + off)
        off += m.positions.shape[0]
    return Mesh(
        np.concatenate([m.positions for m in parts]), np.concatenate([m.normals for m in parts]),
        np.concatenate([m.uvs for m in parts]), np.concatenate(ind), name="column",
    )


def make_ripple_quad(width, height, nx=64, ny=64, amp=0.1, freq=3.0) -> Mesh:
    """A subdivided quad with a sinusoidal ripple (stand-in for drapes)."""
    xs = np.linspace(-width / 2, width / 2, nx + 1)
    ys = np.linspace(0.0, height, ny + 1)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    z = amp * np.sin(freq * x / width * 2 * np.pi) * np.sin(freq * y / height * np.pi)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    dzdx = amp * freq * 2 * np.pi / width * np.cos(freq * x / width * 2 * np.pi) * np.sin(freq * y / height * np.pi)
    dzdy = amp * freq * np.pi / height * np.sin(freq * x / width * 2 * np.pi) * np.cos(freq * y / height * np.pi)
    nrm = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], axis=-1).reshape(-1, 3)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    uv = np.stack([x / width + 0.5, y / height], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = ny + 1
    for i in range(nx):
        for j in range(ny):
            p = i * stride + j
            q = (i + 1) * stride + j
            idx += [p, q, p + 1, q, q + 1, p + 1]
    return Mesh(pts, nrm, uv, _fix_winding(pts, nrm, np.array(idx, np.uint32)), name="drape")


def _fbm2(shape, octaves=5, seed=0):
    """Cheap value-noise fbm in [0, 1] for procedural texture content."""
    rng = np.random.default_rng(seed)
    h, w = shape
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        g = rng.random((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0, x0 = ys.astype(int), xs.astype(int)
        y1, x1 = np.minimum(y0 + 1, gh - 1), np.minimum(x0 + 1, gw - 1)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        v = (g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx) + g[np.ix_(y0, x1)] * (1 - fy) * fx
             + g[np.ix_(y1, x0)] * fy * (1 - fx) + g[np.ix_(y1, x1)] * fy * fx)
        out += amp * v
        total += amp
        amp *= 0.55
    return out / total


def _normal_from_height(hmap, strength=2.0):
    """Tangent-space normal map ((0.5, 0.5, 1) neutral) from a height field."""
    gy, gx = np.gradient(hmap.astype(np.float32))
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(hmap)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)


def _colonnade_textures(textures) -> dict:
    """Append the stone and floor 1K and the drape 512 albedo + normal maps
    to `textures`; the Material texture slots of each surface."""

    def add_tex(img):
        textures.append(np.asarray(img, np.float32))
        return len(textures) - 1

    hm = _fbm2((1024, 1024), seed=3)  # stone: mottled albedo, chiseled normal
    stone_alb = np.stack([0.5 + 0.25 * hm, 0.47 + 0.24 * hm, 0.43 + 0.22 * hm], -1)
    stone_n = _normal_from_height(hm, 3.0)
    yy, xx = np.mgrid[0:1024, 0:1024]  # floor: marble checker with veins
    check = (((yy // 128) + (xx // 128)) % 2).astype(np.float32)
    veins = _fbm2((1024, 1024), seed=9)
    floor_alb = np.stack([0.25 + 0.5 * check + 0.12 * veins, 0.24 + 0.48 * check + 0.12 * veins,
                          0.23 + 0.46 * check + 0.10 * veins], -1)
    floor_n = _normal_from_height(veins, 1.2)
    wy, wx = np.mgrid[0:512, 0:512]  # drape: woven stripes
    weave = 0.75 + 0.25 * np.sin(wx / 3.0) * np.sin(wy / 3.0)
    drape_alb = np.stack([weave, weave, weave], -1).astype(np.float32)
    drape_n = _normal_from_height(weave.astype(np.float32), 1.5)
    return {
        "stone": dict(base_color_texture=add_tex(np.clip(stone_alb, 0, 1)), normal_texture=add_tex(stone_n)),
        "floor": dict(base_color_texture=add_tex(np.clip(floor_alb, 0, 1)), normal_texture=add_tex(floor_n)),
        "drape": dict(base_color_texture=add_tex(drape_alb), normal_texture=add_tex(drape_n)),
    }


def colonnade(n_columns=8, column_res=(96, 40), textured=False) -> Scene:
    """The benchmark scene (~334K triangles at defaults): a colonnaded
    courtyard of instanced fluted columns, rippled drapes, brass and glass
    statues, emissive lamps and a sun-hotspot sky.  With `textured`, the
    stone, floor and drape materials get procedural albedo + normal maps
    (~4.7M texels), so the per-hit texture gathers run at a realistic size."""
    meshes, instances, materials = [], [], []

    def add_mesh(mesh):
        meshes.append(mesh)
        return len(meshes) - 1

    def add_mat(m):
        materials.append(m)
        return len(materials) - 1

    def inst(mesh_id, mat_id, translate=(0, 0, 0), scale=1.0, yaw=0.0, name=""):
        t = np.eye(4, dtype=np.float32)
        cy, sy = np.cos(yaw), np.sin(yaw)
        t[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32) * scale
        t[:3, 3] = translate
        instances.append(Instance(mesh=mesh_id, material=mat_id, transform=t, name=name))

    textures = default_textures()
    tex_kw = _colonnade_textures(textures) if textured else {"stone": {}, "floor": {}, "drape": {}}
    stone = add_mat(Material(name="stone", base_color=(0.55, 0.52, 0.48), roughness=0.85, **tex_kw["stone"]))
    floor_m = add_mat(Material(name="floor", base_color=(0.4, 0.38, 0.36), roughness=0.6, **tex_kw["floor"]))
    red_drape = add_mat(Material(name="drape-red", base_color=(0.45, 0.06, 0.06), roughness=0.95,
                                 **tex_kw["drape"]))
    green_drape = add_mat(Material(name="drape-green", base_color=(0.07, 0.3, 0.1), roughness=0.95,
                                   **tex_kw["drape"]))
    brass = add_mat(Material(name="brass", base_color=(0.85, 0.62, 0.3), metallic=1.0, roughness=0.25))
    glass = add_mat(Material(name="glass", base_color=(1, 1, 1), transmission=1.0, ior=1.5, roughness=0.03))
    lamp = add_mat(Material(name="lamp", base_color=(1, 1, 1), emissive_color=(40.0, 32.0, 22.0)))

    L, W, H = 34.0, 14.0, 10.0  # courtyard extent
    floor = add_mesh(make_ripple_quad(L, W, nx=48, ny=24, amp=0.0))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    t[:3, 3] = [0.0, 0.0, W / 2]
    instances.append(Instance(mesh=floor, material=floor_m, transform=t, name="floor"))

    wall = add_mesh(make_ripple_quad(L, H, nx=48, ny=16, amp=0.0))
    inst(wall, stone, (0.0, 0.0, -W / 2), name="wall-back")
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
    t[:3, 3] = [0.0, 0.0, W / 2]
    instances.append(Instance(mesh=wall, material=stone, transform=t, name="wall-front"))
    end_wall = add_mesh(make_ripple_quad(W, H, nx=24, ny=16, amp=0.0))
    inst(end_wall, stone, (-L / 2, 0.0, 0.0), yaw=-np.pi / 2, name="wall-west")
    inst(end_wall, stone, (L / 2, 0.0, 0.0), yaw=np.pi / 2, name="wall-east")

    column = add_mesh(make_fluted_column(n_seg=column_res[0], n_rings=column_res[1]))
    xs = np.linspace(-L / 2 + 3.0, L / 2 - 3.0, n_columns)
    for i, x in enumerate(xs):
        for z in (-W / 2 + 2.2, W / 2 - 2.2):
            inst(column, stone, (float(x), 0.0, float(z)),
                 scale=1.0 + 0.05 * ((i * 7) % 3), name=f"col{i}{'n' if z < 0 else 's'}")

    drape = add_mesh(make_ripple_quad(2.6, 5.0, nx=64, ny=88, amp=0.25, freq=4.0))
    for i in range(n_columns - 1):
        x = float(0.5 * (xs[i] + xs[i + 1]))
        mat = red_drape if i % 2 == 0 else green_drape
        inst(drape, mat, (x, 2.5, -W / 2 + 2.0), name=f"drape-n{i}")
        inst(drape, mat, (x, 2.5, W / 2 - 2.0), yaw=np.pi, name=f"drape-s{i}")

    statue = add_mesh(make_uv_sphere(radius=0.8, n_lat=48, n_lon=96))
    pedestal = add_mesh(make_box((1.2, 1.0, 1.2)))
    rng = np.random.default_rng(7)
    for i in range(5):
        x = float(-L / 2 + 5.0 + i * 6.0)
        inst(pedestal, stone, (x, 0.5, 0.0), name=f"ped{i}")
        inst(statue, brass if i % 2 == 0 else glass, (x, 1.9, 0.0),
             scale=float(rng.uniform(0.9, 1.2)), name=f"statue{i}")

    lamp_mesh = add_mesh(make_uv_sphere(radius=0.18, n_lat=8, n_lon=16))
    for i in range(4):
        inst(lamp_mesh, lamp, (float(-L / 2 + 6.0 + i * 7.0), 6.5, 0.0), name=f"lamp{i}")

    h, w = 64, 128
    ys = np.linspace(-1, 1, h)[:, None]
    sky = np.stack(
        [0.3 + 0.25 * (1 - ys), 0.45 + 0.3 * (1 - ys), 0.85 + 0.15 * (1 - ys)], axis=-1
    ) * np.ones((h, w, 3), np.float32)
    sky[10:14, 88:92] = 400.0
    view = look_at((-L / 2 + 2.0, 3.2, 2.8), (L / 2, 2.2, -1.5), (0.0, 1.0, 0.0))
    return Scene(
        meshes=meshes, instances=instances, materials=materials, textures=textures,
        camera_view=view, camera_fov_deg=55.0, camera_aspect=1.0, env_map=sky.astype(np.float32),
        name="colonnade_textured" if textured else "colonnade",
    )


def colonnade_textured(n_columns=8, column_res=(96, 40)) -> Scene:
    """The textured variant of the benchmark scene: 1K stone and floor
    albedo + normal maps, a 512 drape weave (9 textures with the defaults)."""
    return colonnade(n_columns, column_res, textured=True)


def furnace_sphere(albedo=1.0, sky=1.0) -> Scene:
    """A single sphere under a uniform environment: the furnace test scene."""
    sphere = make_uv_sphere(radius=1.0, n_lat=16, n_lon=32)
    mat = Material(name="furnace", base_color=(albedo,) * 3, roughness=1.0)
    view = look_at((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    return Scene(
        meshes=[sphere], instances=[Instance(mesh=0, material=0, transform=np.eye(4, dtype=np.float32))],
        materials=[mat], textures=default_textures(), camera_view=view, camera_fov_deg=45.0,
        camera_aspect=1.0, env_map=np.full((16, 32, 3), sky, np.float32), name="furnace",
    )
