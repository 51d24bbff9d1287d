"""Minimal self-contained glTF 2.0 loader (jax-free port of
vpt_tpu/scene/gltf.py).

Reads `.gltf` files with external or `data:` buffers and `.glb` files:
u8/u16/u32 indices, POSITION/NORMAL/TEXCOORD_0 (strided or packed), node
hierarchies (matrix or TRS), perspective cameras, pbrMetallicRoughness
materials with base-color / metallic-roughness / normal / emissive
textures, and the KHR_materials_emissive_strength,
KHR_materials_transmission and KHR_materials_ior extensions.  The defaults
are the JAX loader's (metallicFactor 1.0, the first camera's view is the
inverse of its node's world matrix).

Texture channel conventions follow the renderer: roughness and metallic
are read from a texture's .r channel, so the packed glTF metallicRoughness
texture (G = roughness, B = metallic) is split into two derived textures at
load time, once per texture.  Images are PNG or JPEG files, recognised by
their content whatever their `mimeType` says, as PIL opens them; they are
decoded by `io/image.py` (PNG) and `io/jpeg.py` with the C codec, and
expanded to RGBA as PIL's `convert("RGBA")` expands them.  Other formats,
and the JPEG kinds `io/jpeg.py` lists, raise a ValueError that names the
format and the image.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from vpt_tpu_torch.io.image import decode_rgba
from vpt_tpu_torch.scene.types import Instance, Material, Mesh, Scene, default_textures

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc, base_dir):
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri", "")
        if uri.startswith("data:"):
            payload = uri.split(",", 1)[1]
            out.append(np.frombuffer(base64.b64decode(payload), np.uint8))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(np.frombuffer(f.read(), np.uint8))
    return out


def _read_accessor(doc, buffers, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view.get("buffer", 0)]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    comp = np.dtype(dtype).itemsize
    itemsize = comp * ncomp
    stride = view.get("byteStride", itemsize)
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    if count and offset + (count - 1) * stride + itemsize > buf.shape[0]:
        raise ValueError(f"accessor {idx} reads past the end of its buffer")
    # One strided view over the element records (stride == itemsize: packed).
    return np.ndarray((count, ncomp), dtype, buffer=buf, offset=offset, strides=(stride, comp)).copy()


def _node_matrix(node):
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major in file
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])  # xyzw quaternion
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = r
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = rot @ np.diag(np.asarray(s, np.float32))
    m[:3, 3] = t
    return m


def _load_image(doc, buffers, base_dir, image_index):
    """Image `image_index` (a file, a `data:` URI or a buffer view) as
    (H, W, 4) float32 in [0, 1]."""
    img = doc["images"][image_index]
    if "uri" in img and not img["uri"].startswith("data:"):
        name = os.path.join(base_dir, img["uri"])
        with open(name, "rb") as f:
            return decode_rgba(f.read(), name, from_file=True)
    else:
        if "uri" in img:
            payload = img["uri"].split(",", 1)[1]
            data = base64.b64decode(payload)
        else:
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view.get("buffer", 0)][off : off + view["byteLength"]].tobytes()
        name = img.get("name", f"image {image_index}")
    return decode_rgba(data, name)


def load_gltf(path: str, async_import: bool = True) -> Scene:
    """Load a .gltf (JSON) or .glb file into a host Scene.

    With `async_import`, all referenced images are decoded concurrently on
    a 4-thread pool, as the JAX loader does."""
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        doc, buffers = _load_glb(path)
    else:
        with open(path) as f:
            doc = json.load(f)
        buffers = _load_buffers(doc, base_dir)

    # ---- textures ---------------------------------------------------------
    image_cache: dict = {}
    if async_import and doc.get("images"):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = {
                i: ex.submit(_load_image, doc, buffers, base_dir, i)
                for i in range(len(doc["images"]))
            }
            image_cache = {i: f.result() for i, f in futs.items()}

    def _image(source):
        if source not in image_cache:
            image_cache[source] = _load_image(doc, buffers, base_dir, source)
        return image_cache[source]

    textures = default_textures()  # slots 0 (white), 1 (flat normal), 2 (white)
    tex_cache: dict = {}

    def texture_slot(tex_index):
        """Load glTF texture index -> our texture list slot."""
        key = ("plain", tex_index)
        if key in tex_cache:
            return tex_cache[key]
        source = doc["textures"][tex_index].get("source", 0)
        arr = _image(source)
        textures.append(arr)
        tex_cache[key] = len(textures) - 1
        return tex_cache[key]

    def mr_split_slots(tex_index):
        """metallicRoughness texture -> (roughness_slot, metallic_slot)."""
        key = ("mr", tex_index)
        if key in tex_cache:
            return tex_cache[key]
        source = doc["textures"][tex_index].get("source", 0)
        arr = _image(source)
        rough = arr.copy()
        rough[..., 0] = arr[..., 1]  # G -> .r
        metal = arr.copy()
        metal[..., 0] = arr[..., 2]  # B -> .r
        textures.append(rough)
        r_slot = len(textures) - 1
        textures.append(metal)
        m_slot = len(textures) - 1
        tex_cache[key] = (r_slot, m_slot)
        return tex_cache[key]

    # ---- materials --------------------------------------------------------
    materials = []
    for mat in doc.get("materials", [{}]) or [{}]:
        pbr = mat.get("pbrMetallicRoughness", {})
        ext = mat.get("extensions", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        emissive = np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        emissive = emissive * strength
        transmission = ext.get("KHR_materials_transmission", {}).get("transmissionFactor", 0.0)
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

        m = Material(
            name=mat.get("name", f"material{len(materials)}"),
            base_color=tuple(base[:3]),
            emissive_color=tuple(emissive.tolist()),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            transmission=float(transmission),
            ior=float(ior),
        )
        if "baseColorTexture" in pbr:
            m.base_color_texture = texture_slot(pbr["baseColorTexture"]["index"])
        if "metallicRoughnessTexture" in pbr:
            r_slot, m_slot = mr_split_slots(pbr["metallicRoughnessTexture"]["index"])
            m.roughness_texture = r_slot
            m.metallic_texture = m_slot
        if "normalTexture" in mat:
            m.normal_texture = texture_slot(mat["normalTexture"]["index"])
        if "emissiveTexture" in mat:
            m.emissive_texture = texture_slot(mat["emissiveTexture"]["index"])
        materials.append(m)
    if not materials:
        materials = [Material()]

    # ---- meshes -----------------------------------------------------------
    meshes = []
    mesh_prims: list = []  # glTF mesh index -> [(our mesh idx, material idx)]
    for gmesh in doc.get("meshes", []):
        prims = []
        for prim in gmesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            else:
                nrm = np.zeros_like(pos)
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            else:
                uv = np.zeros((pos.shape[0], 2), np.float32)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.uint32)
            if "NORMAL" not in attrs:
                # Face normals when the export has none
                tri = idx.reshape(-1, 3)
                fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]], pos[tri[:, 2]] - pos[tri[:, 0]])
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
                nrm = np.zeros_like(pos)
                for k in range(3):
                    np.add.at(nrm, tri[:, k], fn)
                nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            meshes.append(Mesh(pos, nrm, uv, idx, name=gmesh.get("name", "mesh")))
            prims.append((len(meshes) - 1, prim.get("material", 0)))
        mesh_prims.append(prims)

    # ---- nodes / instances / camera --------------------------------------
    instances = []
    camera_view = None
    camera_fov = 45.0
    camera_aspect = 16.0 / 9.0

    nodes = doc.get("nodes", [])
    scene_def = doc.get("scenes", [{}])[doc.get("scene", 0)]

    def walk(node_idx, parent):
        nonlocal camera_view, camera_fov, camera_aspect
        node = nodes[node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for mesh_idx, mat_idx in mesh_prims[node["mesh"]]:
                instances.append(
                    Instance(mesh=mesh_idx, material=mat_idx, transform=world,
                             name=node.get("name", f"node{node_idx}"))
                )
        if "camera" in node and camera_view is None:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam["perspective"]
                camera_fov = float(np.degrees(p.get("yfov", np.radians(45.0))))
                camera_aspect = float(p.get("aspectRatio", 16.0 / 9.0))
            camera_view = np.linalg.inv(world).astype(np.float32)
        for child in node.get("children", []):
            walk(child, world)

    for root in scene_def.get("nodes", range(len(nodes))):
        walk(root, np.eye(4, dtype=np.float32))

    return Scene(
        meshes=meshes,
        instances=instances,
        materials=materials,
        textures=textures,
        camera_view=camera_view,
        camera_fov_deg=camera_fov,
        camera_aspect=camera_aspect,
        name=os.path.splitext(os.path.basename(path))[0],
    )


def _load_glb(path: str):
    """Binary glTF container."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"{path} is not a GLB file")
    offset = 12
    doc = None
    buffers = []
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            doc = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            buffers.append(np.frombuffer(chunk, np.uint8))
    return doc, buffers
