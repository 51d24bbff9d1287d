"""glTF 2.0 files for the loader tests and the chip smoke run, written with
numpy, json and the port's `save_png` alone (no JAX, no PIL).

`GltfWriter` lays out accessors, buffer views, PNG images, textures,
materials, meshes, nodes and a camera, and saves the document as a `.glb`
(images in buffer views), a `.gltf` with an external `.bin` buffer and
external PNG files, or a `.gltf` with `data:` URIs.  `scene_to_gltf`
writes a host `Scene` with one node per instance (instances of one mesh
and material share one glTF mesh), so `load_gltf` gives the same
instances, materials and texture slots back; `feature_scene`
writes a small document that touches every path of the loader.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
import tempfile

import numpy as np

from vpt_tpu_torch.io.image import save_png

FLOAT, UBYTE, USHORT, UINT = 5126, 5121, 5123, 5125
_TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}


def png_bytes(image) -> bytes:
    """A float [0, 1] or uint8 (H, W, 3 | 4) image as PNG bytes."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.png")
        save_png(path, image)
        with open(path, "rb") as f:
            return f.read()


def _append_view(doc: dict, blob: bytearray, data: bytes, stride=None) -> int:
    """Append `data` to `blob` at a 4-byte boundary as a new buffer view."""
    blob += b"\0" * (-len(blob) % 4)
    v = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
    if stride is not None:
        v["byteStride"] = stride
    blob += data
    doc.setdefault("bufferViews", []).append(v)
    return len(doc["bufferViews"]) - 1


class GltfWriter:
    """Builds a glTF document and its one binary buffer."""

    def __init__(self):
        self.doc = {"asset": {"version": "2.0"}, "scenes": [{"nodes": []}], "scene": 0}
        self.bin = bytearray()
        self.images = []  # PNG (or other) bytes per image

    def _list(self, key):
        return self.doc.setdefault(key, [])

    def view(self, data: bytes, stride=None) -> int:
        return _append_view(self.doc, self.bin, data, stride)

    def accessor(self, arr, component=FLOAT) -> int:
        """A packed accessor over its own buffer view."""
        arr = np.asarray(arr)
        arr2 = arr.reshape(arr.shape[0], -1)
        dtype = {FLOAT: np.float32, UBYTE: np.uint8, USHORT: np.uint16, UINT: np.uint32}[component]
        view = self.view(np.ascontiguousarray(arr2, dtype).tobytes())
        return self._add_accessor(view, 0, arr2.shape[0], arr2.shape[1], component)

    def _add_accessor(self, view, offset, count, ncomp, component) -> int:
        acc = {"bufferView": view, "componentType": component, "count": int(count), "type": _TYPES[ncomp]}
        if offset:
            acc["byteOffset"] = offset
        self._list("accessors").append(acc)
        return len(self.doc["accessors"]) - 1

    def interleaved(self, *arrays) -> list:
        """Float32 attributes interleaved in one view with a byteStride, plus
        4 bytes of padding per element; one accessor each."""
        cols = [np.asarray(a, np.float32).reshape(len(a), -1) for a in arrays]
        n = cols[0].shape[0]
        packed = np.concatenate(cols + [np.zeros((n, 1), np.float32)], axis=1)
        view = self.view(packed.tobytes(), stride=packed.shape[1] * 4)
        out, off = [], 0
        for c in cols:
            out.append(self._add_accessor(view, off, n, c.shape[1], FLOAT))
            off += 4 * c.shape[1]
        return out

    def image(self, data: bytes, name=None) -> int:
        self.images.append(data)
        img = {"mimeType": "image/png"}
        if name:
            img["name"] = name
        self._list("images").append(img)
        return len(self.images) - 1

    def texture(self, image: int) -> int:
        self._list("textures").append({"source": image})
        return len(self.doc["textures"]) - 1

    def material(self, **m) -> int:
        self._list("materials").append(m)
        return len(self.doc["materials"]) - 1

    def mesh(self, prims, name="mesh") -> int:
        self._list("meshes").append({"name": name, "primitives": prims})
        return len(self.doc["meshes"]) - 1

    def node(self, root=True, **n) -> int:
        self._list("nodes").append(n)
        idx = len(self.doc["nodes"]) - 1
        if root:
            self.doc["scenes"][0]["nodes"].append(idx)
        return idx

    def camera(self, yfov: float, aspect: float) -> int:
        self._list("cameras").append({"type": "perspective", "perspective": {
            "yfov": yfov, "aspectRatio": aspect, "znear": 0.01, "zfar": 1000.0}})
        return len(self.doc["cameras"]) - 1

    def save(self, path: str, layout: str = "glb") -> str:
        """Write the document: "glb", "external" (a .bin and PNG files
        beside the .gltf) or "data" (data: URIs)."""
        doc, blob = json.loads(json.dumps(self.doc)), bytearray(self.bin)
        if layout == "glb":
            for i, data in enumerate(self.images):
                doc["images"][i]["bufferView"] = _append_view(doc, blob, data)
        base = os.path.splitext(path)[0]
        blob = bytes(blob)
        doc["buffers"] = [{"byteLength": len(blob)}]
        if layout == "external":
            with open(base + ".bin", "wb") as f:
                f.write(blob)
            doc["buffers"][0]["uri"] = os.path.basename(base) + ".bin"
            for i, data in enumerate(self.images):
                name = f"{os.path.basename(base)}_{i}.png"
                with open(os.path.join(os.path.dirname(path), name), "wb") as f:
                    f.write(data)
                doc["images"][i]["uri"] = name
        elif layout == "data":
            doc["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
            for i, data in enumerate(self.images):
                doc["images"][i]["uri"] = "data:image/png;base64," + base64.b64encode(data).decode()
        if layout == "glb":
            js = json.dumps(doc).encode()
            js += b" " * (-len(js) % 4)
            blob += b"\0" * (-len(blob) % 4)
            out = io.BytesIO()
            out.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
            out.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            out.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
            with open(path, "wb") as f:
                f.write(out.getvalue())
        else:
            with open(path, "w") as f:
                json.dump(doc, f)
        return path


def _material_json(m, tex_of) -> dict:
    """A Material as glTF: factors, textures and the three KHR extensions."""
    emissive = np.asarray(m.emissive_color, np.float64)
    strength = float(emissive.max()) if emissive.max() > 1.0 else 1.0
    out = {"name": m.name, "pbrMetallicRoughness": {
        "baseColorFactor": [float(c) for c in m.base_color] + [1.0],
        "metallicFactor": float(m.metallic), "roughnessFactor": float(m.roughness)}}
    ext = {}
    if emissive.any():
        out["emissiveFactor"] = (emissive / strength).tolist()
        if strength != 1.0:
            ext["KHR_materials_emissive_strength"] = {"emissiveStrength": strength}
    if m.transmission:
        ext["KHR_materials_transmission"] = {"transmissionFactor": float(m.transmission)}
    if m.ior != 1.5:
        ext["KHR_materials_ior"] = {"ior": float(m.ior)}
    if ext:
        out["extensions"] = ext
    if m.base_color_texture >= 3:
        out["pbrMetallicRoughness"]["baseColorTexture"] = {"index": tex_of(m.base_color_texture)}
    if m.normal_texture >= 3:
        out["normalTexture"] = {"index": tex_of(m.normal_texture)}
    if m.emissive_texture >= 3:
        out["emissiveTexture"] = {"index": tex_of(m.emissive_texture)}
    return out


def scene_to_gltf(scene, path: str, layout: str = "glb") -> str:
    """Write a host Scene (its env map aside) so that `load_gltf` gives its
    instances, materials and texture slots back: one glTF mesh per mesh and
    material (a glTF primitive carries its material, so a mesh drawn with
    two materials is written twice), one root node per instance (matrix),
    then the camera node."""
    w = GltfWriter()
    texture_of = {}

    def tex_of(slot):
        if slot not in texture_of:
            texture_of[slot] = w.texture(w.image(png_bytes(scene.textures[slot]), name=f"texture {slot}"))
        return texture_of[slot]

    for m in scene.materials:
        w._list("materials").append(_material_json(m, tex_of))
    mesh_ids = {}  # (mesh, material) -> glTF mesh: a primitive carries its material
    for inst in scene.instances:
        key = (inst.mesh, inst.material)
        if key not in mesh_ids:
            mesh = scene.meshes[inst.mesh]
            prim = {"attributes": {"POSITION": w.accessor(mesh.positions), "NORMAL": w.accessor(mesh.normals),
                                   "TEXCOORD_0": w.accessor(mesh.uvs)},
                    "indices": w.accessor(mesh.indices, UINT), "material": inst.material}
            mesh_ids[key] = w.mesh([prim], name=mesh.name)
        w.node(mesh=mesh_ids[key], name=inst.name,
               matrix=np.asarray(inst.transform, np.float32).T.reshape(-1).tolist())
    if scene.camera_view is not None:
        cam = w.camera(float(np.radians(scene.camera_fov_deg)), float(scene.camera_aspect))
        world = np.linalg.inv(np.asarray(scene.camera_view, np.float64)).astype(np.float32)
        w.node(camera=cam, name="camera", matrix=world.T.reshape(-1).tolist())
    return w.save(path, layout)


def feature_scene(path: str, layout: str, extra_png: bytes | None = None) -> str:
    """A small document that touches every path of the loader: u8, u16 and
    u32 indices; an interleaved view with a byteStride; a primitive without
    NORMAL and TEXCOORD_0 (face normals) and one without indices; TRS and
    matrix nodes in a hierarchy; a perspective camera under a parent; a
    metallicRoughness texture (split into roughness and metallic slots,
    shared by two materials), normal and emissive textures; the
    emissive-strength, transmission and ior extensions; and, with
    `extra_png`, those bytes as one more base-color image."""
    rng = np.random.default_rng(11)
    w = GltfWriter()
    tex = rng.random((6, 5, 4)).astype(np.float32)
    mr = w.texture(w.image(png_bytes(tex[..., :3]), name="metal-rough"))
    nrm = w.texture(w.image(png_bytes(tex), name="normal"))
    emi = w.texture(w.image(png_bytes(rng.random((3, 7, 3))), name="emissive"))
    base = w.texture(w.image(extra_png, name="extra")) if extra_png is not None else nrm
    m0 = w.material(name="metal", pbrMetallicRoughness={"metallicRoughnessTexture": {"index": mr},
                                                         "baseColorTexture": {"index": base},
                                                         "roughnessFactor": 0.4},
                    normalTexture={"index": nrm})
    m1 = w.material(name="lamp", emissiveFactor=[1.0, 0.5, 0.25], emissiveTexture={"index": emi},
                    extensions={"KHR_materials_emissive_strength": {"emissiveStrength": 12.0}},
                    pbrMetallicRoughness={"baseColorFactor": [0.2, 0.3, 0.4, 1.0], "metallicFactor": 0.0,
                                          "metallicRoughnessTexture": {"index": mr}})
    m2 = w.material(extensions={"KHR_materials_transmission": {"transmissionFactor": 1.0},
                                "KHR_materials_ior": {"ior": 1.33}},
                    pbrMetallicRoughness={"metallicFactor": 0.0, "roughnessFactor": 0.05})
    # A grid quad: 4x3 vertices, 12 triangles.
    gx, gy = np.meshgrid(np.linspace(-1, 1, 4), np.linspace(0, 1, 3), indexing="ij")
    pos = np.stack([gx, gy, 0.1 * gx * gy], -1).reshape(-1, 3).astype(np.float32)
    nrm_v = np.tile([0.0, 0.0, 1.0], (len(pos), 1)).astype(np.float32)
    uv = np.stack([gx / 2 + 0.5, gy], -1).reshape(-1, 2).astype(np.float32)
    quads = [(i * 3 + j, (i + 1) * 3 + j, i * 3 + j + 1, (i + 1) * 3 + j + 1) for i in range(3) for j in range(2)]
    idx = np.array([[a, b, c, b, d, c] for a, b, c, d in quads]).reshape(-1)
    p_acc, n_acc, t_acc = w.interleaved(pos, nrm_v, uv)  # byteStride 36
    grid_u16 = {"attributes": {"POSITION": p_acc, "NORMAL": n_acc, "TEXCOORD_0": t_acc},
                "indices": w.accessor(idx, USHORT), "material": m0}
    grid_u8 = {"attributes": {"POSITION": w.accessor(pos)}, "indices": w.accessor(idx, UBYTE), "material": m1}
    grid_u32 = {"attributes": {"POSITION": w.accessor(pos), "TEXCOORD_0": w.accessor(uv)},
                "indices": w.accessor(idx, UINT), "material": m2}
    soup = {"attributes": {"POSITION": w.accessor(pos[idx[:9]] + 2.0)}}  # no indices, default material
    ma = w.mesh([grid_u16, grid_u8], name="two-prims")
    mb = w.mesh([grid_u32, soup], name="u32-and-soup")
    child = w.node(root=False, mesh=mb, name="child", translation=[0.5, 0.0, -1.0],
                   rotation=[0.0, 0.38268343, 0.0, 0.9238795], scale=[1.0, 2.0, 0.5])
    cam = w.camera(0.7, 1.5)
    cam_node = w.node(root=False, camera=cam, name="cam", translation=[0.0, 1.0, 5.0])
    w.node(mesh=ma, name="parent", matrix=[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.25, -0.5, 0.0, 1],
           children=[child, cam_node])
    w.node(mesh=ma, name="second", rotation=[0.0, 0.0, 0.70710677, 0.70710677], translation=[3.0, 0.0, 0.0])
    return w.save(path, layout)
