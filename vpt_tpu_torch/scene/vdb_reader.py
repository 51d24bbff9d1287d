"""Pure-Python OpenVDB (.vdb) reader → dense (D, H, W) float32 bricks
(jax-free port of vpt_tpu/scene/vdb_reader.py).

The renderer this package follows ingests OpenVDB through the native
openvdb/NanoVDB libraries; this module parses the file format directly.

Supported subset (the common "cloud/smoke float grid" case):
* file format versions 220-224 (OpenVDB 3.x-10.x writers),
* float grids with the standard 5-4-3 tree (``Tree_float_5_4_3``), both
  full-precision and 16-bit: native half grids (``Tree_half_5_4_3``) and
  float grids written with ``saveFloatAsHalf`` (grid-type suffix
  ``_HalfFloat`` in the descriptor — GridDescriptor::writeHeader),
* uncompressed, ZIP(zlib) or BLOSC(LZ4) value buffers,
* non-instanced grids with grid offsets (every normal .vdb file).

Layout notes (matched to openvdb/io — cited so divergences are findable):
* grid descriptors carry an instance-parent name string between the grid
  type and the three stream offsets (GridDescriptor.cpp writeHeader/read;
  present in every supported version — GRID_INSTANCING is file version
  216),
* ScaleMap/UniformScaleMap bodies are 5 Vec3d (scale, voxelSize,
  scaleInverse, invScaleSqr, invTwiceScale — math/Maps.h ScaleMap::read);
  ScaleTranslateMap adds the translation for 6 Vec3d,
* leaf BUFFER sections re-store the value mask before the compressed
  values (LeafNode::writeBuffers saves mValueMask again), and versions
  < 222 insert the leaf origin Coord + an int8 buffer count after it.

The output is a dense voxel array over the grid's active bounding box plus
``(origin_ijk, voxel_size)`` so callers can place it in world space.  A
matching minimal writer (`write_vdb`) exists for round-trip tests, and
`tests/test_vdb.py` additionally parses hand-assembled byte fixtures that
never touch the writer, so reader/writer bug mirroring cannot hide layout
errors; tests/test_torch_vdb.py runs them against this module."""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = 0x56444220  # " BDV" little-endian, per openvdb/io/Archive
# Compression bit flags (openvdb::io::COMPRESS_*)
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
COMPRESS_ACTIVE_MASK = 2
COMPRESS_BLOSC = 4

# Node-value compression metadata codes (openvdb::io::readCompressedValues)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# 5-4-3 tree dimensions
L2_LOG2, L1_LOG2, L0_LOG2 = 5, 4, 3  # internal32, internal16, leaf8
L2_DIM, L1_DIM, L0_DIM = 1 << L2_LOG2, 1 << L1_LOG2, 1 << L0_LOG2
L2_N, L1_N, L0_N = L2_DIM ** 3, L1_DIM ** 3, L0_DIM ** 3
# Total voxel span of one level-2 node: 32 * 16 * 8 = 4096
L2_SPAN = L2_DIM * L1_DIM * L0_DIM
L1_SPAN = L1_DIM * L0_DIM


class VdbError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def bytes(self, n):
        b = self.d[self.p : self.p + n]
        if len(b) != n:
            raise VdbError("unexpected end of file")
        self.p += n
        return b

    def u32(self):
        return struct.unpack("<I", self.bytes(4))[0]

    def i32(self):
        return struct.unpack("<i", self.bytes(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.bytes(8))[0]

    def i64(self):
        return struct.unpack("<q", self.bytes(8))[0]

    def f32(self):
        return struct.unpack("<f", self.bytes(4))[0]

    def f64(self):
        return struct.unpack("<d", self.bytes(8))[0]

    def byte(self):
        return self.bytes(1)[0]

    def string(self):
        return self.bytes(self.u32()).decode("utf-8", errors="replace")

    def coord(self):
        return struct.unpack("<3i", self.bytes(12))


def _read_metadata(r: _Reader) -> dict:
    """Name → (typename, raw value bytes); values parsed for common types."""
    meta = {}
    count = r.u32()
    for _ in range(count):
        name = r.string()
        typ = r.string()
        raw = r.bytes(r.u32())
        val: object = raw
        try:
            if typ == "string":
                # StringMetadata::readValue stores the chars verbatim (the
                # outer u32 is the byte count; there is no inner prefix)
                val = raw.decode("utf-8", errors="replace")
            elif typ in ("int32",):
                (val,) = struct.unpack("<i", raw)
            elif typ in ("int64",):
                (val,) = struct.unpack("<q", raw)
            elif typ == "float":
                (val,) = struct.unpack("<f", raw)
            elif typ == "double":
                (val,) = struct.unpack("<d", raw)
            elif typ == "bool":
                val = raw[0] != 0
            elif typ == "vec3i":
                val = struct.unpack("<3i", raw)
            elif typ == "vec3d":
                val = struct.unpack("<3d", raw)
        except struct.error:
            pass
        meta[name] = (typ, val)
    return meta


def _read_transform(r: _Reader):
    """Returns (map_type, voxel_size (3,), translate (3,)).

    Body sizes follow math/Maps.h exactly: ScaleMap stores 5 Vec3d
    (mScaleValues, mVoxelSize, mScaleValuesInverse, mInvScaleSqr,
    mInvTwiceScale); ScaleTranslateMap prepends mTranslation for 6."""
    map_type = r.string()
    if map_type in ("UniformScaleMap", "ScaleMap"):
        sx, sy, sz = r.f64(), r.f64(), r.f64()
        # mVoxelSize, mScaleValuesInverse, mInvScaleSqr, mInvTwiceScale
        r.bytes(8 * 12)
        return map_type, np.array([sx, sy, sz]), np.zeros(3)
    if map_type in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        tx, ty, tz = r.f64(), r.f64(), r.f64()
        sx, sy, sz = r.f64(), r.f64(), r.f64()
        r.bytes(8 * 12)
        return map_type, np.array([sx, sy, sz]), np.array([tx, ty, tz])
    if map_type == "TranslationMap":
        tx, ty, tz = r.f64(), r.f64(), r.f64()
        return map_type, np.ones(3), np.array([tx, ty, tz])
    if map_type == "AffineMap":
        m = np.array([r.f64() for _ in range(16)]).reshape(4, 4)
        return map_type, np.diag(m[:3, :3]).copy(), m[3, :3].copy()
    raise VdbError(f"unsupported transform map type: {map_type}")


def _read_mask(r: _Reader, n_bits: int) -> np.ndarray:
    words = n_bits // 64
    raw = np.frombuffer(r.bytes(words * 8), np.uint64)
    bits = np.unpackbits(raw.view(np.uint8), bitorder="little")
    return bits.astype(bool)


def _read_values(r: _Reader, n_stored: int, compression: int,
                 dtype=np.float32) -> np.ndarray:
    """A compressed/raw array of `n_stored` values of `dtype` (float32, or
    float16 for half grids / saveFloatAsHalf buffers), returned as f32."""
    dtype = np.dtype(dtype)
    if n_stored == 0:
        # readZipData/readBloscData consume their Int64-length envelope even
        # for empty arrays (every childless internal node in a real file).
        if compression & (COMPRESS_BLOSC | COMPRESS_ZIP):
            n = r.i64()
            r.bytes(n if n > 0 else -n)
        return np.zeros(0, np.float32)
    if compression & COMPRESS_BLOSC:
        # OpenVDB's default write path: an Int64-length envelope around one
        # blosc1 chunk (LZ4 codec, byte shuffle) — see vpt_tpu_torch.scene.blosc.
        from vpt_tpu_torch.scene import blosc

        n = r.i64()
        if n <= 0:
            # Stored uncompressed (blosc didn't shrink): -n bytes raw
            return np.frombuffer(r.bytes(-n), dtype).astype(np.float32)
        try:
            raw = blosc.decompress(r.bytes(n))
        except blosc.BloscError as e:
            raise VdbError(f"blosc-compressed .vdb: {e}") from e
        return np.frombuffer(raw, dtype).astype(np.float32)
    if compression & COMPRESS_ZIP:
        n = r.i64()
        if n <= 0:
            # Writer stored the data uncompressed (didn't shrink): -n bytes raw
            return np.frombuffer(r.bytes(-n), dtype).astype(np.float32)
        try:
            raw = zlib.decompress(r.bytes(n))
        except zlib.error as e:
            raise VdbError(f"zip-compressed value buffer: {e}") from e
        return np.frombuffer(raw, dtype).astype(np.float32)
    return np.frombuffer(
        r.bytes(dtype.itemsize * n_stored), dtype
    ).astype(np.float32)


def _read_compressed_values(r: _Reader, n_total: int, value_mask: np.ndarray,
                            compression: int, file_version: int,
                            background: float = 0.0,
                            dtype=np.float32) -> np.ndarray:
    """openvdb::io::readCompressedValues: node value arrays with the optional
    selection mask + inactive-value metadata (file version >= 222).

    Semantics follow openvdb/io/Compression.h exactly:
    * values are stored actives-only ("mask-compressed") when the ARCHIVE
      compression has COMPRESS_ACTIVE_MASK set and the metadata code is
      anything but NO_MASK_AND_ALL_VALS — including codes 0-2, which carry
      no selection mask (the common all-inactive-equal-background case),
    * the selection mask (codes 3-5 only) marks inactive voxels holding
      inactiveVal1 (background unless code 5 stores a second value); other
      inactive voxels hold inactiveVal0 (-background unless code 0 makes it
      background, or codes 2/4/5 store it)."""
    dtype = np.dtype(dtype)

    def _value():
        return float(np.frombuffer(r.bytes(dtype.itemsize), dtype)[0])

    out = np.zeros(n_total, np.float32)
    meta_code = NO_MASK_AND_ALL_VALS
    if file_version >= 222:
        meta_code = struct.unpack("<b", r.bytes(1))[0]
    # inactiveVal0 = selection-mask-off voxels, inactiveVal1 = on voxels.
    inactive_off = (background if meta_code == NO_MASK_OR_INACTIVE_VALS
                    else -background)
    inactive_on = background
    if meta_code in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                     MASK_AND_TWO_INACTIVE_VALS):
        inactive_off = _value()
    if meta_code == MASK_AND_TWO_INACTIVE_VALS:
        inactive_on = _value()

    selection = np.zeros(n_total, bool)
    if meta_code in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                     MASK_AND_TWO_INACTIVE_VALS):
        selection = _read_mask(r, n_total)

    mask_storage = (
        bool(compression & COMPRESS_ACTIVE_MASK)
        and meta_code != NO_MASK_AND_ALL_VALS
        and file_version >= 222
    )
    n_stored = int(value_mask.sum()) if mask_storage else n_total
    vals = _read_values(r, n_stored, compression, dtype)
    if mask_storage:
        out[value_mask] = vals
        out[~value_mask & selection] = inactive_on
        out[~value_mask & ~selection] = inactive_off
    else:
        out[:] = vals[:n_total]
    return out


@dataclass
class VdbGrid:
    name: str
    values: np.ndarray  # (D, H, W) dense over the active bounding box (z, y, x)
    origin_ijk: np.ndarray  # (3,) index-space origin (x, y, z) of values[0,0,0]
    voxel_size: np.ndarray  # (3,)
    translate: np.ndarray  # (3,) world offset
    background: float


def _read_tree(r: _Reader, compression: int, file_version: int,
               dtype=np.float32):
    """FloatTree 5-4-3: returns ({leaf origin (x,y,z): (512,) values},
    [(origin, span, value)] active tiles, background).

    Active value tiles — constant-value regions without leaves, common in
    fog/cloud exports — are collected at every level: root tiles span a
    whole level-2 node (4096 voxels/side), level-2 tiles span one level-1
    child (128/side), level-1 tiles span one leaf (8/side).  The caller
    splats them into the dense array, so those regions do not load at
    background density."""
    dtype = np.dtype(dtype)
    r.u32()  # buffer count (always 1, TreeBase::writeTopology)
    background = float(np.frombuffer(r.bytes(dtype.itemsize), dtype)[0])
    n_tiles = r.u32()
    n_children = r.u32()
    # Corrupt headers can claim absurd counts; each root tile is >= 17
    # bytes and each child >= the two L2 masks, so bound by what the file
    # can physically hold instead of looping for minutes (truncation fuzz).
    remaining = len(r.d) - r.p
    if n_tiles * (12 + dtype.itemsize + 1) > remaining:
        raise VdbError(f"root tile count {n_tiles} exceeds file size")
    if n_children * (2 * L2_N // 8) > remaining:
        raise VdbError(f"root child count {n_children} exceeds file size")
    tiles = []  # (origin_xyz, span, value) — active tiles at any level
    for _ in range(n_tiles):
        xyz = r.coord()
        val = float(np.frombuffer(r.bytes(dtype.itemsize), dtype)[0])
        active = r.byte() != 0
        if active:
            tiles.append((xyz, L2_SPAN, val))
    leaves = {}
    leaf_descs = []  # leaf origin (x,y,z) in topology order

    for _ in range(n_children):
        origin2 = r.coord()
        # ---- level-2 internal node (32^3) topology
        child2 = _read_mask(r, L2_N)
        value2 = _read_mask(r, L2_N)
        vals2 = _read_compressed_values(r, L2_N, value2, compression,
                                        file_version, background, dtype)
        for i2 in np.nonzero(value2 & ~child2)[0]:
            o2 = _offset_to_coord(int(i2), L2_LOG2, L1_LOG2 + L0_LOG2)
            tiles.append((
                (origin2[0] + o2[0], origin2[1] + o2[1], origin2[2] + o2[2]),
                L1_SPAN, float(vals2[i2]),
            ))
        for i2 in np.nonzero(child2)[0]:
            o2 = _offset_to_coord(int(i2), L2_LOG2, L1_LOG2 + L0_LOG2)
            base2 = (origin2[0] + o2[0], origin2[1] + o2[1], origin2[2] + o2[2])
            # ---- level-1 internal node (16^3)
            child1 = _read_mask(r, L1_N)
            value1 = _read_mask(r, L1_N)
            vals1 = _read_compressed_values(r, L1_N, value1, compression,
                                            file_version, background, dtype)
            for i1 in np.nonzero(value1 & ~child1)[0]:
                o1 = _offset_to_coord(int(i1), L1_LOG2, L0_LOG2)
                tiles.append((
                    (base2[0] + o1[0], base2[1] + o1[1], base2[2] + o1[2]),
                    L0_DIM, float(vals1[i1]),
                ))
            for i1 in np.nonzero(child1)[0]:
                o1 = _offset_to_coord(int(i1), L1_LOG2, L0_LOG2)
                base1 = (base2[0] + o1[0], base2[1] + o1[1], base2[2] + o1[2])
                # ---- leaf topology: value mask only (LeafNode::writeTopology)
                _read_mask(r, L0_N)
                leaf_descs.append(base1)

    # ---- leaf buffers (Tree::readBuffers order = topology order).  Each
    # buffer section RE-STORES the value mask (LeafNode::writeBuffers saves
    # mValueMask again before the values); versions < 222 additionally
    # stored the leaf origin Coord and an int8 buffer count.
    for base in leaf_descs:
        lmask = _read_mask(r, L0_N)
        if file_version < 222:
            r.coord()
            n_bufs = r.byte()
            if n_bufs != 1:
                raise VdbError(f"multi-buffer leaves unsupported ({n_bufs})")
        vals = _read_compressed_values(r, L0_N, lmask, compression,
                                       file_version, background, dtype)
        leaves[base] = vals
    return leaves, tiles, background


def _offset_to_coord(offset: int, log2dim: int, child_log2: int):
    """Linear offset inside an internal node → (x, y, z) voxel offset."""
    dim = 1 << log2dim
    x = offset >> (2 * log2dim)
    y = (offset >> log2dim) & (dim - 1)
    z = offset & (dim - 1)
    return (x << child_log2, y << child_log2, z << child_log2)


def read_vdb(path: str, grid_name: str | None = None) -> VdbGrid:
    """Parse `path` and densify one float grid (the named one, else the
    first float grid; 'density' preferred).  Malformed/truncated files
    raise VdbError (never low-level struct/numpy/zlib errors)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _read_vdb_bytes(data, grid_name)
    except VdbError:
        raise
    except (struct.error, ValueError, IndexError, MemoryError, OverflowError,
            zlib.error) as e:
        raise VdbError(f"malformed .vdb file: {e}") from e


def _read_vdb_bytes(data: bytes, grid_name: str | None) -> VdbGrid:
    r = _Reader(data)
    if r.i64() != MAGIC:
        raise VdbError("not an OpenVDB file (bad magic)")
    file_version = r.u32()
    if file_version < 220 or file_version > 224:
        raise VdbError(
            f"unsupported OpenVDB file version {file_version} (supported: 220-224)"
        )
    r.u32(), r.u32()  # library major/minor
    has_offsets = r.byte() != 0
    compression = COMPRESS_NONE
    if file_version >= 220:
        compression = r.u32()
    # UUID: 36-char ascii without length prefix
    r.bytes(36)
    _read_metadata(r)  # file-level metadata
    if not has_offsets:
        raise VdbError("delayed-load-less archives without grid offsets unsupported")

    n_grids = r.u32()
    if n_grids > len(data):
        raise VdbError(f"grid count {n_grids} exceeds file size")
    descs = []
    for _ in range(n_grids):
        uname = r.string()
        gtype = r.string()
        # Instance-parent name: present in every supported version
        # (GridDescriptor::writeHeader; GRID_INSTANCING = file version 216).
        instance_parent = r.string()
        pos, blocks_pos, end_pos = r.i64(), r.i64(), r.i64()
        if instance_parent:
            raise VdbError(
                f"grid {uname!r} is an instance of {instance_parent!r} — "
                "instanced grids are unsupported"
            )
        descs.append((uname, gtype, pos, end_pos))
        if not 0 <= end_pos <= len(data):
            raise VdbError(f"grid {uname!r}: stream end {end_pos} out of range")
        r.p = end_pos  # descriptors are written back-to-back with bodies

    # pick the grid: float 5-4-3 trees, full precision or 16-bit (native
    # half trees, or saveFloatAsHalf's "_HalfFloat" descriptor suffix).
    def _dtype_of(gtype: str):
        if gtype.endswith("_HalfFloat"):
            gtype = gtype[: -len("_HalfFloat")]
            half = True
        else:
            half = False
        if gtype == "Tree_float_5_4_3":
            return np.float16 if half else np.float32
        if gtype == "Tree_half_5_4_3":
            return np.float16
        return None

    float_grids = [d for d in descs if _dtype_of(d[1]) is not None]
    if not float_grids:
        raise VdbError(
            f"no float 5-4-3 grids found (grids: {[(d[0], d[1]) for d in descs]})"
        )
    pick = None
    for d in float_grids:
        bare = d[0].split("[")[0]
        if grid_name is not None and bare == grid_name:
            pick = d
        if grid_name is None and bare == "density":
            pick = d
    if pick is None:
        if grid_name is not None:
            raise VdbError(f"grid {grid_name!r} not in file: {[d[0] for d in descs]}")
        pick = float_grids[0]

    r.p = pick[2]
    dtype = _dtype_of(pick[1])
    grid_compression = compression
    if file_version >= 222:
        grid_compression = r.u32()
    _read_metadata(r)  # grid metadata
    _, voxel_size, translate = _read_transform(r)
    leaves, tiles, background = _read_tree(r, grid_compression, file_version,
                                           dtype)

    # Tiles with the background value are no-ops (the dense array is
    # background-filled); root-level tiles span 4096 voxels/side and would
    # explode the dense bounding box, so they are rejected rather than
    # silently mis-loaded.
    tiles = [t for t in tiles if t[2] != background]
    for (origin, span, _val) in tiles:
        if span >= L2_SPAN:
            raise VdbError(
                f"active root-level value tile at {origin} (span {span}) — "
                "too large to densify; re-export the grid with leaves"
            )
    if not leaves and not tiles:
        raise VdbError("grid has no active voxels (no leaves or value tiles)")
    extents = [(np.array(k), np.array(k) + L0_DIM) for k in leaves.keys()]
    extents += [(np.array(o), np.array(o) + s) for (o, s, _v) in tiles]
    lo = np.min(np.stack([e[0] for e in extents]), axis=0)
    hi = np.max(np.stack([e[1] for e in extents]), axis=0)
    shape_xyz = hi - lo
    dense = np.full(tuple(shape_xyz[::-1]), background, np.float32)  # (z, y, x)
    # Splat tiles first so leaf voxels (finer data) win any overlap.
    for ((ox, oy, oz), span, val) in tiles:
        x0, y0, z0 = ox - lo[0], oy - lo[1], oz - lo[2]
        dense[z0 : z0 + span, y0 : y0 + span, x0 : x0 + span] = val
    for (ox, oy, oz), vals in leaves.items():
        block = vals.reshape(L0_DIM, L0_DIM, L0_DIM)  # (x, y, z) index order
        zyx = np.transpose(block, (2, 1, 0))
        x0, y0, z0 = ox - lo[0], oy - lo[1], oz - lo[2]
        dense[z0 : z0 + L0_DIM, y0 : y0 + L0_DIM, x0 : x0 + L0_DIM] = zyx
    return VdbGrid(
        name=pick[0].split("[")[0],
        values=dense,
        origin_ijk=lo.astype(np.int64),
        voxel_size=voxel_size.astype(np.float64),
        translate=translate.astype(np.float64),
        background=float(background),
    )


# ---------------------------------------------------------------------------
# Minimal writer (round-trip tests; uses the same 224 layout the reader
# understands, ZIP or raw value buffers).


def write_vdb(path: str, values: np.ndarray, grid_name: str = "density",
              voxel_size: float = 1.0, compress=True,
              tile_uniform_leaves: bool = False,
              save_float_as_half: bool = False) -> None:
    """Write a dense (D, H, W) float array as a single-FloatGrid .vdb.

    `compress`: True/"zip" = zlib value buffers, "blosc" = blosc1-LZ4
    chunks (OpenVDB's own default codec), False = raw.

    With `tile_uniform_leaves`, 8^3 blocks whose voxels are all equal and
    non-zero are written as level-1 active value TILES instead of leaves —
    the compact form OpenVDB itself produces for constant fog regions
    (used to test the reader's tile densification).

    With `save_float_as_half`, value buffers (and the background/inactive
    values) are stored as IEEE half and the descriptor grid type carries
    the "_HalfFloat" suffix, like openvdb::Grid::setSaveFloatAsHalf."""
    values = np.asarray(values, np.float32)
    dtype = np.dtype(np.float16 if save_float_as_half else np.float32)
    d, h, w = values.shape
    out = bytearray()

    def u32(x):
        out.extend(struct.pack("<I", x))

    def i64(x):
        out.extend(struct.pack("<q", x))

    def f32(x):
        out.extend(struct.pack("<f", float(x)))

    def string(sv):
        b = sv.encode()
        u32(len(b))
        out.extend(b)

    if compress == "blosc":
        compression = COMPRESS_BLOSC
    elif compress:
        compression = COMPRESS_ZIP
    else:
        compression = COMPRESS_NONE

    i64(MAGIC)
    u32(224)  # file version
    u32(10), u32(0)  # library version
    out.append(1)  # has grid offsets
    u32(compression)
    out.extend(b"0" * 36)  # uuid
    u32(0)  # file metadata count
    u32(1)  # one grid

    string(f"{grid_name}")
    string("Tree_float_5_4_3" + ("_HalfFloat" if save_float_as_half else ""))
    string("")  # instance parent (GridDescriptor::writeHeader)
    offsets_at = len(out)
    i64(0), i64(0), i64(0)  # patched below

    grid_pos = len(out)
    u32(compression)
    u32(0)  # grid metadata count
    # transform: ScaleMap stores 5 Vec3d (scale, voxelSize, scaleInverse,
    # invScaleSqr, invTwiceScale — math/Maps.h)
    string("UniformScaleMap")
    inv = 1.0 / voxel_size
    for v in ([voxel_size] * 6 + [inv] * 3 + [inv * inv] * 3
              + [0.5 * inv] * 3):
        out.extend(struct.pack("<d", v))

    def value(x):
        out.extend(np.asarray(x, dtype).tobytes())

    # ---- tree
    u32(1)  # buffer count
    value(0.0)  # background
    u32(0)  # tiles

    # Partition voxels into leaves, leaves into one (or more) L2 nodes.
    nz = np.argwhere(values != 0.0)
    if nz.size == 0:
        raise VdbError("refusing to write an empty grid")
    # index order: values[z, y, x] -> coord (x, y, z)
    coords = nz[:, ::-1]
    leaf_keys = sorted({tuple((c // L0_DIM) * L0_DIM) for c in coords})
    l2_keys = sorted({tuple((np.array(k) // L2_SPAN) * L2_SPAN) for k in leaf_keys})
    u32(len(l2_keys))

    def leaf_values(key):
        x0, y0, z0 = key
        blk = np.zeros((L0_DIM, L0_DIM, L0_DIM), np.float32)  # (x, y, z)
        zs = values[z0 : z0 + L0_DIM, y0 : y0 + L0_DIM, x0 : x0 + L0_DIM]
        blk[: zs.shape[2], : zs.shape[1], : zs.shape[0]] = np.transpose(zs, (2, 1, 0))
        return blk.reshape(-1)

    def write_mask(bits):
        packed = np.packbits(bits.astype(np.uint8), bitorder="little")
        out.extend(packed.tobytes())

    def write_vals(vals):
        out.append(NO_MASK_AND_ALL_VALS & 0xFF)  # metadata code 6
        raw = vals.astype(dtype.newbyteorder("<")).tobytes()
        if compression & COMPRESS_BLOSC:
            from vpt_tpu_torch.scene import blosc as blosc_mod

            comp = blosc_mod.compress(raw, typesize=dtype.itemsize)
            i64(len(comp))
            out.extend(comp)
        elif compression & COMPRESS_ZIP:
            comp = zlib.compress(raw)
            i64(len(comp))
            out.extend(comp)
        else:
            out.extend(raw)

    ordered_leaves = []
    for l2 in l2_keys:
        l2 = np.array(l2)
        for c in (l2,):
            out.extend(struct.pack("<3i", *[int(v) for v in c]))
        # level-2 masks
        child2 = np.zeros(L2_N, bool)
        l1_present = sorted({
            tuple(((np.array(k) - l2) // L1_SPAN))
            for k in leaf_keys
            if np.all((np.array(k) >= l2) & (np.array(k) < l2 + L2_SPAN))
        })
        for (cx, cy, cz) in l1_present:
            child2[(cx << (2 * L2_LOG2)) + (cy << L2_LOG2) + cz] = True
        write_mask(child2)
        write_mask(np.zeros(L2_N, bool))
        write_vals(np.zeros(L2_N, np.float32))
        for (cx, cy, cz) in l1_present:
            l1_origin = l2 + np.array([cx, cy, cz]) * L1_SPAN
            child1 = np.zeros(L1_N, bool)
            value1 = np.zeros(L1_N, bool)
            vals1 = np.zeros(L1_N, np.float32)
            leaves_here = sorted({
                tuple((np.array(k) - l1_origin) // L0_DIM)
                for k in leaf_keys
                if np.all((np.array(k) >= l1_origin) & (np.array(k) < l1_origin + L1_SPAN))
            })
            kept = []
            for (lx, ly, lz) in leaves_here:
                slot = (lx << (2 * L1_LOG2)) + (ly << L1_LOG2) + lz
                key = tuple(l1_origin + np.array([lx, ly, lz]) * L0_DIM)
                vals = leaf_values(key)
                if tile_uniform_leaves and vals[0] != 0.0 and np.all(vals == vals[0]):
                    value1[slot] = True  # active value tile
                    vals1[slot] = vals[0]
                else:
                    child1[slot] = True
                    kept.append((key, vals))
            write_mask(child1)
            write_mask(value1)
            write_vals(vals1)
            for key, vals in kept:
                write_mask(vals != 0.0)
                ordered_leaves.append(vals)

    # Leaf buffer sections re-store the value mask before the values
    # (LeafNode::writeBuffers saves mValueMask again).
    for vals in ordered_leaves:
        write_mask(vals != 0.0)
        write_vals(vals)

    end_pos = len(out)
    struct.pack_into("<qqq", out, offsets_at, grid_pos, grid_pos, end_pos)
    with open(path, "wb") as f:
        f.write(bytes(out))
