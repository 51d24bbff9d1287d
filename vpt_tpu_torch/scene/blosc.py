"""Blosc1 chunk codec for OpenVDB value buffers (jax-free port of
vpt_tpu/scene/blosc.py).

OpenVDB's default write path compresses node value arrays with blosc
(c-blosc 1.x, LZ4 codec, byte shuffle, typesize = sizeof(float)) inside the
same Int64-length envelope it uses for zlib.  This module implements the
blosc1 chunk container from the format spec:

  16-byte header: version, versionlz, flags, typesize, nbytes u32,
  blocksize u32, cbytes u32.  flags bit0 = byte shuffle, bit1 = pure
  memcpy, bit2 = bit shuffle; compressor id = flags >> 5
  (0 blosclz, 1 lz4/lz4hc, 3 zlib, 4 zstd).

  Non-memcpy chunks: int32 block offsets (relative to chunk start), then
  per block `nsplits` streams (typesize streams when byte-shuffled and
  typesize <= 16, else one); each stream = int32 cbytes + payload, stored
  verbatim when cbytes equals the stream's uncompressed size.  Shuffled
  blocks unshuffle bytewise after the streams concatenate.

LZ4 blocks are encoded and decoded by the JAX package's C codec,
vpt_tpu/scene/cpp/lz4_block.c, compiled by path with gcc into
vpt_tpu_torch/build/ at first use and loaded with ctypes.  A failed build
raises: there is no silent fallback.  `_lz4_decompress_py` is the plain
Python decoder that the tests hold the C codec against.  zlib and zstd
streams go to the standard library and the `zstandard` module.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib

import numpy as np

from vpt_tpu_torch.accel.kernels import BUILD_DIR, PKG_DIR

_SRC = os.path.join(os.path.dirname(PKG_DIR), "vpt_tpu", "scene", "cpp", "lz4_block.c")
_LIB = os.path.join(BUILD_DIR, "libvpt_lz4.so")
_lib = None

_FLAG_BYTE_SHUFFLE = 0x1
_FLAG_MEMCPYED = 0x2
_FLAG_BIT_SHUFFLE = 0x4
_FLAG_DONT_SPLIT = 0x10  # c-blosc >= 1.11 records the split decision here
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128  # c-blosc MIN_BUFFERSIZE: smaller blocks never split

CODEC_BLOSCLZ = 0
CODEC_LZ4 = 1
CODEC_ZLIB = 3
CODEC_ZSTD = 4


class BloscError(ValueError):
    pass


def _library():
    """The C LZ4 codec, built with gcc on first use."""
    global _lib
    if _lib is None:
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            proc = subprocess.run(["gcc", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"gcc failed to build the LZ4 codec from {_SRC}:\n{proc.stderr}")
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        for fn in (lib.vpt_lz4_decompress, lib.vpt_lz4_compress):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lib
    return _lib


def _lz4_decompress_py(src: bytes, dst_size: int) -> bytes:
    """Pure-Python LZ4 block decode: the plain version of the C codec."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        llen = token >> 4
        if llen == 15:
            while True:
                s = src[i]
                i += 1
                llen += s
                if s != 255:
                    break
        dst += src[i : i + llen]
        i += llen
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(dst):
            raise BloscError("corrupt LZ4 stream (bad offset)")
        mlen = (token & 15)
        if mlen == 15:
            while True:
                s = src[i]
                i += 1
                mlen += s
                if s != 255:
                    break
        mlen += 4
        start = len(dst) - offset
        if offset >= mlen:
            dst += dst[start : start + mlen]
        else:  # overlapping copy
            for k in range(mlen):
                dst.append(dst[start + k])
    if len(dst) != dst_size:
        raise BloscError(f"LZ4 stream decoded {len(dst)} bytes, expected {dst_size}")
    return bytes(dst)


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    out = (ctypes.c_uint8 * dst_size)()
    n = _library().vpt_lz4_decompress(src, len(src), out, dst_size)
    if n != dst_size:
        raise BloscError(f"LZ4 stream decoded {n} bytes, expected {dst_size}")
    return bytes(out)


def lz4_compress(src: bytes):
    """LZ4-encode `src`, or None where the encoding would not be smaller."""
    cap = max(len(src) - 1, 16)
    out = (ctypes.c_uint8 * cap)()
    n = _library().vpt_lz4_compress(src, len(src), out, cap)
    if n <= 0 or n >= len(src):
        return None
    return bytes(out[:n])


def _unshuffle(block: bytes, typesize: int) -> bytes:
    a = np.frombuffer(block, np.uint8)
    return a.reshape(typesize, -1).T.tobytes()


def _shuffle(block: bytes, typesize: int) -> bytes:
    a = np.frombuffer(block, np.uint8)
    return a.reshape(-1, typesize).T.tobytes()


def decompress(chunk: bytes) -> bytes:
    """Decode one blosc1 chunk to its raw bytes."""
    if len(chunk) < 16:
        raise BloscError("blosc chunk shorter than its 16-byte header")
    version, _versionlz, flags, typesize = chunk[0], chunk[1], chunk[2], chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", chunk, 4)
    if cbytes > len(chunk):
        raise BloscError(f"blosc chunk truncated: header says {cbytes}, have {len(chunk)}")
    if flags & _FLAG_MEMCPYED:
        if len(chunk) < 16 + nbytes:
            raise BloscError("memcpyed blosc chunk truncated")
        return chunk[16 : 16 + nbytes]
    if flags & _FLAG_BIT_SHUFFLE:
        raise BloscError("bit-shuffled blosc chunks are not supported")
    codec = (flags >> 5) & 0x7
    shuffled = bool(flags & _FLAG_BYTE_SHUFFLE) and typesize > 1
    nblocks = -(-nbytes // blocksize) if blocksize else 0
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, 16)

    def _codec_decode(payload: bytes, out_size: int) -> bytes:
        if codec == CODEC_LZ4:
            return lz4_decompress(payload, out_size)
        if codec == CODEC_ZLIB:
            return zlib.decompress(payload)
        if codec == CODEC_ZSTD:
            import zstandard

            return zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=out_size
            )
        raise BloscError(
            f"unsupported blosc codec id {codec} (LZ4/zlib/zstd supported; "
            "blosclz is not — re-export with the default OpenVDB settings)"
        )

    # Split inference replicates c-blosc 1.x blosc_d() exactly:
    # a block is split into `typesize` streams only when the chunk-level
    # don't-split flag (0x10, recorded by c-blosc >= 1.11; older writers
    # never set it and always split under these same conditions) is clear,
    # the block is NOT the partial trailing (leftover) block, typesize is
    # splittable, and blocksize/typesize >= MIN_BUFFERSIZE (=128) — real
    # OpenVDB mask-compressed value buffers under ~512 bytes hit that floor
    # and arrive unsplit with 0x10 set.
    dont_split = bool(flags & _FLAG_DONT_SPLIT)
    out = bytearray()
    for bi in range(nblocks):
        bsize = min(blocksize, nbytes - bi * blocksize)
        leftover = bsize < blocksize
        nsplits = (
            typesize
            if (not dont_split and not leftover and 1 < typesize <= _MAX_SPLITS
                and blocksize // typesize >= _MIN_BUFFERSIZE
                and bsize % typesize == 0)
            else 1
        )
        neblock = bsize // nsplits
        pos = bstarts[bi]
        parts = []
        for _ in range(nsplits):
            (sc,) = struct.unpack_from("<i", chunk, pos)
            pos += 4
            payload = chunk[pos : pos + sc]
            pos += sc
            if sc == neblock:  # stored verbatim
                parts.append(payload)
            else:
                parts.append(_codec_decode(payload, neblock))
        block = b"".join(parts)
        if shuffled:
            block = _unshuffle(block, typesize)
        out += block
    if len(out) != nbytes:
        raise BloscError(f"blosc chunk decoded {len(out)} bytes, expected {nbytes}")
    return bytes(out)


def compress(data: bytes, typesize: int = 4, blocksize: int = 1 << 16) -> bytes:
    """Encode raw bytes as a blosc1 chunk (LZ4 codec, byte shuffle), the
    layout OpenVDB emits.  Streams that don't shrink are stored verbatim
    (cbytes == neblock)."""
    nbytes = len(data)
    blocksize = min(blocksize, max(typesize, nbytes))
    if blocksize % typesize:
        blocksize += typesize - blocksize % typesize
    shuffled = typesize > 1 and nbytes % typesize == 0
    # Mirror c-blosc's split decision (see decompress): split only when
    # typesize is splittable AND blocksize/typesize clears MIN_BUFFERSIZE;
    # record a no-split decision in flags bit 4 so real c-blosc (and our
    # decoder) reads the streams from the right offsets.  The leftover
    # (partial trailing) block is never split regardless.
    do_split = (
        shuffled and 1 < typesize <= _MAX_SPLITS
        and blocksize // typesize >= _MIN_BUFFERSIZE
    )
    flags = (_FLAG_BYTE_SHUFFLE if shuffled else 0) | (CODEC_LZ4 << 5)
    if not do_split:
        flags |= _FLAG_DONT_SPLIT
    nblocks = -(-nbytes // blocksize) if nbytes else 0
    header = bytearray(16)
    header[0], header[1], header[2], header[3] = 2, 1, flags, typesize
    body = bytearray()
    bstarts = []
    base = 16 + 4 * nblocks
    for bi in range(nblocks):
        raw = data[bi * blocksize : bi * blocksize + blocksize]
        bsize = len(raw)
        block = _shuffle(raw, typesize) if (shuffled and bsize % typesize == 0) else raw
        nsplits = typesize if (do_split and bsize == blocksize
                               and bsize % typesize == 0) else 1
        neblock = bsize // nsplits
        bstarts.append(base + len(body))
        for j in range(nsplits):
            stream = block[j * neblock : (j + 1) * neblock]
            enc = lz4_compress(stream)
            if enc is None or len(enc) >= neblock:
                body += struct.pack("<i", neblock) + stream
            else:
                body += struct.pack("<i", len(enc)) + enc
    chunk = bytearray(header) + struct.pack(f"<{nblocks}i", *bstarts) + bytes(body)
    struct.pack_into("<III", chunk, 4, nbytes, blocksize, len(chunk))
    return bytes(chunk)
