"""The port's OpenVDB reader and writer and its blosc codec against the
JAX package: files either side writes (zlib, blosc, uncompressed, half)
read equal on the other; the JAX package's own format tests (the
hand-assembled fixtures, the truncation and corruption fuzz, the round
trips of tests/test_vdb.py and the blosc split cases) run against the
port's modules; the C LZ4 codec equals the pure-Python decoder; a failed
gcc build raises; `load_grid(".vdb")` equals JAX's."""

import inspect
import os
import sys

import numpy as np
import pytest

import test_blosc_format
import test_vdb
import test_vdb_format
from vpt_tpu.scene import vdb as jvdb
from vpt_tpu.scene import vdb_reader as jreader
from vpt_tpu_torch.scene import blosc, vdb, vdb_reader

# The JAX package's test functions, with the module-level names they use.
PORT_NAMES = {
    test_vdb_format: {n: getattr(vdb_reader, n) for n in ("COMPRESS_ACTIVE_MASK", "COMPRESS_ZIP", "L0_DIM", "L0_N",
                                                          "L1_N", "L2_N", "MAGIC", "VdbError", "read_vdb",
                                                          "write_vdb")},
    test_vdb: {"load_grid": vdb.load_grid, "procedural_cloud": vdb.procedural_cloud, "MAGIC": vdb_reader.MAGIC,
               "VdbError": vdb_reader.VdbError, "read_vdb": vdb_reader.read_vdb, "write_vdb": vdb_reader.write_vdb},
    test_blosc_format: {"blosc": blosc, "LZ4F": blosc.CODEC_LZ4 << 5},
}
# test_blosc_codec_units patches the JAX codec's loader; its port is
# test_c_codec_equals_the_python_decoder below.
SKIP = {"test_blosc_codec_units"}
CASES = [(m.__name__, n) for m in PORT_NAMES for n in sorted(vars(m)) if n.startswith("test_") and n not in SKIP]


@pytest.mark.parametrize("module,name", CASES)
def test_jax_format_case_against_the_port(module, name, tmp_path, monkeypatch):
    mod = sys.modules[module]
    for attr, value in PORT_NAMES[mod].items():
        monkeypatch.setattr(mod, attr, value)
    fn = getattr(mod, name)
    fn(*[tmp_path] * len(inspect.signature(fn).parameters))


@pytest.mark.parametrize("compress", ["blosc", "zip", "none"])
@pytest.mark.parametrize("half", [False, True])
def test_files_read_equal_both_ways(tmp_path, compress, half):
    vals = vdb.procedural_cloud((40, 32, 48), coverage=0.6, seed=2)  # whole leaves
    mode = False if compress == "none" else compress
    for writer, reader, tag in ((vdb_reader, jreader, "port"), (jreader, vdb_reader, "jax")):
        path = str(tmp_path / f"{tag}.vdb")
        writer.write_vdb(path, vals, voxel_size=0.25, compress=mode, save_float_as_half=half)
        got, want = reader.read_vdb(path), (jreader if reader is vdb_reader else vdb_reader).read_vdb(path)
        assert got.values.dtype == np.float32 and np.array_equal(got.values, want.values)
        assert np.array_equal(got.origin_ijk, want.origin_ijk) and np.array_equal(got.voxel_size, want.voxel_size)
        ox, oy, oz = (int(v) for v in got.origin_ijk)
        d, h, w = got.values.shape
        src = vals.astype(np.float16).astype(np.float32) if half else vals
        np.testing.assert_array_equal(got.values, src[oz:oz + d, oy:oy + h, ox:ox + w])
    assert open(str(tmp_path / "port.vdb"), "rb").read() == open(str(tmp_path / "jax.vdb"), "rb").read()


def test_load_grid_vdb_equals_jax(tmp_path):
    path = str(tmp_path / "cloud.vdb")
    vdb_reader.write_vdb(path, vdb.procedural_cloud((32, 32, 32), seed=5), compress="blosc")
    got, want = vdb.load_grid(path), jvdb.load_grid(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_c_codec_equals_the_python_decoder():
    """Blosc chunks of compressible and random data, and their byte-shuffled
    4 KiB streams: the C LZ4 decoder gives the pure-Python one's bytes, LZ4
    really compresses, and
    memcpyed and truncated chunks behave as the JAX codec's do."""
    rng = np.random.default_rng(2)
    smooth = (np.sin(np.arange(30000, dtype=np.float32) * 0.01) * 50).tobytes()
    cloud = vdb.procedural_cloud((24, 24, 24), seed=3).tobytes()
    for data in (smooth, cloud, rng.bytes(8192)):
        chunk = blosc.compress(data, typesize=4)
        assert blosc.decompress(chunk) == data
        streams = 0
        for src in (blosc._shuffle(data[i:i + 4096], 4) for i in range(0, len(data), 4096)):
            enc = blosc.lz4_compress(src)
            if enc is not None:
                streams += 1
                assert len(enc) < len(src)
                assert blosc.lz4_decompress(enc, len(src)) == blosc._lz4_decompress_py(enc, len(src)) == src
        assert streams > 0 or data not in (smooth, cloud)
    assert len(blosc.compress(smooth, typesize=4)) < len(smooth)
    rnd = rng.bytes(8192)
    hdr = bytearray(16)
    hdr[0], hdr[1], hdr[2], hdr[3] = 2, 1, 0x2, 4
    hdr[4:16] = np.array([len(rnd), len(rnd), 16 + len(rnd)], "<u4").tobytes()
    assert blosc.decompress(bytes(hdr) + rnd) == rnd
    with pytest.raises(blosc.BloscError):
        blosc.decompress(blosc.compress(smooth, typesize=4)[:10])
    with pytest.raises(blosc.BloscError):
        blosc.lz4_decompress(blosc.lz4_compress(blosc._shuffle(smooth[:4096], 4)), 4095)


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """No silent fallback: when gcc cannot build the codec, the first use raises."""
    monkeypatch.setattr(blosc, "_lib", None)
    monkeypatch.setattr(blosc, "_LIB", str(tmp_path / "libvpt_lz4.so"))
    monkeypatch.setattr(blosc, "_SRC", str(tmp_path / "missing.c"))
    open(str(tmp_path / "missing.c"), "w").write("this is not C\n")
    with pytest.raises(RuntimeError, match="gcc failed to build the LZ4 codec"):
        blosc.decompress(blosc.compress(b"\0" * 4096, typesize=4))
    assert not os.path.exists(str(tmp_path / "libvpt_lz4.so"))
