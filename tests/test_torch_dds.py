"""The port's DDS reader (io/dds.py and the BC1-BC7 block decoders of
csrc/bcndec.c) against the JAX package, which reads DDS with PIL (the glTF
texture decode, `load_png`) and imageio's PIL plugin (`load_hdr` under
.dds): every case of tests/pil_format_cases.py (PIL's DXT1/3/5, BC2, BC3,
BC5 and uncompressed files; BC4, BC5S, BC6H and BC7 from random blocks,
whose bits reach every mode; channel masks, palettes, DX10, mip levels) and
a seeded sweep of corrupt copies give the same arrays on every path, or a
ValueError where the JAX package raises.  Also the block decoders on their
own against PIL over many random blocks of every kind.
"""

import io

import numpy as np
import pytest
from PIL import Image

import pil_format_cases as pc
import pil_format_checks as chk
import pil_format_writers as pw
from vpt_tpu_torch.io import codec

NAMES = pc.names(("dds",))
REFUSED = {"dds-bc7-truncated", "dds-dxt2-refused"}


@pytest.mark.parametrize("name", NAMES)
def test_case_equals_jax(tmp_path, name):
    """One file on the three pairs (texture from memory and from a file,
    load_png, load_hdr): equal, or refused by both; and the JAX package
    reads every case but REFUSED on every path."""
    result = chk.compare(pc.case_bytes(name), str(tmp_path), (".dds",))
    assert [v for k, v in result.items() if k != "_jax" and v] == []
    assert bool(result["_jax"]) == (name not in REFUSED)
    assert len(result["_jax"]) in (0, len(result) - 1)


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_equal_jax(tmp_path, seed):
    """Corrupt copies (a byte changed, the file cut, a byte put in; 12 per
    seed, each of another case): each decodes as the JAX package decodes it
    on every path, or raises a ValueError where it raises."""
    for k in range(12):
        name = NAMES[(seed * 12 + k) * 5 % len(NAMES)]
        assert chk.failures(pc.mutants(name, seed, 1)[0], str(tmp_path), (".dds",)) == [], name


_KINDS = {1: ({"fourcc": b"DXT1"}, False), 2: ({"fourcc": b"DXT3"}, False), 3: ({"fourcc": b"DXT5"}, False),
          4: ({"fourcc": b"ATI1"}, False), 5: ({"fourcc": b"ATI2"}, False), 55: ({"fourcc": b"BC5S"}, True),
          6: ({"dxgi": 95}, False), 66: ({"dxgi": 96}, True), 7: ({"dxgi": 98}, False)}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_block_decoders_equal_pil(kind):
    """4,096 random blocks of each kind (every BC6H and BC7 mode, the
    reserved ones too) decode bitwise as PIL's BcnDecode does."""
    kw, sign = _KINDS[kind]
    k = kind % 10 if kind > 9 else kind
    rng = np.random.default_rng(kind)
    w, h = 256, 64
    blocks = pw.bc_blocks(rng, w, h, k)
    want = np.asarray(Image.open(io.BytesIO(pw.dds(w, h, blocks, **kw))))
    got = codec.bcn_decode(blocks, w, h, k, sign)
    got = got[..., : want.shape[2]] if want.ndim == 3 else got
    np.testing.assert_array_equal(got, want)
    if k in (6, 7):  # the blocks reach every mode
        first = np.frombuffer(blocks, np.uint8)[:: 16]
        modes = set((first & 0x1F).tolist()) if k == 6 else {int(b).bit_length() - 1 if b else 8 for b in
                                                              (first & -first)}
        assert len(modes) == (18 if k == 6 else 9)


def test_block_decoder_refuses_short_data():
    """Data that ends inside the last block raises, as PIL's decoder reports
    the file truncated; an unknown kind raises."""
    blocks = pw.bc_blocks(np.random.default_rng(0), 8, 8, 7)
    assert codec.bcn_decode(blocks, 8, 8, 7).shape == (8, 8, 4)
    with pytest.raises(ValueError, match="truncated"):
        codec.bcn_decode(blocks[:-1], 8, 8, 7)
    with pytest.raises(ValueError, match="kind"):
        codec.bcn_decode(blocks, 8, 8, 9)
