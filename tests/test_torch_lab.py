"""The port's Lab -> sRGB conversion (io/lab.py) against PIL's, which goes
through LittleCMS 2.17's optimised 8-bit transform: equal on all 2**24 Lab
byte triples (a 4096x4096 image holds one of each)."""

import numpy as np
from PIL import Image

from vpt_tpu_torch.io import lab


def test_every_lab_triple_equals_pil():
    v = np.arange(1 << 24, dtype=np.uint32)
    samples = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), samples.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab.to_rgb(samples), want)


def test_grid_nodes_are_sixteen_bit():
    g = lab.grid()
    assert g.shape == (lab.N ** 3, 3) and g.min() >= 0 and g.max() <= 65535
