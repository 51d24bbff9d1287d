"""X bitmap decoding to what PIL's XbmImagePlugin opens: PIL's header match
on the first 512 bytes (width and height defines, an optional hot spot,
then the bits array), then the hex values as PIL's C decoder reads them
(the C codec's `xbm_hex`), 1-bit pixels least significant bit first (mode
"1").  A file PIL's plugin does not take raises PassOn."""

from __future__ import annotations

import re

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def read_pil(data: bytes, name: str = "image") -> tuple:
    """An X bitmap as PIL opens it: (array, "1", None)."""
    m = _HEAD.match(data[:512])
    if not m:
        raise PassOn(f"{name}: not an XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: XBM image of {w}x{h} pixels")
    codec.check_size(w, h, name)
    try:
        lines = codec.xbm_hex(memoryview(data)[m.end() :], (w + 7) // 8, h)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return raw.unpack("1", "1;R", lines, w), "1", None
