"""IPTC / NAA image decoding to what PIL's IptcImagePlugin opens: the
fields up to record 8:10, the layers and size from records 3:60, 3:20 and
3:30, the compression from 3:120 (1 raw, 5 JPEG), and the image data of the
8:10 fields, opened as PIL opens it (raw data as an 8-bit PGM; a band of a
colour image placed in its band, the others zero).  A file whose fields PIL
cannot read raises PassOn; what it refuses, a ValueError."""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn


class _Fields:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def field(self, opening: bool) -> tuple:
        """PIL's field(): (tag or None, size)."""
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        bad = PassOn if opening else ValueError
        if len(s) < 3 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise bad(f"{self.name}: invalid IPTC/NAA file")
        tag = (s[1], s[2])
        if len(s) < 4:
            raise bad(f"{self.name}: IPTC field ends early")
        size = s[3]
        if size > 132:
            raise ValueError(f"{self.name}: illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes((b"\0\0\0\0" + self.read(size - 128))[-4:], "big")
        else:
            if len(s) < 5:
                raise bad(f"{self.name}: IPTC field ends early")
            size = int.from_bytes(s[3:5], "big")
        return tag, size


def _int(value) -> int:
    """PIL's getint: the record's last four bytes, big-endian (a TypeError
    for a record of no data or a repeated one)."""
    return int.from_bytes((b"\0\0\0\0" + value)[-4:], "big")


def read_pil(data: bytes, name: str = "image", open_image=None, asarray: bool = False) -> tuple:
    """An IPTC / NAA file as PIL opens it: (array, mode, palette), the
    image data's own array and mode, which PIL's IPTC image loads whatever
    the records say (its `convert` converts them).  `open_image(bytes,
    name)` opens the image data as PIL's `Image.open` does: (array, mode,
    palette, transparency).  `asarray`: as `np.asarray` gives it instead,
    the image data's bytes in the records' size and mode."""
    f = _Fields(data, name)
    info = {}
    while True:
        offset = f.pos
        tag, size = f.field(True)
        if not tag or tag == (8, 10):
            break
        value = f.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value
    try:  # PIL's _open from here: a KeyError, IndexError or TypeError passes the file on
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        band, mode = None, ""
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        w, h = _int(info[(3, 20)]), _int(info[(3, 30)])
        if (3, 120) not in info:
            raise ValueError(f"{name}: unknown IPTC image compression (none given)")
        compression = {1: "raw", 5: "jpeg"}.get(_int(info[(3, 120)]))
    except (KeyError, IndexError, TypeError) as e:
        raise PassOn(f"{name}: IPTC records PIL cannot read ({type(e).__name__})") from None
    if compression is None:
        raise ValueError(f"{name}: unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise PassOn(f"{name}: IPTC image PIL gives no mode or size")
    codec.check_size(w, h, name)
    if tag != (8, 10):
        raise ValueError(f"{name}: IPTC file without image data (PIL: cannot load this image)")
    f.pos = offset
    parts = [b"P5\n%d %d\n255\n" % (w, h)] if compression == "raw" else []
    while True:
        kind, size = f.field(False)
        if kind != (8, 10):
            break
        parts.append(f.read(size))
    arr, inner, table, _ = open_image(b"".join(parts), name)
    bands = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    if band is not None:
        if inner != "L":
            raise ValueError(f"{name}: IPTC band image of mode {inner} (PIL: mode mismatch)")
        if not -bands <= band < bands:
            raise ValueError(f"{name}: IPTC band {band + 1} of a {mode} image (PIL: IndexError)")
        out = np.zeros(arr.shape + (bands,), np.uint8)
        out[..., band] = arr
        arr, inner = out, mode
    if not asarray:
        return arr, inner, table
    flat = np.ascontiguousarray(arr).reshape(-1)
    if inner != mode or flat.size < h * w * bands:
        raise ValueError(f"{name}: IPTC image data of mode {inner} and {arr.shape[1]}x{arr.shape[0]} pixels in a "
                         f"{mode} image of {w}x{h}: np.asarray reads past PIL's buffer (memory no reader can "
                         f"reproduce)")
    return flat[: h * w * bands].reshape((h, w, bands) if bands > 1 else (h, w)), mode, table
