"""GIF decoding (GIF87a / GIF89a, the first frame) to what PIL opens.

The header, the colour tables and the extension blocks are parsed here as
PIL's GifImagePlugin parses them; the frame's LZW codes go to the C codec
(io/codec.py `gif_lzw`, the decoder of PIL's GifDecode.c: LSB-first codes,
a table of 4096 entries that stops growing when full, interlaced rows in
their four passes).  What PIL gives for the first frame:

- the image is the logical screen, grown to hold the frame where the frame
  reaches past it; pixels outside the frame are the graphic-control
  transparency index where there is one, else 0;
- mode "P" with the frame's colour table (the local one, else the global
  one), or mode "L" (the indices as gray levels) when there is none or the
  table is the identity gray ramp (entry i = (i, i, i)); palette entries past
  the table's end are black, as in PIL;
- the graphic-control transparency index as PIL's `info["transparency"]`:
  `convert("RGBA")` gives its palette entry (or its gray level) alpha 0.

A frame whose data ends, or whose codes end (EOI), before its last pixel
raises a ValueError, as PIL raises on it ("image file is truncated").
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec


def _table(p: bytes) -> np.ndarray:
    """A colour table as PIL's (256, 3) palette: the entries given, the
    rest black."""
    table = np.zeros((256, 3), np.uint8)
    n = min(len(p) // 3, 256)
    table[:n] = np.frombuffer(p[: 3 * n], np.uint8).reshape(n, 3)
    return table


def _needed(p: bytes) -> bool:
    """PIL's _is_palette_needed: the table is not the identity gray ramp."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def _colour_table(data: bytes, pos: int, flags: int, name: str) -> tuple:
    """(the colour table that `flags` announces at data[pos], the position after it)."""
    n = 3 << ((flags & 7) + 1)
    if pos + n > len(data):
        raise ValueError(f"{name}: GIF file is truncated in a colour table")
    return data[pos : pos + n], pos + n


def read_pil(data: bytes, name: str = "image") -> tuple:
    """The first frame as PIL opens it: (indices (H, W) uint8, mode "P" or
    "L", (256, 3) palette or None, transparency index or None)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{name} is not a GIF file")
    if len(data) < 13:
        raise ValueError(f"{name}: GIF file is truncated")
    sw, sh = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 128:
        p, pos = _colour_table(data, pos, flags, name)
        if _needed(p):
            global_palette = p

    def sub_block(at: int):
        """(bytes or None, next position) of PIL's `data()`: a length byte
        and that many bytes; None for a 0 length."""
        if at >= len(data):
            return None, at
        n = data[at]
        return (data[at + 1 : at + 1 + n] if n else None), at + 1 + n

    transparency, frame = None, None
    while pos < len(data):
        c = data[pos]
        pos += 1
        if c == 0x3B:  # trailer
            break
        if c == 0x21:  # extension
            if pos >= len(data):
                raise ValueError(f"{name}: GIF file is truncated in an extension")
            label = data[pos]
            block, pos = sub_block(pos + 1)
            if label == 249 and block is not None:
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError(f"{name}: GIF graphic control extension is truncated")
                if block[0] & 1:
                    transparency = block[3]
            while block is not None:
                block, pos = sub_block(pos)
        elif c == 0x2C:  # image descriptor
            d = data[pos : pos + 9]
            if len(d) < 9:
                raise ValueError(f"{name}: GIF image descriptor is truncated")
            pos += 9
            x0, y0 = int.from_bytes(d[0:2], "little"), int.from_bytes(d[2:4], "little")
            w, h = int.from_bytes(d[4:6], "little"), int.from_bytes(d[6:8], "little")
            palette = None
            if d[8] & 128:
                p, pos = _colour_table(data, pos, d[8], name)
                palette = p if _needed(p) else False
            if pos >= len(data):
                raise ValueError(f"{name}: GIF file is truncated")
            bits = data[pos]
            frame = (x0, y0, w, h, bool(d[8] & 64), palette, bits, pos + 1)
            break
    if frame is None:
        raise ValueError(f"{name}: GIF file holds no image")
    x0, y0, w, h, interlace, palette, bits, pos = frame
    frame_palette = palette if palette is not None else global_palette
    width, height = max(sw, x0 + w), max(sh, y0 + h)
    if w == 0 or h == 0:
        raise ValueError(f"{name}: GIF frame of zero size is not read")
    codec.check_size(width, height, name)
    chunks = []
    while pos < len(data):
        n = data[pos]
        if n == 0 or pos + 1 + n > len(data):
            break
        chunks.append(data[pos + 1 : pos + 1 + n])
        pos += 1 + n
    pixels, status = codec.gif_lzw(b"".join(chunks), bits, w, h, interlace)
    if status:
        raise ValueError(f"{name}: GIF file is truncated (its {'codes' if status == 1 else 'data'} end before the "
                         f"frame's last pixel)")
    out = np.full((height, width), transparency if transparency is not None else 0, np.uint8)
    out[y0 : y0 + h, x0 : x0 + w] = pixels
    if frame_palette:
        return out, "P", _table(frame_palette), transparency
    return out, "L", None, transparency
