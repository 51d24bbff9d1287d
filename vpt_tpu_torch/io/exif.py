"""OpenCV 5.0's EXIF reader (exif.cpp, `ExifReader`) and
`ApplyExifOrientation` (loadsave.cpp), as far as `imreadmulti` uses them:
the orientation of the image.

The reader takes the TIFF structure a decoder hands it (a JPEG's first
"Exif" APP1 segment from its seventh byte on; a PNG's `eXIf` chunk; a WebP's `EXIF`
chunk): little-endian where its first two bytes are `II`, else big-endian;
42 next, then the entries of the first IFD only, each keyed by its tag, the
first of a tag kept.  Tags the reader does not know are kept under no tag.
The strings and rationals it knows are read from their offsets; one that
lies past the data stops the reading there, keeping the entries before
it.  The orientation is the 16-bit value at the entry's value field,
whatever the entry's type and count.
"""

from __future__ import annotations

import numpy as np

ORIENTATION = 0x0112
_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)  # description, make, model, software, date, copyright
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}  # tag -> rationals read
_U16 = (0x0128, 0x0213)  # resolution unit, YCbCr positioning
_KNOWN = (ORIENTATION, 0x8769) + _STRINGS + tuple(_RATIONALS) + _U16


class _Stop(Exception):
    pass


def orientation(data: bytes | None) -> int | None:
    """The orientation OpenCV's ExifReader finds in a TIFF structure, or None."""
    if not data:
        return None
    order = "little" if data[:2] == b"II" else "big"  # (any other mark reads big-endian)
    n = len(data)

    def u16(at: int) -> int:
        if at + 1 >= n:
            raise _Stop
        return int.from_bytes(data[at : at + 2], order)

    def u32(at: int) -> int:
        if at + 3 >= n:
            raise _Stop
        return int.from_bytes(data[at : at + 4], order)

    found = {}
    try:
        if u16(2) != 0x2A:
            return None
        offset = u32(4)
        count = u16(offset)
        offset += 2
        for _ in range(count):
            tag = u16(offset)
            if tag == ORIENTATION:
                value = u16(offset + 8)
            elif tag in _STRINGS:
                size = u32(offset + 4)
                at = u32(offset + 8) if size > 4 else offset + 8
                if at > n or at + size > n:
                    raise _Stop
                value = None
            elif tag in _RATIONALS:
                at = u32(offset + 8)
                for k in range(_RATIONALS[tag]):
                    u32(at + 8 * k)
                    u32(at + 8 * k + 4)
                value = None
            elif tag in _U16:
                value = u16(offset + 8)
            else:
                value = None
            found.setdefault(tag if tag in _KNOWN else None, value)
            offset += 12
    except _Stop:
        pass
    return found.get(ORIENTATION)


def apply_orientation(img: np.ndarray, orient: int | None) -> np.ndarray:
    """ApplyExifOrientation: 2 mirrors, 3 turns half way, 4 flips, 5-8
    transpose first (5 alone, 6 then mirror, 7 then both, 8 then flip)."""
    if orient is None or orient < 2 or orient > 8:
        return img
    if orient >= 5:
        img = img.swapaxes(0, 1)
    if orient in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orient in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
