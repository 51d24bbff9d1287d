"""JPEG 2000 (JP2 files and raw codestreams) to what PIL opens.

PIL 12.1 opens JPEG 2000 in two steps, and the port follows both:

- `Jpeg2KImagePlugin._open` reads the size and mode itself: from a raw
  codestream's SIZ segment (1 component: "L", or "I;16" above 8 bits; 2:
  "LA"; 3: "RGB"; 4: "RGBA"), or from a JP2 file's header box (`ihdr`; a
  four-component `colr` with enumerated colour space 12 is "CMYK"; a `pclr`
  palette of at most 8 bits on a one- or two-component image is "P" or
  "PA", its entries gathered by ImagePalette.getcolor, which keeps each
  colour once).  Its SyntaxErrors (and IndexError, struct.error) pass the
  file on to PIL's next plugin; its other errors refuse the file.
- Its decoder hands the whole file to OpenJPEG 2.5 (`opj_read_header`,
  then `opj_read_tile_header` / `opj_decode_tile_data` per tile, then
  `opj_end_decompress`) and places each tile with one of its unpackers,
  chosen by OpenJPEG's colour space (a JP2 file's enumerated `colr`
  space: sRGB, gray, sYCC, e-sYCC or CMYK; otherwise, and for a raw
  codestream, gray for one or two components and sRGB for three or four),
  the component count and PIL's mode.  OpenJPEG applies
  neither `pclr`, `cmap` nor `cdef` on this path: a palette image's samples
  are its indices.

`_Jp2` is OpenJPEG's JP2 box reader (its signature, file-type and
header boxes and their checks); the codestream itself, tier 1 and 2, the
wavelets, the component transforms and PIL's unpackers are the C decoder
(csrc/j2kdec.c, io/codec.py), which decodes bitwise as OpenJPEG does.  Its
refusals, and every error OpenJPEG or PIL's decoder raises, become
ValueErrors naming the file.  High-throughput (HTJ2K) code-blocks are
refused by name.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from vpt_tpu_torch.io import codec, probe

CODESTREAM = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# PIL's errors in a plugin's _open that make Image.open try the next plugin.
_PASS_ON = (SyntaxError, IndexError, TypeError, struct.error)
# OpenJPEG's colour spaces, and JP2's enumerated ones that map to them.
_SRGB, _GRAY, _SYCC, _EYCC, _CMYK = 1, 2, 3, 4, 5
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}
# PIL's unpackers (Jpeg2KDecode.c) by (mode, colour space, components), as
# csrc/j2kdec.c numbers them: 1 gray_l, 2 gray_i, 3 gray_rgb, 4 graya_la,
# 5 srgb_rgb, 6 sycc_rgb, 7 srgba_rgba, 8 sycca_rgba.
_UNPACKERS = {("L", _GRAY, 1): 1, ("P", _SRGB, 1): 1, ("PA", _SRGB, 2): 4, ("I;16", _GRAY, 1): 2,
              ("LA", _GRAY, 2): 4, ("RGB", _GRAY, 1): 3, ("RGB", _GRAY, 2): 3, ("RGB", _SRGB, 3): 5,
              ("RGB", _SYCC, 3): 6, ("RGB", _SRGB, 4): 5, ("RGB", _SYCC, 4): 6, ("RGBA", _GRAY, 1): 3,
              ("RGBA", _GRAY, 2): 4, ("RGBA", _SRGB, 3): 5, ("RGBA", _SYCC, 3): 6, ("RGBA", _GRAY, 4): 7,
              ("RGBA", _SRGB, 4): 7, ("RGBA", _SYCC, 4): 8, ("CMYK", _CMYK, 4): 7}


def accept(data: bytes) -> bool:
    """PIL's `_accept`: a raw codestream (SOC, SIZ) or the JP2 signature box."""
    return data.startswith((CODESTREAM, JP2_SIGNATURE))


# ---------------------------------------------------------------------------
# PIL's _open


class _BoxReader:
    """PIL's BoxReader over a file object: box headers and fields, bounded
    by a parent box's length where it has one."""

    def __init__(self, fp, length: int = -1):
        self.fp, self.has_length, self.length, self.remaining = fp, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise OSError(f"Expected to read {n} bytes but only got {len(data)}.")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def boxes(self) -> "_BoxReader":
        size = self.remaining
        return _BoxReader(io.BytesIO(self._read_bytes(size)), size)

    def has_next_box(self) -> bool:
        return self.fp.tell() + self.remaining < self.length if self.has_length else True

    def next_box_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, os.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


class _Palette:
    """ImagePalette's colour allocation (`getcolor` without an image): each
    new colour at the next index, a colour seen before not again."""

    def __init__(self, mode: str):
        self.mode, self.palette, self.colors = mode, bytearray(), {}

    def getcolor(self, color: tuple) -> None:
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return
        n = len(self.mode)
        index = len(self.palette) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * n < len(self.palette):
            self.palette = self.palette[: index * n] + bytes(color) + self.palette[index * n + n :]
        else:
            self.palette += bytes(color)

    def table(self) -> np.ndarray:
        """The image's palette after `Image.load` puts it: (256, 3) or (256,
        4), whole entries of the bytes, the rest opaque black."""
        n = len(self.mode)
        entries = len(self.palette) // n
        out = np.zeros((256, n), np.uint8)
        out[:, 3:] = 255
        out[:entries] = np.frombuffer(bytes(self.palette[: entries * n]), np.uint8).reshape(-1, n)
        return out


def _parse_codestream(fp) -> tuple:
    hdr = fp.read(2)
    lsiz = struct.unpack_from(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _parse_jp2_header(fp) -> tuple:
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise ValueError("no JP2 header box (PIL's assertion)")
    size = mode = nc = palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(tuple(header.fields(">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        if marker[1] in (0x90, 0xD9):
            break
        length = struct.unpack_from(">H", fp.read(2))[0]
        if marker[1] == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


def _pil_open(data: bytes, name: str) -> tuple:
    """(size, mode, palette or None, raw codestream?) as PIL's _open finds
    them; probe.PassOn where PIL tries its next plugin."""
    fp = io.BytesIO(data)
    try:
        sig = fp.read(4)
        if sig == CODESTREAM:
            size, mode = _parse_codestream(fp)
            _parse_comment(fp)
            return size, mode, None, True
        sig += fp.read(8)
        if sig != JP2_SIGNATURE:
            raise SyntaxError("not a JPEG 2000 file")
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c" + CODESTREAM):
            length = struct.unpack_from(">H", fp.read(2))[0]
            fp.seek(length - 2, os.SEEK_CUR)
            _parse_comment(fp)
        return size, mode, palette, False
    except _PASS_ON as e:
        raise probe.PassOn(f"{name}: {e}") from None
    except (OSError, ValueError) as e:
        raise ValueError(f"{name}: PIL refuses the JPEG 2000 header ({e})") from None


# ---------------------------------------------------------------------------
# OpenJPEG's JP2 box reader (jp2.c)

_JP2_BOXES = (b"jP  ", b"ftyp", b"jp2h")
_IMAGE_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


class _Jp2:
    """The state OpenJPEG keeps while it reads a JP2 file's boxes."""

    def __init__(self):
        self.state = set()
        self.ihdr = None  # (h, w, numcomps, bpc)
        self.has_colr = False
        self.meth = self.enumcs = 0
        self.pclr_channels = None
        self.has_cmap = self.has_cdef = False
        self.bodies = {}  # pclr, cmap and cdef boxes as read (OpenJPEG applies them after decoding)

    def box(self, kind: bytes, body: bytes) -> None:
        """One box's handler; a ValueError where it returns false."""
        n = len(body)
        if kind == b"jP  ":
            if self.state:
                raise ValueError("The signature box must be the first box in the file.")
            if n != 4 or body != b"\x0d\x0a\x87\x0a":
                raise ValueError("Error with JP signature Box")
            self.state.add("signature")
        elif kind == b"ftyp":
            if self.state != {"signature"}:
                raise ValueError("The ftyp box must be the second box in the file.")
            if n < 8 or (n - 8) & 3:
                raise ValueError("Error with FTYP signature Box size")
            self.state.add("file_type")
        elif kind == b"jp2h":
            if "file_type" not in self.state:
                raise ValueError("The jp2h box must follow the file type box.")
            has_ihdr, pos = False, 0
            while n - pos > 0:
                left = n - pos
                if left < 8:
                    raise ValueError("Cannot handle box of less than 8 bytes")
                length, sub = struct.unpack_from(">I4s", body, pos)
                hlen = 8
                if length == 1:
                    if left < 16:
                        raise ValueError("Cannot handle XL box of less than 16 bytes")
                    xl, length = struct.unpack_from(">II", body, pos + 8)
                    hlen = 16
                    if xl != 0:
                        raise ValueError("Cannot handle box sizes higher than 2^32")
                    if length == 0:
                        raise ValueError("Cannot handle box of undefined sizes")
                elif length == 0:
                    raise ValueError("Cannot handle box of undefined sizes")
                if length < hlen:
                    raise ValueError("Box length is inconsistent.")
                if length > left:
                    raise ValueError("Stream error while reading JP2 Header box: box length is inconsistent.")
                if sub in _IMAGE_BOXES:
                    self.image_box(sub, body[pos + hlen : pos + length])
                has_ihdr |= sub == b"ihdr"
                pos += length
            if not has_ihdr:
                raise ValueError("Stream error while reading JP2 Header box: no 'ihdr' box.")
            self.state.add("header")
        else:
            self.image_box(kind, body)

    def image_box(self, kind: bytes, body: bytes) -> None:
        n = len(body)
        if kind == b"ihdr":
            if self.ihdr is not None:
                return
            if n != 14:
                raise ValueError("Bad image header box (bad size)")
            h, w, nc, bpc = struct.unpack_from(">IIHB", body)
            if not 1 <= nc <= 16384:
                raise ValueError("Invalid number of components (ihdr)")
            self.ihdr = (h, w, nc, bpc)
        elif kind == b"colr":
            if n < 3:
                raise ValueError("Bad COLR header box (bad size)")
            if self.has_colr:
                return
            self.meth = body[0]
            if self.meth == 1:
                if n < 7:
                    raise ValueError("Bad COLR header box (bad size)")
                self.enumcs = struct.unpack_from(">I", body, 3)[0]
                self.has_colr = True
            elif self.meth == 2:
                self.has_colr = True
        elif kind == b"bpcc":
            if n != (self.ihdr[2] if self.ihdr else 0):
                raise ValueError("Bad BPCC header box (bad size)")
        elif kind == b"pclr":
            if self.pclr_channels is not None or n < 3:
                raise ValueError("Bad PCLR box")
            entries, channels = struct.unpack_from(">HB", body)
            if entries == 0 or entries > 1024:
                raise ValueError(f"Invalid PCLR box. Reports {entries} entries")
            if channels == 0:
                raise ValueError("Invalid PCLR box. Reports 0 palette columns")
            if n < 3 + channels:
                raise ValueError("Bad PCLR box")
            sizes = [min(((b & 0x7F) + 1 + 7) >> 3, 4) for b in body[3 : 3 + channels]]
            if n < 3 + channels + entries * sum(sizes):
                raise ValueError("Bad PCLR box")
            self.pclr_channels = channels
            self.bodies[kind] = body
        elif kind == b"cmap":
            if self.pclr_channels is None:
                raise ValueError("Need to read a PCLR box before the CMAP box.")
            if self.has_cmap:
                raise ValueError("Only one CMAP box is allowed.")
            if n < self.pclr_channels * 4:
                raise ValueError("Insufficient data for CMAP box.")
            self.has_cmap = True
            self.bodies[kind] = body
        elif kind == b"cdef":
            if self.has_cdef:
                raise ValueError("Only one CDEF box is allowed.")
            if n < 2:
                raise ValueError("Insufficient data for CDEF box.")
            count = struct.unpack_from(">H", body)[0]
            if count == 0:
                raise ValueError("Number of channel description is equal to zero in CDEF box.")
            if n < 2 + count * 6:
                raise ValueError("Insufficient data for CDEF box.")
            self.has_cdef = True
            self.bodies[kind] = body

    def read_boxes(self, data: bytes, pos: int) -> int:
        """opj_jp2_read_header_procedure from `pos`: the boxes up to the
        codestream box; returns the position after that box's header (or
        where the boxes end)."""
        while len(data) - pos >= 8:
            length, kind = struct.unpack_from(">I4s", data, pos)
            hlen = 8
            if length == 0:
                length = len(data) - pos  # the last box: the rest of the file
            elif length == 1:
                if len(data) - pos < 16:
                    return len(data)
                xl, length = struct.unpack_from(">II", data, pos + 8)
                hlen = 16
                if xl != 0:
                    raise ValueError("Cannot handle box sizes higher than 2^32")
            if kind == b"jp2c":
                if "header" not in self.state:
                    raise ValueError("bad placed jpeg codestream")
                self.state.add("codestream")
                return pos + hlen
            if length < hlen:
                raise ValueError(f"invalid box size {length}")
            size = length - hlen
            pos += hlen
            known, misplaced = kind in _JP2_BOXES, kind in _IMAGE_BOXES
            if known or misplaced:
                if not known and "header" not in self.state:
                    if len(data) - pos < size:
                        raise ValueError("Problem with skipping JPEG2000 box, stream error")
                    pos += size
                    continue
                if size > len(data) - pos:
                    raise ValueError(f"Invalid box size {size} for box {kind!r}")
                self.box(kind, data[pos : pos + size])
                pos += size
            else:
                if "signature" not in self.state:
                    raise ValueError("Malformed JP2 file format: first box must be JPEG 2000 signature box")
                if "file_type" not in self.state:
                    raise ValueError("Malformed JP2 file format: second box must be file type box")
                if len(data) - pos < size:
                    if "codestream" in self.state:
                        return len(data)
                    raise ValueError("Problem with skipping JPEG2000 box, stream error")
                pos += size
        return len(data)


# ---------------------------------------------------------------------------
# The decode

_YCC_TABLES = None


def _ycc_tables() -> np.ndarray:
    """PIL's YCbCr -> RGB tables (ConvertYCbCr.c, 6 fractional bits):
    R_Cr, G_Cb, G_Cr, B_Cb, each k * 64 * (i - 128) + 0.5 truncated toward
    zero (equal to PIL's conversion on all 2**24 inputs)."""
    global _YCC_TABLES
    if _YCC_TABLES is None:
        i = np.arange(256, dtype=np.float64) - 128.0
        tabs = [np.trunc(k * 64.0 * i + 0.5) for k in (1.402, -0.34414, -0.71414, 1.772)]
        _YCC_TABLES = np.concatenate(tabs).astype(np.int16)
    return _YCC_TABLES


def _layout(mode: str, w: int, h: int) -> np.ndarray:
    """PIL's image memory for the mode: one byte per pixel for "L" / "P",
    two for "I;16", four for the rest."""
    if mode in ("L", "P"):
        return np.zeros((h, w), np.uint8)
    if mode == "I;16":
        return np.zeros((h, w), np.uint16)
    return np.zeros((h, w, 4), np.uint8)


def _as_pil_array(buf: np.ndarray, mode: str) -> np.ndarray:
    if mode in ("LA", "PA"):
        return buf[..., [0, 3]].copy()
    if mode == "RGB":
        return buf[..., :3].copy()
    return buf


def read_pil(data: bytes, name: str) -> tuple:
    """A JPEG 2000 file as PIL opens it: (array, mode, palette table or
    None)."""
    (w, h), mode, palette, raw = _pil_open(data, name)
    codec.check_size(max(w, 0), max(h, 0), name)
    try:
        if raw:
            start, jp2 = 0, None
        else:
            jp2 = _Jp2()
            start = jp2.read_boxes(data, 0)
            if "header" not in jp2.state:
                raise ValueError("JP2H box missing. Required.")
            if jp2.ihdr is None:
                raise ValueError("IHDR box_missing. Required.")
        cs = codec.J2kCodestream(memoryview(data)[start:], (jp2.ihdr[1], jp2.ihdr[0]) if jp2 else (0, 0))
        try:
            x0, y0, x1, y1, numcomps = cs.image
            # a colour space PIL does not know (none, ICC, Lab, any other
            # enumeration) is taken as unspecified, as PIL's decoder does
            space = 0 if jp2 is None else _ENUMCS.get(jp2.enumcs, 0)
            if numcomps < 1 or numcomps > 4:
                raise ValueError(f"PIL's decoder refuses {numcomps} components")
            sub = [c for c in range(numcomps) if (cs.comps[c, 2:] != 1).any()]
            if space == 0:  # PIL's guess: gray; sRGB, or sYCC when the first subsampled component is 1 or 2
                space = _GRAY if numcomps <= 2 else _SYCC if sub and sub[0] in (1, 2) else _SRGB
            kind = _UNPACKERS.get((mode, space, numcomps))
            if kind is None or (sub and kind < 5):  # only the three- and four-component unpackers subsample
                raise ValueError(f"PIL has no unpacker for mode {mode} from {numcomps} components")
            if w <= 0 or h <= 0:
                raise ValueError(f"PIL's image of {w}x{h} pixels")
            buf = _layout(mode, w, h)
            end = start + cs.decode(kind, buf, w, h, _ycc_tables())
        finally:
            cs.close()
        if jp2 is not None:
            jp2.read_boxes(data, end)  # opj_jp2_end_decompress reads the boxes after the codestream
    except ValueError as e:
        raise ValueError(f"{name}: JPEG 2000 image is broken ({e})") from None
    return _as_pil_array(buf, mode), mode, None if palette is None else palette.table()
