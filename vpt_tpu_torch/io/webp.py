"""WebP decoding (the RIFF container, the first frame) to what PIL opens.

PIL reads every WebP file through libwebp's demuxer and `WebPAnimDecoder`
in MODE_RGBA; this module parses the container as that demuxer parses it
and decodes the first frame's bitstreams with the port's C decoders
(io/codec.py: csrc/webpdec.c's VP8L and VP8 decoders and the ALPH plane):

- the simple `VP8 ` and `VP8L` files and the extended `VP8X` one; `ICCP`,
  `EXIF`, `XMP `, a second `ANIM` and unknown chunks are skipped;
- the mode is PIL's sniff, libwebp's WebPGetFeatures of the whole file:
  "RGBA" when the `VP8X` alpha flag is set (for a still `VP8L` image, its
  header's alpha_is_used bit instead), when an `ALPH` chunk comes before
  a still image, or when the sniff fails; else "RGB", the decoded alpha
  dropped.  The headers decide, not the pixels; and a still `VP8X` file
  without the alpha flag has its `ALPH` chunk ignored (alpha 255);
- an animation's first frame only: the canvas is zero-filled (0, 0, 0, 0)
  and the frame written at its offset without blending; the `ANIM`
  background colour touches no pixel;
- alpha is not premultiplied.

The refusals are the demuxer's and the decoders': a chunk size past the
RIFF data, a RIFF size past the file, a frame off its canvas, a still image
whose size is not its canvas's, bitstreams that end early or hold what no
encoder writes, and PIL's decompression-bomb limit.  Each raises a
ValueError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
_VALID_FLAGS = 0x3E  # alpha, animation, ICC, EXIF, XMP
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32
_FIRST_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")  # PIL opens a RIFF / WEBP file that begins with one of these


class _Refused(Exception):
    """The demuxer's parse error."""


class _Short(_Refused):
    """A bitstream too short for its header."""


def _image_header(kind: bytes, body: bytes, declared: int) -> tuple:
    """(width, height, alpha_is_used) of a VP8L or VP8 bitstream (`declared`:
    its chunk's size), with libwebp's VP8LGetInfo / VP8GetInfo checks: a VP8
    stream must be a shown key frame whose first partition is shorter than
    its chunk."""
    if kind == b"VP8L":
        if len(body) < 5:
            raise _Short("VP8L header cut short")
        if body[0] != 0x2F or body[4] >> 5:
            raise _Refused("bad VP8L header")
        bits = int.from_bytes(body[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)
    if len(body) < 10:
        raise _Short("VP8 frame header cut short")
    tag = body[0] | body[1] << 8 | body[2] << 16
    w, h = (body[6] | body[7] << 8) & 0x3FFF, (body[8] | body[9] << 8) & 0x3FFF
    if body[3:6] != b"\x9d\x01\x2a" or tag & 1 or (tag >> 1) & 7 > 3 or not (tag >> 4) & 1 or tag >> 5 >= declared:
        raise _Refused("a VP8 frame that is no shown key frame, or its first partition larger than its chunk")
    if not w or not h:
        raise _Refused("a VP8 frame of zero size")
    return w, h, False


class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.number = 0
        self.complete = False
        self.image = (0, 0)  # (offset of the chunk header, its size with the padded payload)
        self.alpha = (0, 0)


class _Demuxer:
    """libwebp's demuxer over a whole file (never partial)."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 20:
            raise _Refused("the file is shorter than a RIFF header and a chunk header")
        if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _Refused("no RIFF / WEBP header")
        riff_size = self.le32(4)
        if riff_size < 8 or riff_size > _MAX_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused(f"the RIFF chunk's {self.riff_end} bytes are cut at {len(data)}")
        self.end = self.riff_end
        self.start = 12
        self.flags = 0
        self.extended = False
        self.canvas = (0, 0)
        self.frames: list[_Frame] = []
        first = data[12:16]
        if first == b"VP8X":
            self.parse_vp8x()
            self.check_extended()
        elif first in (b"VP8 ", b"VP8L"):
            self.parse_single()
            self.check_simple()
        else:
            raise _Refused(f"first chunk {first!r}")

    def le32(self, at: int) -> int:
        return struct.unpack_from("<I", self.data, at)[0]

    def le24(self, at: int) -> int:
        return int.from_bytes(self.data[at : at + 3], "little")

    def left(self) -> int:
        return self.end - self.start

    def too_big(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def need_header(self) -> None:
        """After a chunk that does not end the RIFF data: another chunk header."""
        if self.left() < 8:
            raise _Refused("the RIFF data ends inside a chunk header")

    def features(self, at: int, size: int) -> tuple:
        """(width, height) of the VP8 / VP8L chunk at `at` (`size` bytes with
        its header), with WebPGetFeatures' checks."""
        kind = self.data[at : at + 4]
        if size < 12:
            raise _Refused(f"{kind!r} chunk of {size - 8} bytes")
        return _image_header(kind, self.data[at + 8 : at + size], self.le32(at + 4))[:2]

    def store_frame(self, number: int, min_size: int, frame: _Frame) -> None:
        """The ALPH and VP8 / VP8L chunks of one frame (libwebp's StoreFrame)."""
        if self.left() < 8 or self.left() < min_size:
            raise _Refused("the RIFF data ends before a frame")
        alpha_chunks = image_chunks = 0
        while True:
            at = self.start
            kind, size = self.data[at : at + 4], self.le32(at + 4)
            self.start += 8
            if size > _MAX_PAYLOAD:
                raise _Refused(f"chunk {kind!r} of {size} bytes")
            padded = size + (size & 1)
            if self.too_big(padded):
                raise _Refused(f"chunk {kind!r} of {size} bytes runs past the RIFF data")
            if kind == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                frame.alpha = (at, 8 + padded)
                frame.number = number
                self.start += padded
            elif kind in (b"VP8 ", b"VP8L") and not image_chunks:
                if kind == b"VP8L" and alpha_chunks:
                    raise _Refused("an ALPH chunk before a VP8L one")
                frame.width, frame.height = self.features(at, 8 + padded)
                image_chunks = 1
                frame.image = (at, 8 + padded)
                frame.number = number
                frame.complete = True
                self.start += padded
            else:
                self.start = at
                return
            if self.start == self.riff_end:
                return
            self.need_header()

    def parse_single(self) -> None:
        if self.frames:
            raise _Refused("a second image")
        if self.too_big(8) or self.left() < 8:
            raise _Refused("the RIFF data ends before the image")
        frame = _Frame()
        self.store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG:  # a still image's ALPH chunk counts only under the VP8X alpha flag
            frame.alpha = (0, 0)
        if not self.extended and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
        self.frames.append(frame)

    def parse_vp8x(self) -> None:
        self.extended = True
        size = self.le32(self.start + 4)
        self.start += 8
        if size != 10:
            raise _Refused(f"VP8X chunk of {size} bytes")
        size += size & 1
        if self.too_big(size) or self.left() < size:
            raise _Refused("the VP8X chunk runs past the RIFF data")
        self.flags = self.data[self.start]
        self.canvas = (1 + self.le24(self.start + 4), 1 + self.le24(self.start + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_AREA:
            raise _Refused(f"canvas of {self.canvas[0]}x{self.canvas[1]}")
        self.start += size
        if self.too_big(8) or self.left() < 8:
            raise _Refused("the RIFF data ends after the VP8X chunk")
        animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            at = self.start
            kind, size = self.data[at : at + 4], self.le32(at + 4)
            self.start += 8
            if size > _MAX_PAYLOAD:
                raise _Refused(f"chunk {kind!r} of {size} bytes")
            padded = size + (size & 1)
            if self.too_big(padded):
                raise _Refused(f"chunk {kind!r} of {size} bytes runs past the RIFF data")
            if kind == b"VP8X":
                raise _Refused("a second VP8X chunk")
            if kind in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise _Refused(f"a {kind!r} chunk outside the frames of an animation")
                self.start = at
                self.parse_single()
            elif kind == b"ANIM":  # the first gives the background and loop count, which touch no pixel
                if padded < 6 or self.left() < padded:
                    raise _Refused(f"ANIM chunk of {size} bytes")
                anim_chunks = 1
                self.start += padded
            elif kind == b"ANMF":
                if not anim_chunks:
                    raise _Refused("an ANMF chunk before the ANIM chunk")
                self.parse_frame(padded)
            else:  # ICCP, EXIF, XMP and unknown chunks
                if padded > self.left():
                    raise _Refused(f"chunk {kind!r} runs past the RIFF data")
                self.start += padded
            if self.start == self.riff_end:
                return
            self.need_header()

    def parse_frame(self, padded: int) -> None:
        """An ANMF chunk (libwebp's ParseAnimationFrame)."""
        if self.too_big(16) or padded < 16 or self.left() < 16:
            raise _Refused("ANMF chunk shorter than its header")
        frame = _Frame()
        at = self.start
        frame.x, frame.y = 2 * self.le24(at), 2 * self.le24(at + 3)
        frame.width, frame.height = 1 + self.le24(at + 6), 1 + self.le24(at + 9)
        self.start += 16
        if frame.width * frame.height >= _MAX_AREA:
            raise _Refused(f"frame of {frame.width}x{frame.height}")
        start = self.start
        self.store_frame(len(self.frames) + 1, padded - 16, frame)
        if self.start - start > padded - 16:
            raise _Refused("a frame's chunks run past its ANMF chunk")
        if self.flags & ANIMATION_FLAG and frame.number > 0:
            if self.frames and not self.frames[-1].complete:
                raise _Refused("a frame after an incomplete one")
            self.frames.append(frame)

    def check_simple(self) -> None:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise _Refused("no image")

    def check_extended(self) -> None:
        animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise _Refused("no image")
        if self.flags & ~_VALID_FLAGS:
            raise _Refused(f"VP8X flags {self.flags:#x}")
        for f in self.frames:
            if not animation and f.number > 1:
                raise _Refused("a second image")
            if not f.complete:
                raise _Refused("a frame without its image")
            if f.alpha[1] and f.alpha[0] > f.image[0]:
                raise _Refused("an ALPH chunk after its image")
            if f.width <= 0 or f.height <= 0:
                raise _Refused("a frame of zero size")
            cw, ch = self.canvas
            if not animation and (f.x or f.y or f.width != cw or f.height != ch):
                raise _Refused(f"image of {f.width}x{f.height} on a canvas of {cw}x{ch}")
            if animation and (f.x + f.width > cw or f.y + f.height > ch):
                raise _Refused(f"frame of {f.width}x{f.height} at ({f.x}, {f.y}) off a canvas of {cw}x{ch}")


def _decode_frame(data: bytes, frame: _Frame, canvas: np.ndarray) -> None:
    """The frame's bitstreams into the canvas at its offset (WebPDecode of
    the demuxer's payload: the ALPH chunk, if any, then the image chunk)."""
    at, size = frame.image
    kind, payload = data[at : at + 4], data[at + 8 : at + size]  # the padding byte included, as libwebp reads it
    out = canvas[frame.y : frame.y + frame.height, frame.x : frame.x + frame.width]
    if kind == b"VP8L":
        codec.vp8l_decode(payload, frame.width, frame.height, out)
        return
    codec.vp8_decode(payload, frame.width, frame.height, out)
    if frame.alpha[1]:
        a_at = frame.alpha[0]
        a_size = struct.unpack_from("<I", data, a_at + 4)[0]
        out[..., 3] = codec.webp_alpha(data[a_at + 8 : a_at + 8 + a_size], frame.width, frame.height)


def _has_alpha(data: bytes) -> bool:
    """PIL's mode sniff, libwebp's WebPGetFeatures on the whole file: the
    VP8X alpha flag (for a still file replaced by a VP8L header's
    alpha_is_used bit), or an ALPH chunk before the image chunk.  Where
    WebPGetFeatures fails, True: PIL keeps "RGBA"."""
    le32 = lambda at: struct.unpack_from("<I", data, at)[0]  # noqa: E731
    n, riff_size = len(data), le32(4)
    if riff_size < 12 or riff_size > _MAX_PAYLOAD or n < 20:
        return True
    pos, flags, vp8x = 12, 0, data[12:16] == b"VP8X"
    if vp8x:
        if le32(16) != 10 or n < 30:
            return True
        flags = le32(20)
        w, h = 1 + int.from_bytes(data[24:27], "little"), 1 + int.from_bytes(data[27:30], "little")
        if w * h >= _MAX_AREA:
            return True
        pos = 30
    alpha, alph = bool(flags & ALPHA_FLAG), False
    short = alpha if vp8x else True  # the answer where the data ends early: the VP8X one, else a failure
    if vp8x and flags & ANIMATION_FLAG:
        return alpha
    if vp8x:  # the chunks before the image
        total = 4 + 8 + 10
        while True:
            if n - pos < 8:
                return alpha or alph
            size = le32(pos + 4)
            if size > _MAX_PAYLOAD:
                return True
            disk = (8 + size + 1) & ~1
            total = (total + disk) & 0xFFFFFFFF
            if total > riff_size:
                return True
            if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                return alpha or alph
            alph |= data[pos : pos + 4] == b"ALPH"
            pos += disk
        short = alpha or alph
    if n - pos < 8:
        return short
    kind, size = data[pos : pos + 4], le32(pos + 4)
    if kind not in (b"VP8 ", b"VP8L") or size > riff_size - 12:
        return True  # no image chunk (a raw bitstream never follows a RIFF header), or a size past the RIFF data
    try:
        width, height, alpha_is_used = _image_header(kind, data[pos + 8 :], size)
    except _Short:
        return short
    except _Refused:
        return True
    if kind == b"VP8L":
        alpha = alpha_is_used
    if vp8x and (width, height) != (w, h):
        return True
    return alpha or alph


def read_pil(data: bytes, name: str = "image") -> tuple:
    """The first frame as PIL opens it: ((H, W, 4) uint8 RGBA and mode
    "RGBA", or (H, W, 3) uint8 and mode "RGB")."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or data[12:16] not in _FIRST_CHUNKS:
        raise ValueError(f"{name} is not a WebP file PIL opens")
    try:
        dmux = _Demuxer(data)
    except _Refused as e:
        raise ValueError(f"{name}: WebP file refused: {e}") from None
    w, h = dmux.canvas
    codec.check_size(w, h, name)
    canvas = np.zeros((h, w, 4), np.uint8)
    try:
        _decode_frame(data, dmux.frames[0], canvas)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if _has_alpha(data):
        return canvas, "RGBA"
    return np.ascontiguousarray(canvas[..., :3]), "RGB"
