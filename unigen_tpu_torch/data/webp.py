"""WebP -> uint8 [H, W, 3], the pixels of PIL's ``Image.open(b).convert("RGB")``.

Pillow opens every WebP through libwebp's ``WebPAnimDecoder``: the RIFF
container is parsed by the demuxer (``demux/demux.c``), which fails the file
if it is truncated (shorter than its RIFF size), if a chunk does not fit,
if a "VP8 " / "VP8L" header is invalid, or if the layout is not one of
libwebp's three (a single "VP8 " or "VP8L" image; VP8X, then an optional
ALPH before a "VP8 " image; VP8X with ANIM and ANMF frames inside the
canvas). Frame 0 is then decoded into a zeroed RGBA canvas at its offset, as
a key frame (no blending), and Pillow drops the alpha. This module walks the
container as the demuxer does; the bitstreams are decoded by the port's C++
(``csrc/webp_lossy.cpp``: VP8 with libwebp's fancy upsampling and YUV ->
RGB; ``csrc/webp_lossless.cpp``: VP8L and the ALPH plane). An ALPH plane is
decoded too, though ``convert("RGB")`` drops it: a broken one fails the image
in libwebp. RGB under alpha 0 stays as coded.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .errors import CorruptImage
from .native import webp_alpha_decode, webp_vp8_decode, webp_vp8l_decode

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
# VP8X flags
ANIMATION, XMP, EXIF, ALPHA, ICCP = 0x02, 0x04, 0x08, 0x10, 0x20
VALID_FLAGS = ANIMATION | XMP | EXIF | ALPHA | ICCP


class _Frame:
    """A frame of the demuxer: its offsets, size and bitstream chunks."""

    def __init__(self):
        self.x = self.y = 0
        self.width = self.height = 0
        self.image: Optional[Tuple[bytes, bytes]] = None    # (fourcc, payload)
        self.alpha: Optional[bytes] = None
        self.image_offset = self.alpha_offset = -1


def _le24(b: bytes, i: int) -> int:
    return b[i] | (b[i + 1] << 8) | (b[i + 2] << 16)


def _bitstream_size(fourcc: bytes, payload: bytes, declared: int) -> Tuple[int, int]:
    """WebPGetFeatures on an image chunk: its (width, height), or raise."""
    if fourcc == b"VP8 ":
        if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
            raise CorruptImage("WebP: bad VP8 frame header")
        bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
        w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
        h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
        if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= declared \
                or not w or not h:
            raise CorruptImage("WebP: bad VP8 frame header")
        return w, h
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise CorruptImage("WebP: bad VP8L header")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


class _Demux:
    """libwebp's demuxer on complete data (``WebPDemux``, no partial files)."""

    def __init__(self, data: bytes):
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise CorruptImage("not a WebP file")
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise CorruptImage("WebP: bad RIFF size")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise CorruptImage("WebP: truncated file (shorter than its RIFF size)")
        self.buf = data[:self.end]
        self.pos = 12
        self.flags = 0
        self.ext = False
        self.canvas = (0, 0)
        self.frames: List[_Frame] = []
        tag = self.buf[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
        elif tag == b"VP8X":
            self._vp8x()
        else:
            raise CorruptImage(f"WebP: first chunk {tag!r}")
        self._validate()

    def _need(self, n: int):
        if n > self.end - self.pos:
            raise CorruptImage("WebP: a chunk runs past the end of the file")

    def _chunk_header(self) -> Tuple[bytes, int, int]:
        self._need(8)
        fourcc = self.buf[self.pos:self.pos + 4]
        size = struct.unpack_from("<I", self.buf, self.pos + 4)[0]
        if size > MAX_CHUNK_PAYLOAD:
            raise CorruptImage("WebP: bad chunk size")
        self.pos += 8
        return fourcc, size, size + (size & 1)

    def _store_frame(self, frame: _Frame, min_size: int = 0):
        """StoreFrame: an optional ALPH, then one image chunk."""
        if self.end - self.pos < max(8, min_size):
            raise CorruptImage("WebP: truncated frame")
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            fourcc, size, padded = self._chunk_header()
            self._need(padded)
            payload = self.buf[self.pos:self.pos + padded]
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha, frame.alpha_offset = payload[:size], start
                self.pos += padded
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks:
                    raise CorruptImage("WebP: ALPH before a VP8L image")
                frame.width, frame.height = _bitstream_size(fourcc, payload, size)
                frame.image, frame.image_offset = (fourcc, payload), start
                image_chunks = 1
                self.pos += padded
            else:
                self.pos = start
                return
            if self.pos == self.end:
                return
            self._need(8)

    def _single_image(self):
        if self.frames:
            raise CorruptImage("WebP: a second image")
        frame = _Frame()
        self._store_frame(frame)
        if not self.flags & ALPHA:
            frame.alpha = None
        if not self.ext:
            self.canvas = (frame.width, frame.height)
        self.frames.append(frame)

    def _vp8x(self):
        self.ext = True
        self._need(8)
        self.pos += 4
        size = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise CorruptImage("WebP: bad VP8X chunk")
        size += size & 1
        self._need(size)
        self.flags = self.buf[self.pos]
        self.canvas = (1 + _le24(self.buf, self.pos + 4), 1 + _le24(self.buf, self.pos + 7))
        if self.canvas[0] * self.canvas[1] >= 1 << 32:
            raise CorruptImage("WebP: canvas too large")
        self.pos += size
        self._need(8)
        anim_chunks = 0
        animation = bool(self.flags & ANIMATION)
        while True:
            start = self.pos
            fourcc, size, padded = self._chunk_header()
            self._need(padded)
            if fourcc == b"VP8X":
                raise CorruptImage("WebP: a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise CorruptImage("WebP: a still image in an animation")
                self.pos = start
                self._single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    raise CorruptImage("WebP: bad ANIM chunk")
                anim_chunks += 1
                self.pos += padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise CorruptImage("WebP: ANMF before ANIM")
                self._animation_frame(padded, animation)
            else:
                self.pos += padded
            if self.pos == self.end:
                return
            self._need(8)

    def _animation_frame(self, chunk_size: int, animation: bool):
        if chunk_size < 16:
            raise CorruptImage("WebP: bad ANMF chunk")
        self._need(chunk_size)
        b, p = self.buf, self.pos
        frame = _Frame()
        frame.x, frame.y = 2 * _le24(b, p), 2 * _le24(b, p + 3)
        w, h = 1 + _le24(b, p + 6), 1 + _le24(b, p + 9)
        if w * h >= 1 << 32:
            raise CorruptImage("WebP: frame too large")
        self.pos += 16
        start = self.pos
        self._store_frame(frame, chunk_size - 16)
        if self.pos - start > chunk_size - 16:
            raise CorruptImage("WebP: frame data past its ANMF chunk")
        if animation and (frame.image is not None or frame.alpha is not None):
            self.frames.append(frame)

    def _validate(self):
        cw, ch = self.canvas
        if cw <= 0 or ch <= 0 or not self.frames:
            raise CorruptImage("WebP: no image")
        if self.ext and self.flags & ~VALID_FLAGS:
            raise CorruptImage("WebP: invalid VP8X flags")
        animation = bool(self.flags & ANIMATION)
        for i, f in enumerate(self.frames):
            if f.image is None:
                raise CorruptImage("WebP: a frame without an image")
            if f.alpha is not None and f.alpha_offset > f.image_offset:
                raise CorruptImage("WebP: ALPH after its image")
            if f.width <= 0 or f.height <= 0:
                raise CorruptImage("WebP: empty frame")
            if self.ext and not animation:
                if (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
                    raise CorruptImage("WebP: image size differs from the canvas")
            elif self.ext and (f.x + f.width > cw or f.y + f.height > ch):
                raise CorruptImage("WebP: frame outside the canvas")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 3] (frame 0 on its canvas; see the module's
    docstring); raises ``CorruptImage`` where PIL raises."""
    demux = _Demux(data)
    cw, ch = demux.canvas
    frame = demux.frames[0]
    fourcc, payload = frame.image
    if fourcc == b"VP8L":
        rgb = webp_vp8l_decode(payload, frame.width, frame.height)[:, :, :3]
    else:
        rgb = webp_vp8_decode(payload, frame.width, frame.height)
        if frame.alpha is not None:
            webp_alpha_decode(frame.alpha, frame.width, frame.height)
    if (frame.x, frame.y, frame.width, frame.height) == (0, 0, cw, ch):
        return np.ascontiguousarray(rgb)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = rgb
    return canvas
