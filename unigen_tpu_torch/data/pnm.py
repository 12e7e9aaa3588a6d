"""PBM, PGM and PPM (P1-P6) -> uint8 [H, W, 3], as PIL's PpmImagePlugin
reads them and ``convert("RGB")`` converts them.

The header: the magic (up to 6 bytes, ended by whitespace), then width,
height and (but for PBM) maxval as tokens of at most 10 bytes, with ``#``
comments running to the end of their line, even inside a token; the raster
starts one byte after the last token. ``0 < maxval < 65536``.

The raster, as PIL decodes it:

* binary PBM (P4): rows of packed bits, 1 black; plain PBM (P1): the digits
  0 and 1, whitespace optional, any other byte an error (PIL checks every
  byte of each 1 MiB block it reads);
* binary PGM / PPM (P5 / P6) at maxval 255: the bytes; P5 at maxval 65535:
  big-endian samples clipped to 255 (PIL's mode ``I``); any other maxval:
  one byte a sample below 256, two (big-endian) from 256, each scaled to
  ``round(v / maxval * M)`` and capped at M, M being 255, or 65535 for a PGM
  whose maxval is above 255 (mode ``I``, clipped to 255 on the way to RGB);
* plain PGM / PPM (P2 / P3): whitespace-separated decimal tokens, a value
  above maxval or below 0 an error, scaled as above.

A raster shorter than the image is an error, as it is in PIL; bytes after
it are ignored. Grey is repeated into three channels.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .errors import CorruptImage, UnsupportedImageFormat

WHITESPACE = b" \t\n\x0b\x0c\r"
SAFEBLOCK = 1024 * 1024       # PIL's plain decoders read the raster in blocks of this
# magics PIL reads that are not P1-P6: PFM and PIL's own test formats
OTHER_MAGICS = {b"Pf": "PFM (float) image", b"P0CMYK": "CMYK PNM image",
                b"PyP": "PIL palette PNM image", b"PyRGBA": "PIL RGBA PNM image",
                b"PyCMYK": "PIL CMYK PNM image"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> int:
        """The next byte, or -1 at the end."""
        if self.pos >= len(self.data):
            return -1
        self.pos += 1
        return self.data[self.pos - 1]

    def magic(self) -> bytes:
        out = bytearray()
        for _ in range(6):
            c = self.byte()
            if c < 0 or c in WHITESPACE:
                break
            out.append(c)
        return bytes(out)

    def token(self) -> bytes:
        tok = bytearray()
        while len(tok) <= 10:
            c = self.byte()
            if c < 0:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == ord("#"):
                while self.byte() not in (-1, 10, 13):
                    pass
                continue
            tok.append(c)
        if not tok:
            raise CorruptImage("PNM: end of data in the header")
        if len(tok) > 10:
            raise CorruptImage(f"PNM: header token too long: {bytes(tok)!r}")
        return bytes(tok)

    def number(self) -> int:
        tok = self.token()
        try:
            return int(tok)
        except ValueError:
            raise CorruptImage(f"PNM: bad header token {tok!r}") from None

    def block(self) -> bytes:
        out = self.data[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(out)
        return out


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _strip_comments(reader: _Reader, block: bytes, spans: bool) -> Tuple[bytes, bool]:
    """PIL's ``PpmPlainDecoder._ignore_comments``: the block without its
    comments, and whether a comment runs on into the next block."""
    if spans:
        while block:
            end = _comment_end(block)
            if end != -1:
                block = block[end + 1:]
                break
            block = reader.block()
    while True:
        start = block.find(b"#")
        if start == -1:
            return block, False
        end = _comment_end(block, start)
        if end == -1:
            return block[:start], True
        block = block[:start] + block[end + 1:]


def _plain_bits(reader: _Reader, count: int) -> np.ndarray:
    data, spans = bytearray(), False
    while len(data) != count:
        block = reader.block()
        if not block:
            break
        block, spans = _strip_comments(reader, block, spans)
        tokens = b"".join(block.split())
        if tokens.strip(b"01"):
            bad = next(c for c in tokens if c not in (48, 49))
            raise CorruptImage(f"PBM: invalid token {bytes([bad])!r}")
        data = (data + tokens)[:count]
    if len(data) < count:
        raise CorruptImage("PBM: not enough image data")
    return np.where(np.frombuffer(bytes(data), np.uint8) == 48, 255, 0).astype(np.uint8)


def _plain_values(reader: _Reader, count: int, maxval: int, out_max: int) -> np.ndarray:
    values, spans, half = [], False, b""
    while len(values) != count:
        block = reader.block()
        if not block:
            if not half:
                break
            block = b" "
        block, spans = _strip_comments(reader, block, spans)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise CorruptImage(f"PNM: token too long in the data: {half[:11]!r}")
        for token in tokens:
            if len(token) > 10:
                raise CorruptImage(f"PNM: token too long in the data: {token[:11]!r}")
            try:
                value = int(token)
            except ValueError:
                raise CorruptImage(f"PNM: bad token {token!r}") from None
            if value < 0 or value > maxval:
                raise CorruptImage(f"PNM: value {value} outside 0-{maxval}")
            values.append(value)
            if len(values) == count:
                break
    if len(values) < count:
        raise CorruptImage("PNM: not enough image data")
    return _scale(np.asarray(values, np.float64), maxval, out_max)


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max), half to even as Python's round, capped."""
    return np.minimum(np.rint(v / maxval * out_max), out_max).astype(np.int64)


def decode_pnm(data: bytes) -> np.ndarray:
    """P1-P6 bytes -> uint8 [H, W, 3] (see the module's docstring)."""
    reader = _Reader(data)
    magic = reader.magic()
    if magic in OTHER_MAGICS:
        raise UnsupportedImageFormat(OTHER_MAGICS[magic])
    if len(magic) != 2 or magic[:1] != b"P" or magic[1:] not in b"123456":
        raise CorruptImage(f"not a PNM file (magic {magic!r})")
    kind = magic[1] - ord("0")
    w, h = reader.number(), reader.number()
    if w <= 0 or h <= 0:
        raise CorruptImage(f"PNM: size {w}x{h}")
    bands = 3 if kind in (3, 6) else 1
    count = w * h * bands
    if kind in (1, 4):
        if kind == 1:
            px = _plain_bits(reader, w * h).reshape(h, w)
        else:
            stride = (w + 7) // 8
            raw = data[reader.pos:reader.pos + stride * h]
            if len(raw) < stride * h:
                raise CorruptImage("PBM: image file is truncated")
            bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride), axis=1)
            px = np.where(bits[:, :w] == 1, 0, 255).astype(np.uint8)
        return np.repeat(px[:, :, None], 3, axis=2)
    maxval = reader.number()
    if not 0 < maxval < 65536:
        raise CorruptImage(f"PNM: maxval {maxval}")
    # PIL opens a PGM above maxval 255 as mode I, scaled to 16 bits, which
    # convert("RGB") clips to 255
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    if kind in (2, 3):
        px = _plain_values(reader, count, maxval, out_max)
    else:
        size = 1 if maxval < 256 else 2
        raw = data[reader.pos:reader.pos + count * size]
        if len(raw) < count * size:
            raise CorruptImage("PNM: image file is truncated")
        v = np.frombuffer(raw, np.uint8 if size == 1 else ">u2").astype(np.int64)
        if maxval == 255 or (maxval == 65535 and bands == 1):
            px = v
        else:
            px = _scale(v.astype(np.float64), maxval, out_max)
    px = np.minimum(px, 255).astype(np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(np.broadcast_to(px, (h, w, 3))) if bands == 1 else px
