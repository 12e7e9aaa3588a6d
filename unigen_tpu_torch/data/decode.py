"""Image bytes -> uint8 [H, W, 3] RGB, the pixels of PIL's
``Image.open(b).convert("RGB")``, without PIL.

The JAX loaders open every image with PIL and convert it to RGB; the card's
machine has no PIL and the port imports none. ``decode_image`` sniffs the
format from the magic bytes and gives the same pixels from the port's own
decoders, bit for bit:

* JPEG by the native library (``native.jpeg_decode``, C++ that follows
  libjpeg-turbo as PIL runs it: the ISLOW IDCT, fancy upsampling, its
  YCbCr, CMYK and YCCK conversions): baseline, extended and progressive. It
  raises where PIL raises (a truncated file, a broken marker, a stream
  without tables). Where the entropy data is corrupt and libjpeg only warns
  (a bad Huffman code, a flipped byte), it returns pixels as PIL does, but
  those pixels may differ from PIL's.
* PNG: the chunks with ``struct``, the IDAT stream with ``zlib``, the five
  row filters reversed by the native library (``native.png_unfilter``;
  ``png_unfilter_numpy`` is the same arithmetic in numpy, the tests'
  reference), Adam7 passes put in place, then grey, grey + alpha, RGB, RGBA
  and palette pixels at every bit depth to RGB as PIL's ``convert("RGB")``
  does: alpha dropped, grey repeated, low bit depths scaled to 0-255,
  16-bit samples cut to their high byte (16-bit grey, PIL's ``I;16``,
  clipped at 255 instead).
* WebP (``data/webp.py``: the RIFF container as libwebp's demuxer walks it;
  VP8, VP8L and ALPH by ``csrc/webp_lossy.cpp`` and ``webp_lossless.cpp``),
  frame 0 of an animation on its canvas.
* GIF (``csrc/gif.cpp``: frame 0, PIL's LZW) and BMP (``csrc/bmp.cpp``:
  every header and pixel format PIL reads, RLE8 / RLE4 included).
* PBM, PGM and PPM, binary and plain (``data/pnm.py``).
* Baseline TIFF (``data/tiff.py``: IFD 0, strips or tiles, chunky or planar,
  raw, LZW, PackBits or Deflate, predictor 2; LZW and PackBits by
  ``csrc/tiff.cpp``).

Two kinds of failure, kept apart:

* ``CorruptImage`` (a ``ValueError``): the bytes are no image, or a broken
  one (truncated, a bad chunk, a corrupt stream: what PIL raises on). The
  loaders skip such a sample where JAX's skip it.
* ``UnsupportedImageFormat`` (a ``RuntimeError``): an image PIL reads and
  the port does not decode: JPEG 2000, ICO, QOI, PSD, AVIF and the other
  formats PIL knows by their magic bytes (``OTHER_FORMATS``); arithmetic-coded,
  lossless, hierarchical or 12-bit JPEG; TIFF with a compression other than
  LZW, PackBits or Deflate, predictor 3, YCbCr, CIELab, 12-, 32-bit or float
  samples, BigTIFF; PFM. It names the format, and the loaders let it
  through: a shard of such images must stop a run, not be skipped sample by
  sample. So do they let ``native.NativeLibraryError`` through (the
  decoders' library could not be built or loaded); both are
  ``NOT_A_BAD_SAMPLE``.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from .errors import CorruptImage, UnsupportedImageFormat
from .native import DecodeError, NativeLibraryError, bmp_decode, gif_decode, jpeg_decode, \
    png_unfilter
from .pnm import decode_pnm
from .tiff import decode_tiff
from .webp import decode_webp

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


# what the loaders raise where they skip a bad sample: no sample is at fault
NOT_A_BAD_SAMPLE = (UnsupportedImageFormat, NativeLibraryError)

# formats PIL 12 opens that the port does not decode, by the magic bytes its
# plugins accept (AVIF by the ftyp box's major brand)
OTHER_FORMATS = ((b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000 image"),
                 (b"\xffO\xffQ", "JPEG 2000 codestream"), (b"qoif", "QOI image"),
                 (b"8BPS", "PSD image"), (b"\x00\x00\x01\x00", "ICO image"),
                 (b"\x00\x00\x02\x00", "CUR image"), (b"icns", "ICNS image"),
                 (b"DDS ", "DDS image"), (b"\x59\xa6\x6a\x95", "Sun raster image"),
                 (b"\xb1\x68\xde\x3a", "DCX image"), (b"\x01\xda", "SGI image"),
                 (b"SIMPLE", "FITS image"), (b"BLP1", "BLP image"), (b"BLP2", "BLP image"),
                 (b"/* XPM */", "XPM image"))
FTYP_BRANDS = {b"avif": "AVIF image", b"avis": "AVIF image", b"mif1": "AVIF / HEIF image",
               b"msf1": "AVIF / HEIF image"}


def sniff(data: bytes) -> Optional[str]:
    """The format named by the file's magic bytes, or None."""
    if data.startswith(PNG_MAGIC):
        return "png"
    if data.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if len(data) >= 2 and data[:1] == b"P" and data[1:2] in b"0123456fy":
        return "pnm"
    return None


def _other_format(data: bytes) -> Optional[str]:
    """The name of a format PIL reads and the port does not, or None."""
    for magic, name in OTHER_FORMATS:
        if data.startswith(magic):
            return name
    if len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5):
        return "PCX image"
    if data[4:8] == b"ftyp" and data[8:12] in FTYP_BRANDS:
        return FTYP_BRANDS[data[8:12]]
    return None


DECODERS = {"webp": decode_webp, "pnm": decode_pnm, "tiff": decode_tiff}
NATIVE = {"jpeg": ("JPEG", jpeg_decode), "gif": ("GIF", gif_decode), "bmp": ("BMP", bmp_decode)}


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H, W, 3] RGB. Raises ``CorruptImage`` for a bad
    image and ``UnsupportedImageFormat`` for one the port does not read."""
    fmt = sniff(data)
    if fmt is None:
        other = _other_format(data)
        if other:
            _unsupported(other)
        raise CorruptImage("unrecognised image bytes")
    if fmt in NATIVE:
        name, decode = NATIVE[fmt]
        try:
            return decode(data)
        except DecodeError as e:
            if e.unsupported:
                _unsupported(str(e))
            raise CorruptImage(f"{name}: {e}") from e
    if fmt in DECODERS:
        try:
            return DECODERS[fmt](data)
        except DecodeError as e:
            raise CorruptImage(f"{fmt}: {e}") from e
        except UnsupportedImageFormat as e:
            _unsupported(str(e))
    return decode_png(data)


def _unsupported(what: str):
    raise UnsupportedImageFormat(f"{what}: the port reads JPEG (baseline, extended, "
                                 "progressive), PNG, WebP, GIF, BMP, PBM / PGM / PPM and "
                                 "baseline TIFF (it imports no PIL; its card's machine has "
                                 "none)")


def _chunks(data: bytes):
    """(type, body) of each chunk; the CRCs of the chunks before the first
    IDAT are checked, as PIL checks them."""
    pos, seen_idat = len(PNG_MAGIC), False
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > len(data):
            raise CorruptImage("truncated PNG chunk")
        body = data[pos + 8:pos + 8 + length]
        seen_idat = seen_idat or ctype == b"IDAT"
        if not seen_idat:
            (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
            if zlib.crc32(ctype + body) != crc:
                raise CorruptImage(f"bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (see the module's docstring)."""
    if not data.startswith(PNG_MAGIC):
        raise CorruptImage("not a PNG")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise CorruptImage("bad IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise CorruptImage("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or w == 0 or h == 0 or interlace > 1:
        raise CorruptImage(f"bad PNG header {header}")
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and color not in (0, 3)) or \
            (depth == 16 and color == 3):
        raise CorruptImage(f"bad PNG bit depth {depth} for colour type {color}")
    channels = _CHANNELS[color]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    # each pass's sub-image [ph, pw]; an empty pass has no rows in the stream
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    strides = [(pw * channels * depth + 7) // 8 for _, pw in sizes]
    needed = sum(ph * (st + 1) for (ph, pw), st in zip(sizes, strides) if ph and pw)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"PNG inflate: {e}") from e
    if len(raw) < needed:
        raise CorruptImage("truncated PNG pixels")
    px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for (x0, y0, dx, dy), (ph, pw), stride in zip(passes, sizes, strides):
        if not (ph and pw):
            continue
        size = ph * (stride + 1)
        try:
            rows = png_unfilter(raw[offset:offset + size], ph, stride,
                                max(1, channels * depth // 8))
        except ValueError as e:
            raise CorruptImage(str(e)) from e
        offset += size
        px[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    return _to_rgb(px, depth, color, palette)


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows [H, stride] -> the samples [H, W, channels]: uint8
    (1-8 bits, unscaled) or uint16 (16 bits, big-endian in the stream)."""
    h = rows.shape[0]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(axis=2).astype(np.uint8)[:, :, None]
    if depth == 16:
        return rows[:, :w * channels * 2].view(">u2").reshape(h, w, channels)
    return rows[:, :w * channels].reshape(h, w, channels)


def _to_rgb(px: np.ndarray, depth: int, color: int,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """Samples [H, W, channels] -> uint8 [H, W, 3] as PIL's convert("RGB")."""
    h, w = px.shape[:2]
    if depth == 16:
        # PIL opens 16-bit grey as "I;16" (clipped to 255 on the way to RGB),
        # the other colour types through ";16B" unpackers (the high byte)
        px = np.minimum(px, 255) if color == 0 else px >> 8
        px = px.astype(np.uint8)
    elif depth < 8 and color == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        if palette is None:
            raise CorruptImage("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[:, :, 0]]
    if color in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def png_unfilter_numpy(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The filter reversal in numpy and Python, byte by byte for Average and
    Paeth: the reference of ``native.png_unfilter`` in the tests."""
    src = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        ft, line = int(src[y, 0]), src[y, 1:].astype(np.int64)
        cur = np.zeros(stride, np.int64)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 255
        elif ft in (1, 3, 4):
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + prev[i]) >> 1
                else:
                    b, c = prev[i], prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 255
        else:
            raise ValueError(f"PNG row {y}: filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def read_image(path: str) -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3] RGB (``decode_image``)."""
    with open(path, "rb") as f:
        return decode_image(f.read())
