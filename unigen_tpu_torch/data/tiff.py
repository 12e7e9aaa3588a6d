"""Baseline TIFF -> uint8 [H, W, 3], the pixels of PIL's
``Image.open(b).convert("RGB")``: IFD 0 only.

PIL parses the directory itself (``TiffImagePlugin``): tags of a known type,
a value too long for its entry read from its offset; a tag past the end of
the file stops the directory there; a tag of spec length 1 is its first
value. Its ``_setup`` turns (byte order, photometric interpretation, sample
format, fill order, bits per sample, extra samples) into a mode and a raw
mode through its ``OPEN_INFO`` table; a key outside it is an error. Then:

* uncompressed data goes through PIL's own raw decoder, a tile (or strip)
  at a time from its offset, ``StripByteCounts`` unread; planar data takes
  one letter of the raw mode a plane (PIL's ``rawmode[layer]``); data that
  ends early fails;
* LZW, PackBits and Deflate (8 and 32946) go through libtiff, which reads
  each strip or tile whole (its byte count must lie inside the file),
  decodes it (``csrc/tiff.cpp``: LZW and PackBits as libtiff does; Deflate
  by ``zlib`` up to the bytes it needs), undoes predictor 2 and hands PIL's
  decoder rows in native byte order: 16-bit samples keep their value, PIL's
  unpackers take the high byte; planar 8- and 16-bit data is copied a band
  at a time (PIL's ``_pickUnpackers``), associated alpha then undone.

Modes to RGB as ``convert("RGB")``: 1 and L repeated, 2- and 4-bit grey
scaled by 85 and 17 (min-is-white inverted), 16-bit grey (``I;16``) clipped
at 255, the palette from ``ColorMap`` (its high bytes; an index past it
black), alpha dropped (associated alpha divided out first), CMYK by PIL's
``cmyk2rgb``. The EXIF orientation tag is applied, as PIL's ``load_end``
does for TIFF. What PIL reads and this module does not raises
``UnsupportedImageFormat`` naming it: BigTIFF, the compressions PIL hands to
libtiff beyond these (JPEG, CCITT G3/G4, LZMA, ZSTD, WebP, ...), old-style
LZW, YCbCr, CIELab and 12-, 32-bit or float samples (the floating-point
predictor's data).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .errors import CorruptImage, UnsupportedImageFormat
from .native import (DecodeError, tiff_lzw_decode, tiff_packbits_decode, tiff_to_rgb,
                     tiff_unpredict)

II, MM = b"II", b"MM"
# PIL's TIFF type -> (struct code, size); other types are skipped
TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("LL", 8), 6: ("b", 1),
         7: ("s", 1), 8: ("h", 2), 9: ("l", 4), 10: ("ll", 8), 11: ("f", 4), 12: ("d", 8),
         13: ("L", 4), 16: ("Q", 8)}
INT_TYPES = {1, 3, 4, 6, 8, 9, 13, 16}
# tags of spec length 1 (PIL's TiffTags): their first value
SCALAR_TAGS = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH = 284, 317, 320, 322, 323
TILE_OFFSETS, TILE_COUNTS, EXTRA_SAMPLES, SAMPLE_FORMAT = 324, 325, 338, 339
COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                6: "old-style JPEG", 7: "JPEG", 8: "Deflate", 32771: "raw 16",
                32773: "PackBits", 32809: "ThunderScan", 32946: "Deflate",
                34676: "SGI LogL", 34677: "SGI LogLuv", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP"}
DECODED = {1, 5, 8, 32773, 32946}
MAX_PIXELS = 2 * 89478485      # PIL's decompression-bomb limit


def _open_info() -> Dict[Tuple, Tuple[str, str]]:
    """PIL's ``OPEN_INFO`` for the modes this module converts: (big-endian,
    photometric, sample format, fill order, bits, extra samples) -> (mode,
    raw mode); a 16-bit raw mode's byte order is the file's."""
    t = {}
    for photo, inv in ((0, "I"), (1, "")):
        for fill, rev in ((1, ""), (2, "R")):
            t[(photo, (1,), fill, (1,), ())] = ("1", "1;" + inv + rev if inv or rev else "1")
            for bits in (2, 4):
                t[(photo, (1,), fill, (bits,), ())] = ("L", f"L;{bits}{inv}{rev}")
            t[(photo, (1,), fill, (8,), ())] = ("L", "L;" + inv + rev if inv or rev else "L")
    t[(1, (2,), 1, (8,), ())] = ("L", "L")
    t[(1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    t[(1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    t[(2, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
    t[(2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
    t[(2, (1,), 1, (8, 8, 8, 8), ())] = ("RGBA", "RGBA")
    for extra, mode, raw in (((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                             ((2,), "RGBA", "RGBA"), ((999,), "RGBA", "RGBA")):
        for k in range(3 if extra != (999,) else 1):
            t[(2, (1,), 1, (8,) * (4 + k), extra + (0,) * k)] = (mode, raw + "X" * k)
    t[(2, (1,), 1, (16,) * 3, ())] = ("RGB", "RGB;16")
    t[(2, (1,), 1, (16,) * 4, ())] = ("RGBA", "RGBA;16")
    for extra, mode, raw in (((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"), ((2,), "RGBA", "RGBA")):
        t[(2, (1,), 1, (16,) * 4, extra)] = (mode, raw + ";16")
    for bits in (1, 2, 4):
        t[(3, (1,), 1, (bits,), ())] = ("P", f"P;{bits}")
        t[(3, (1,), 2, (bits,), ())] = ("P", f"P;{bits}R")
    t[(3, (1,), 1, (8,), ())] = ("P", "P")
    t[(3, (1,), 2, (8,), ())] = ("P", "P;R")
    t[(3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    t[(3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    for k in range(3):
        t[(5, (1,), 1, (8,) * (4 + k), (0,) * k)] = ("CMYK", "CMYK" + "X" * k)
    t[(5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16")
    out = {(big,) + k: v for k, v in t.items() for big in (False, True)}
    # little-endian only in PIL: 16-bit min-is-white read as min-is-black,
    # and 16-bit grey in fill order 2
    out[(False, 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    out[(False, 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    return out


OPEN_INFO = _open_info()
# keys PIL reads into modes this module does not convert, by what they hold
# (any byte order unless marked)
OTHER_KEYS = {(False, 1, (1,), 1, (12,), ()): "12-bit grey",
              (None, 1, (2,), 1, (16,), ()): "signed 16-bit grey",
              (False, 1, (1,), 1, (32,), ()): "32-bit grey",
              (None, 1, (2,), 1, (32,), ()): "signed 32-bit grey",
              (None, 0, (3,), 1, (32,), ()): "float samples",
              (None, 1, (3,), 1, (32,), ()): "float samples",
              (None, 6, (1,), 1, (8, 8, 8), ()): "YCbCr",
              (None, 6, (1,), 1, (8,), ()): "YCbCr (grey)",
              (None, 8, (1,), 1, (8, 8, 8), ()): "CIELab"}


_FLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _bitflip(a: np.ndarray) -> np.ndarray:
    """Each byte with its bits reversed (fill order 2)."""
    return _FLIP[a]


class _Directory:
    """IFD 0 as PIL's ``ImageFileDirectory_v2`` loads it."""

    def __init__(self, data: bytes):
        if data[:4] in (b"MM\x00\x2b", b"II\x2b\x00"):
            raise UnsupportedImageFormat("BigTIFF image")
        if len(data) < 8 or data[:2] not in (II, MM):
            raise CorruptImage("not a TIFF file")
        self.big = data[:2] == MM
        self.e = ">" if self.big else "<"
        self.data = data
        (offset,) = struct.unpack(self.e + "L", data[4:8])
        if not offset:
            raise CorruptImage("TIFF: no image")
        self.tags: Dict[int, Tuple[int, tuple]] = {}
        self.entries: Dict[int, Tuple[int, int, bytes]] = {}   # every entry, as libtiff sees it
        self.entries_end = offset + 2
        self._load(offset)

    def _load(self, pos: int):
        d, e = self.data, self.e
        if pos + 2 > len(d):
            return
        (count,) = struct.unpack_from(e + "H", d, pos)
        self.entries_end = pos + 2 + 12 * count   # libtiff reads the directory whole
        pos += 2
        for _ in range(count):
            if pos + 12 > len(d):
                return
            tag, typ, n = struct.unpack_from(e + "HHL", d, pos)
            raw = d[pos + 8:pos + 12]
            pos += 12
            self.entries[tag] = (typ, n, raw)
            if typ not in TYPES:
                continue
            code, unit = TYPES[typ]
            size = n * unit
            if size > 4:
                (at,) = struct.unpack(e + "L", raw)
                raw = d[at:at + size]
                if len(raw) < size:
                    return              # PIL's "Truncated File Read": the directory ends
            else:
                raw = raw[:size]
            if not raw:
                continue
            if typ in (2, 7):
                values: tuple = (raw,)
            else:
                values = struct.unpack(e + code * n, raw)
            self.tags[tag] = (typ, values)

    def get(self, tag: int, default=None):
        if tag not in self.tags:
            return default
        typ, values = self.tags[tag]
        if tag in SCALAR_TAGS or typ == 1 or (len(values) == 1 and tag not in (
                BITS, STRIP_OFFSETS, STRIP_COUNTS, COLORMAP, TILE_OFFSETS, TILE_COUNTS,
                EXTRA_SAMPLES, SAMPLE_FORMAT)):
            return values[0]
        return values

    def ints(self, tag: int, default=None):
        v = self.get(tag, default)
        ok = isinstance(v, int) or (isinstance(v, tuple) and all(isinstance(x, int) for x in v))
        if v is not None and (not ok or (tag in self.tags and self.tags[tag][0] not in INT_TYPES)):
            raise CorruptImage(f"TIFF: tag {tag} is not an integer")
        return v


def _unpack(raw: np.ndarray, rawmode: str, width: int, big: bool) -> np.ndarray:
    """Rows [n, bytes] -> PIL's pixel storage for ``rawmode``: [n, width]
    for 1 / L / P (uint8) and I;16 (int64), else [n, width, 4] uint8 bands."""
    rows = raw.shape[0]
    mode, _, flags = rawmode.partition(";")
    if "R" in flags and not flags.startswith("16"):
        raw = _bitflip(raw)
        flags = flags.replace("R", "")
    if mode in ("1", "L", "P") and flags[:1] in ("", "I", "1", "2", "4") and flags != "16":
        bits = int(flags.rstrip("I") or (1 if mode == "1" else 8))
        if bits < 8:
            v = np.unpackbits(raw, axis=1).reshape(rows, -1, bits)[:, :width]
            v = (v * (1 << np.arange(bits - 1, -1, -1))).sum(axis=2)
        else:
            v = raw[:, :width].astype(np.int64)
        top = (1 << bits) - 1
        if flags.endswith("I"):
            v = top - v
        if mode == "1":
            return np.where(v > 0, 255, 0).astype(np.uint8)
        if mode == "L" and bits < 8:
            return (v * (255 // top)).astype(np.uint8)
        return v.astype(np.uint8)
    if rawmode in ("I;16", "I;16R"):
        raw = _bitflip(raw) if rawmode == "I;16R" else raw
        return np.ascontiguousarray(raw[:, :2 * width]).view(">u2" if big else "<u2").astype(np.int64)
    if rawmode in ("PX", "PA", "LA"):
        px = raw[:, :2 * width].reshape(rows, width, 2)
        out = np.zeros((rows, width, 4), np.uint8)
        out[..., 0] = px[..., 0]
        out[..., 3] = px[..., 1]
        return out[..., 0] if rawmode == "PX" else out
    sixteen = flags == "16"
    size = 2 if sixteen else 1
    nbytes = len(mode) * size
    px = raw[:, :nbytes * width].reshape(rows, width, len(mode), size)
    # 16-bit samples: the high byte, in the file's order
    px = px[..., 0 if big else size - 1] if sixteen else px[..., 0]
    out = np.zeros((rows, width, 4), np.uint8)
    out[..., :min(4, len(mode))] = px[..., :4]
    if mode.startswith("RGBa"):
        out = np.concatenate([tiff_to_rgb(out, 1), out[..., 3:]], axis=2)
    return out


class _Image:
    """PIL's image of ``mode`` and its conversion to RGB."""

    def __init__(self, mode: str, h: int, w: int, palette: Optional[np.ndarray]):
        self.mode, self.palette = mode, palette
        if mode in ("1", "L", "P"):
            self.px = np.zeros((h, w), np.uint8)
        elif mode == "I;16":
            self.px = np.zeros((h, w), np.int64)
        else:
            self.px = np.zeros((h, w, 4), np.uint8)

    def rgb(self) -> np.ndarray:
        px, mode = self.px, self.mode
        if mode == "I;16":
            px = np.minimum(px, 255).astype(np.uint8)
        if mode in ("1", "L", "I;16"):
            return np.repeat(px[..., None], 3, axis=2)
        if mode == "LA":
            return np.repeat(px[..., :1], 3, axis=2)
        if mode in ("P", "PA"):
            idx = px if mode == "P" else px[..., 0]
            full = np.zeros((256, 3), np.uint8)
            full[:len(self.palette)] = self.palette[:256]
            return full[idx]
        if mode == "CMYK":
            return tiff_to_rgb(px, 0)
        return np.ascontiguousarray(px[..., :3])


def _orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose for orientations 2-8."""
    t = lambda a: a.transpose(1, 0, 2)  # noqa: E731
    return {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
            5: t, 6: lambda a: t(a)[:, ::-1], 7: lambda a: t(a[::-1, ::-1]),
            8: lambda a: t(a)[::-1]}.get(orientation, lambda a: a)(rgb)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 3] (see the module's docstring)."""
    ifd = _Directory(data)
    if 0xBC01 in ifd.tags:
        raise CorruptImage("TIFF: Windows Media Photo")
    compression = ifd.ints(COMPRESSION, 1)
    if compression not in COMPRESSIONS:
        raise CorruptImage(f"TIFF: unknown compression {compression}")
    planar = ifd.ints(PLANAR, 1)
    photo = ifd.ints(PHOTOMETRIC, 0)
    if compression == 6:
        photo = 6
    fill = ifd.ints(FILLORDER, 1)
    w, h = ifd.ints(WIDTH), ifd.ints(LENGTH)
    if not isinstance(w, int) or not isinstance(h, int):
        raise CorruptImage("TIFF: missing or invalid dimensions")
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise CorruptImage(f"TIFF: size {w}x{h}")
    sample_format = ifd.ints(SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = ifd.ints(BITS, (1,))
    extra = ifd.ints(EXTRA_SAMPLES, ())
    if not isinstance(bps, tuple) or not isinstance(extra, tuple) \
            or not isinstance(sample_format, tuple):
        raise CorruptImage("TIFF: bad sample tags")
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = ifd.ints(SAMPLES, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise CorruptImage("TIFF: invalid samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise CorruptImage("TIFF: unknown data organization")
    key = (ifd.big, photo, sample_format, fill, bps, extra)
    if key not in OPEN_INFO:
        what = OTHER_KEYS.get(key) or OTHER_KEYS.get((None,) + key[1:])
        if what:
            raise UnsupportedImageFormat(f"TIFF {what}")
        raise CorruptImage(f"TIFF: unknown pixel mode {key[1:]}")
    if compression not in DECODED:
        raise UnsupportedImageFormat(f"TIFF with {COMPRESSIONS[compression]} compression")
    mode, rawmode = OPEN_INFO[key]
    # libtiff runs the predictor for the codecs that register it (LZW,
    # Deflate), not for raw data or PackBits, as it reads the tag (an entry
    # it cannot read as one integer is ignored); float data never gets here
    predictor = _libtiff_scalar(ifd, PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise CorruptImage(f"TIFF: predictor {predictor} (libtiff: not supported here)")
    palette = None
    if mode in ("P", "PA"):
        cmap = ifd.ints(COLORMAP)
        if not isinstance(cmap, tuple):
            raise CorruptImage("TIFF: palette image without ColorMap")
        third = len(cmap) // 3
        palette = (np.asarray(cmap[:3 * third], np.int64) // 256).astype(np.uint8)
        palette = palette.reshape(3, third).T
    img = _Image(mode, h, w, palette)
    args = dict(ifd=ifd, img=img, rawmode=rawmode, bps=bps, bps_count=bps_count, planar=planar,
                w=w, h=h)
    if compression == 1:
        _read_raw(data, **args)
    else:
        _read_libtiff(data, compression=compression, predictor=predictor, fill=fill, key=key,
                      extra=extra, **args)
    return np.ascontiguousarray(_orient(img.rgb(), ifd.get(ORIENTATION)))


def _raw_bits(rawmode: str) -> int:
    mode, _, flags = rawmode.partition(";")
    if flags.startswith("16"):
        return 16 * len(mode)
    if mode in ("1", "L", "P"):
        digits = flags.strip("IR")
        return int(digits) if digits else (1 if mode == "1" else 8)
    return 8 * len(mode)


def _place(img: _Image, px: np.ndarray, x0: int, y0: int, band: Optional[int] = None):
    rows, width = px.shape[:2]
    if band is None:
        img.px[y0:y0 + rows, x0:x0 + width] = px
    elif img.px.ndim == 3:
        img.px[y0:y0 + rows, x0:x0 + width, band] = px if px.ndim == 2 else px[..., 0]
    else:
        img.px[y0:y0 + rows, x0:x0 + width] = px if px.ndim == 2 else px[..., 0]


BAND_OF = {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3}
# PIL's raw decoder has no unpacker for these (mode, raw mode) pairs; a plane
# of a planar image takes one letter of the raw mode, which must be a band
# of the mode
NO_UNPACKER = {("L", "L;IR"), ("P", "P;1R"), ("P", "P;2R"), ("P", "P;4R")}
PLANE_LETTERS = {"1": "1", "L": "L", "P": "PL", "I;16": "", "LA": "", "PA": "", "RGB": "RGB",
                 "RGBA": "RGBA", "CMYK": "CMYK"}


def _read_raw(data, ifd, img, rawmode, bps, bps_count, planar, w, h):
    """PIL's tiles for uncompressed data, read by its raw decoder."""
    if ifd.get(STRIP_OFFSETS) is not None:
        offsets = ifd.ints(STRIP_OFFSETS)
        th, tw = ifd.ints(ROWS_PER_STRIP, h), w
    elif ifd.get(TILE_OFFSETS) is not None:
        offsets = ifd.ints(TILE_OFFSETS)
        tw, th = ifd.ints(TILE_WIDTH), ifd.ints(TILE_LENGTH)
        if not isinstance(tw, int) or not isinstance(th, int):
            raise CorruptImage("TIFF: invalid tile dimensions")
    else:
        raise CorruptImage("TIFF: no strip or tile offsets")
    offsets = offsets if isinstance(offsets, tuple) else (offsets,)
    if tw == w and th == h and planar != 2:
        offsets = offsets[-1:]
    x = y = layer = 0
    for offset in offsets:
        stride = int(tw * sum(bps) / 8) if x + tw > w else 0
        tile_rawmode = rawmode
        if planar == 2:
            if layer >= len(rawmode):
                raise CorruptImage("TIFF: more planes than bands")
            tile_rawmode = rawmode[layer]
            stride = int(stride / bps_count)
            if tile_rawmode not in PLANE_LETTERS[img.mode]:
                raise CorruptImage(f"TIFF: unknown raw mode {tile_rawmode!r} for a plane")
        elif (img.mode, tile_rawmode) in NO_UNPACKER:
            raise CorruptImage(f"TIFF: unknown raw mode {tile_rawmode!r}")
        x1, y1 = min(x + tw, w), min(y + th, h)
        if x1 <= x or y1 <= y:
            raise CorruptImage("TIFF: tile cannot extend outside image")
        ext_w, rows = x1 - x, y1 - y
        nbytes = (ext_w * _raw_bits(tile_rawmode) + 7) // 8
        step = stride if stride else nbytes
        if step < nbytes:
            raise CorruptImage("TIFF: raw stride shorter than a row")
        need = (rows - 1) * step + nbytes
        if offset + need > len(data):
            raise CorruptImage("TIFF: image file is truncated")
        buf = np.frombuffer(data, np.uint8, count=need, offset=offset)
        if step != nbytes:
            buf = np.lib.stride_tricks.as_strided(buf, (rows, nbytes), (step, 1))
        buf = np.ascontiguousarray(buf).reshape(rows, nbytes)
        if len(tile_rawmode) == 1 and img.px.ndim == 3:
            _place(img, buf[:, :ext_w], x, y, BAND_OF[tile_rawmode])
        else:
            _place(img, _unpack(buf, tile_rawmode, ext_w, ifd.big), x, y)
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1


# libtiff's TIFFReadDirectory fails where the directory's entries run past the
# end of the file, where one of these tags will not read as a single unsigned
# integer (PlanarConfiguration 1 or 2), or ExtraSamples as at most
# SamplesPerPixel values of 0-2 (999, Corel's, read as 2)
LIBTIFF_SCALARS = (WIDTH, LENGTH, ROWS_PER_STRIP, PLANAR, TILE_WIDTH, TILE_LENGTH)
LIBTIFF_ARRAY_TYPES = {1, 3, 4, 6, 8, 9, 13, 16}


def _libtiff_directory_checks(ifd: _Directory, spp: int):
    if ifd.entries_end > len(ifd.data):
        raise CorruptImage("TIFF: libtiff cannot read the directory (past the end of the file)")
    for tag in LIBTIFF_SCALARS + (EXTRA_SAMPLES, STRIP_OFFSETS, STRIP_COUNTS, TILE_OFFSETS,
                                  TILE_COUNTS):
        if tag not in ifd.entries:
            continue
        typ, n, _ = ifd.entries[tag]
        if typ not in LIBTIFF_ARRAY_TYPES or (tag in LIBTIFF_SCALARS and n != 1):
            raise CorruptImage(f"TIFF: libtiff cannot read tag {tag} (type {typ}, count {n})")
        values = ifd.tags.get(tag, (typ, ()))[1]
        if any(v < 0 for v in values):
            raise CorruptImage(f"TIFF: negative value in tag {tag}")
        if tag == PLANAR and values and values[0] not in (1, 2):
            raise CorruptImage(f"TIFF: bad PlanarConfiguration {values[0]}")
        if tag == EXTRA_SAMPLES and (n > spp or any(v > 2 and v != 999 for v in values)):
            raise CorruptImage("TIFF: bad ExtraSamples")


def _libtiff_scalar(ifd: _Directory, tag: int, default: int) -> int:
    """A one-value tag as libtiff reads it: ``default`` where the entry is
    missing or not one integer (libtiff ignores such a tag)."""
    if tag not in ifd.entries:
        return default
    typ, count, raw = ifd.entries[tag]
    if count != 1 or typ not in LIBTIFF_ARRAY_TYPES - {16}:
        return default
    code = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L"}[typ]
    return struct.unpack_from(ifd.e + code, raw)[0]


def _libtiff_array(ifd: _Directory, tag: int, n: int):
    """The first ``n`` values of an offsets or byte-counts tag as libtiff
    reads them from the directory entry (its own read, whatever PIL's
    parser kept), or None without the tag."""
    if tag not in ifd.entries:
        return None
    typ, count, raw = ifd.entries[tag]
    code, unit = {1: ("B", 1), 3: ("H", 2), 4: ("L", 4), 6: ("b", 1), 8: ("h", 2),
                  9: ("l", 4), 13: ("L", 4), 16: ("Q", 8)}[typ]
    take = min(count, n)
    if count * unit > 4:
        (at,) = struct.unpack(ifd.e + "L", raw)
        raw = ifd.data[at:at + take * unit]
        if len(raw) < take * unit:
            raise CorruptImage(f"TIFF: libtiff cannot read tag {tag} (past the end of the file)")
    return struct.unpack(ifd.e + code * take, raw[:take * unit])


def _codec(data: bytes, compression: int, size: int) -> np.ndarray:
    try:
        if compression == 5:
            return tiff_lzw_decode(data, size)
        if compression == 32773:
            return tiff_packbits_decode(data, size)
    except DecodeError as e:
        if e.unsupported:
            raise UnsupportedImageFormat(str(e)) from None
        raise CorruptImage(str(e)) from None
    d = zlib.decompressobj()
    try:
        out = d.decompress(data, size)
    except zlib.error as e:
        raise CorruptImage(f"TIFF Deflate: {e}") from None
    if len(out) < size:
        raise CorruptImage("TIFF Deflate: not enough data")
    return np.frombuffer(out, np.uint8).copy()


def _read_libtiff(data, ifd, img, rawmode, bps, bps_count, planar, w, h, compression, predictor,
                  fill, key, extra):
    """libtiff's strips or tiles, as PIL's TiffDecode.c reads them."""
    _libtiff_directory_checks(ifd, len(bps))
    tiled = TILE_OFFSETS in ifd.entries and STRIP_OFFSETS not in ifd.entries
    if fill == 2:
        rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]][1]
    spp = len(bps)
    sample_bits = bps[0]
    planes_in_file = spp if planar == 2 else 1

    def row_size(width):  # TIFFScanlineSize / TIFFTileRowSize
        return (width * sample_bits * (1 if planar == 2 else spp) + 7) // 8
    if planar == 2 and img.px.ndim == 3:
        if sample_bits not in (8, 16):
            raise CorruptImage("TIFF: planar data of neither 8 nor 16 bits")
        bands = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[img.mode]
        unpackers = [("band", b) for b in range(bands)]
    else:
        unpackers = [("rows", None)]
    if tiled:
        tw, th = ifd.ints(TILE_WIDTH), ifd.ints(TILE_LENGTH)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 or th <= 0:
            raise CorruptImage("TIFF: invalid tile dimensions")
    else:
        rps = ifd.ints(ROWS_PER_STRIP, 0xFFFFFFFF)
        if rps == 0:
            raise CorruptImage("TIFF: zero rows per strip")
        if rps != 0xFFFFFFFF and rps * row_size(w) > 0x7FFFFFFF:
            raise CorruptImage("TIFF: strip too large")
        tw, th = w, min(h, rps)
    across, down = -(-w // tw), -(-h // th)
    row_bytes = row_size(tw)
    if not tiled and (tw * _raw_bits(rawmode) // len(unpackers) + 7) // 8 > row_bytes:
        raise CorruptImage("TIFF: the unpacker needs more bytes than a row holds")
    n = across * down * planes_in_file
    offsets = _libtiff_array(ifd, TILE_OFFSETS if tiled else STRIP_OFFSETS, n)
    if offsets is None:
        raise CorruptImage("TIFF: no strip or tile offsets")
    counts = _libtiff_array(ifd, TILE_COUNTS if tiled else STRIP_COUNTS, n)
    if len(offsets) < n:
        raise CorruptImage("TIFF: too few strip or tile offsets")
    file_order_big = ifd.big
    for plane, (kind, band) in enumerate(unpackers):
        for ty in range(down):
            for tx in range(across):
                index = (plane * down + ty) * across + tx
                rows = th if tiled else min(th, h - ty * th)
                offset = offsets[index]
                end = offset + counts[index] if counts is not None and index < len(counts) \
                    else len(data)
                if counts is not None and (index >= len(counts) or counts[index] == 0):
                    raise CorruptImage("TIFF: invalid strip byte count")
                if end > len(data) or offset > len(data):
                    raise CorruptImage("TIFF: strip or tile past the end of the file")
                chunk = data[offset:end]
                if fill == 2:
                    chunk = _bitflip(np.frombuffer(chunk, np.uint8)).tobytes()
                buf = _codec(chunk, compression, rows * row_bytes)
                if predictor == 2:
                    if sample_bits not in (8, 16):
                        raise CorruptImage("TIFF: predictor 2 on samples of neither 8 nor 16 bits")
                    tiff_unpredict(buf, rows, row_bytes, 1 if planar == 2 else spp, sample_bits,
                                   file_order_big)
                x0, y0 = tx * tw, ty * th
                cw, ch = min(tw, w - x0), min(rows, h - y0)
                buf = buf.reshape(rows, row_bytes)[:ch]
                if kind == "band":
                    v = buf[:, :cw * sample_bits // 8]
                    if sample_bits == 16:
                        v = v.reshape(ch, cw, 2)[..., 0 if file_order_big else 1]
                        if band == 3:      # PIL's "A" unpacker reads 8-bit samples
                            v = buf[:, :cw]
                    _place(img, v, x0, y0, band)
                else:
                    _place(img, _unpack(buf, rawmode, cw, file_order_big), x0, y0)
    if planar == 2 and img.mode == "RGBA" and extra[:1] == (1,):
        img.px[...] = np.concatenate([tiff_to_rgb(img.px, 1), img.px[..., 3:]], axis=2)
