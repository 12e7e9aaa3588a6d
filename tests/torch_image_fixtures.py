"""The WebP, GIF, BMP, PNM and TIFF fixtures of the port's tests and
``chip_smoke.py``'s ``images`` phase, and the byte writers the tests make
cases PIL will not write with.

``unigen_tpu_torch/data/assets/images/`` holds files written once with PIL
from seed 0 (the smooth synthetic images of ``torch_jpeg_fixtures``, at the
sizes and settings of web caption shards, LLaVA folders, DPO pairs and
ImageNet) and ``fixtures.json``: each file's shape, PIL mode, save options,
use, byte count and the sha256 of PIL's ``Image.open(f).convert("RGB")``
pixels. PIL's WebP writer sets only quality and method, so four VP8 files
(the simple loop filter, sharpness 7, eight token partitions, no filter) are
written by the libwebp that PIL bundles, through its advanced encoder API
(``libwebp_encode``). The card's machine has no PIL: the phase holds the
port's decoders to these hashes. Rewrite them (PIL needed) with

    python tests/torch_image_fixtures.py
"""
import io
import json
import os
import struct
import zlib

import numpy as np

from torch_jpeg_fixtures import pixel_sha256, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "unigen_tpu_torch", "data", "assets", "images")

# name: (height, width, PIL mode, format, save options, what it stands for)
FIXTURES = {
    "web_640x480_q80.webp": (480, 640, "RGB", "WEBP", dict(quality=80), "web t2i"),
    "web_500x333_q30_m6.webp": (333, 500, "RGB", "WEBP", dict(quality=30, method=6), "web t2i"),
    "web_301x203_lossless.webp": (203, 301, "RGB", "WEBP", dict(lossless=True), "web t2i"),
    "web_257x129_palette.webp": (129, 257, "P", "WEBP", dict(lossless=True, method=6),
                                 "DPO pairs (lossless)"),
    "web_161x97_alpha.webp": (97, 161, "RGBA", "WEBP", dict(quality=75), "web t2i"),
    "web_120x90_animated.webp": (90, 120, "RGB", "WEBP", dict(quality=70, save_all=True),
                                 "coverage: frame 0 of an animation"),
    "web_1x1.webp": (1, 1, "RGB", "WEBP", dict(quality=90), "coverage"),
    "web_161x97_simple_filter.webp": (97, 161, "RGB", "libwebp", dict(
        filter_type=0, filter_strength=60), "coverage: the simple loop filter"),
    "web_161x97_sharpness7.webp": (97, 161, "RGB", "libwebp", dict(
        filter_type=1, filter_strength=100, filter_sharpness=7), "coverage: sharpness"),
    "web_161x97_8_partitions.webp": (97, 161, "RGB", "libwebp", dict(
        partitions=3, segments=1), "coverage: token partitions"),
    "web_161x97_no_filter.webp": (97, 161, "RGB", "libwebp", dict(
        filter_strength=0, autofilter=0, quality=40.0), "coverage: no loop filter"),
    "ocrvqa_300x450.gif": (450, 300, "P", "GIF", dict(), "LLaVA (OCR-VQA: a GIF named .jpg)"),
    "web_199x131_interlaced.gif": (131, 199, "P", "GIF", dict(interlace=True), "coverage"),
    "scan_320x240_8bit.bmp": (240, 320, "P", "BMP", dict(), "LLaVA folder"),
    "scan_161x97_24bit.bmp": (97, 161, "RGB", "BMP", dict(), "LLaVA folder"),
    "imagenet_200x150.ppm": (150, 200, "RGB", "PPM", dict(), "ImageNet / LLaVA folder"),
    "imagenet_200x150.pgm": (150, 200, "L", "PPM", dict(), "ImageNet"),
    "scan_321x241_lzw_predictor.tif": (241, 321, "RGB", "TIFF", dict(
        compression="tiff_lzw", tiffinfo={317: 2}), "LLaVA folder"),
    "scan_200x160_deflate_predictor.tif": (160, 200, "RGB", "TIFF", dict(
        compression="tiff_adobe_deflate", tiffinfo={317: 2}), "ImageNet"),
}


def fixture_image(h, w, mode, seed):
    """The PIL image a fixture is written from."""
    from PIL import Image
    rgb = synthetic(h, w, seed)
    if mode == "RGBA":
        alpha = np.clip(synthetic(h, w, seed + 100)[:, :, 0].astype(np.int64) * 2 - 128, 0, 255)
        return Image.fromarray(np.dstack([rgb, alpha.astype(np.uint8)]))
    img = Image.fromarray(rgb)
    if mode == "P":
        return img.quantize(64)
    return img.convert(mode) if mode != "RGB" else img


def write_fixtures(directory=FIXTURE_DIR):
    from PIL import Image
    os.makedirs(directory, exist_ok=True)
    index = {}
    for seed, (name, (h, w, mode, fmt, opts, use)) in enumerate(sorted(FIXTURES.items())):
        img = fixture_image(h, w, mode, seed)
        kw = dict(opts)
        if kw.get("save_all"):
            kw["append_images"] = [fixture_image(h, w, mode, seed + 50 + k) for k in range(2)]
        if fmt == "libwebp":
            data = libwebp_encode(np.asarray(img), **opts)
        else:
            buf = io.BytesIO()
            img.save(buf, format=fmt, **kw)
            data = buf.getvalue()
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        index[name] = {"shape": list(rgb.shape), "sha256": pixel_sha256(rgb), "mode": mode,
                       "format": "WEBP" if fmt == "libwebp" else fmt,
                       "writer": "libwebp's advanced API (PIL's wheel)" if fmt == "libwebp"
                       else "PIL", "options": {k: v for k, v in opts.items()
                                                  if k != "tiffinfo"} | (
                           {"predictor": 2} if "tiffinfo" in opts else {}),
                       "use": use, "bytes": len(data)}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")
    return index


def libwebp_encode(rgb, **config):
    """Lossy WebP of uint8 [h, w, 3] by the libwebp in PIL's wheel, through
    its advanced API (``WebPConfig`` fields by name; quality 75 and the
    default preset otherwise)."""
    import ctypes
    import glob
    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*"))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*"))[0])
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class Config(ctypes.Structure):   # encode.h's WebPConfig
        _fields_ = [(n, f if n in ("quality", "target_PSNR") else i) for n in (
            "lossless quality method image_hint target_size target_PSNR segments sns_strength "
            "filter_strength filter_sharpness filter_type autofilter alpha_compression "
            "alpha_filtering alpha_quality pass_ show_compressed preprocessing partitions "
            "partition_limit emulate_jpeg_size thread_level low_memory near_lossless exact "
            "use_delta_palette use_sharp_yuv qmin qmax").split()] + [("pad", ctypes.c_uint32 * 16)]

    class Picture(ctypes.Structure):  # encode.h's WebPPicture
        _fields_ = [("use_argb", i), ("colorspace", i), ("width", i), ("height", i), ("y", p),
                    ("u", p), ("v", p), ("y_stride", i), ("uv_stride", i), ("a", p),
                    ("a_stride", i), ("pad1", ctypes.c_uint32 * 2), ("argb", p),
                    ("argb_stride", i), ("pad2", ctypes.c_uint32 * 3), ("writer", p),
                    ("custom_ptr", p), ("extra_info_type", i), ("extra_info", p), ("stats", p),
                    ("error_code", i), ("progress_hook", p), ("user_data", p),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", p), ("pad5", p),
                    ("pad6", ctypes.c_uint32 * 8), ("memory_", p), ("memory_argb_", p),
                    ("pad7", p * 2)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]
    cfg, pic, mem = Config(), Picture(), Writer()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, f(75.0), 0x0210)
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)) and lib.WebPPictureInitInternal(
        ctypes.byref(pic), 0x0210)
    h, w = rgb.shape[:2]
    pic.width, pic.height = w, h
    arr = np.ascontiguousarray(rgb, np.uint8)
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), arr.ctypes.data_as(p), w * 3)
    lib.WebPMemoryWriterInit(ctypes.byref(mem))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, p)
    pic.custom_ptr = ctypes.cast(ctypes.byref(mem), p)
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    data = ctypes.string_at(mem.mem, mem.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(mem))
    assert ok, pic.error_code
    return data


# -------------------------------------------------------------- writers --

def gif_lzw(indices, min_size, clear_at_full=False, early_end=False):
    """GIF LZW sub-blocks of ``indices`` (LSB-first codes); the code width
    grows after entry 2^n is added (no early change). Past 4,096 entries it
    sends 12-bit codes and adds none (a deferred clear) unless
    ``clear_at_full``; ``early_end`` stops the stream halfway."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    bits, nbits = [], min_size + 1

    def emit(code):
        bits.extend((code >> i) & 1 for i in range(nbits))
    table, nxt = {bytes([i]): i for i in range(clear)}, end + 1
    emit(clear)
    data = bytes(int(v) for v in indices)
    w = b""
    for c in data[:len(data) // 2 if early_end else len(data)]:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if nxt < 4096:
            table[wc], nxt = nxt, nxt + 1
            if nxt == (1 << nbits) + 1 and nbits < 12:
                nbits += 1
        elif clear_at_full:
            emit(clear)
            table, nxt, nbits = {bytes([i]): i for i in range(clear)}, end + 1, min_size + 1
        w = bytes([c])
    if w:
        emit(table[w])
    emit(end)
    bits += [0] * (-len(bits) % 8)
    raw = np.packbits(np.array(bits, np.uint8).reshape(-1, 8)[:, ::-1]).tobytes()
    return b"".join(bytes([len(raw[i:i + 255])]) + raw[i:i + 255]
                    for i in range(0, len(raw), 255)) + b"\x00"


def _color_table(palette):
    n = len(palette)
    bits = max(1, int(np.ceil(np.log2(n))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:n] = palette
    return bits, table.tobytes()


def gif_bytes(indices, screen=None, offset=(0, 0), global_palette=None, local_palette=None,
              transparency=None, background=0, interlace=False, min_size=8, lzw=None,
              trailer=True, extensions=b""):
    """A GIF89a of one image of palette ``indices`` [h, w] at ``offset`` on a
    ``screen`` (w, h), with the tables, graphic control extension and LZW
    data asked for."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if global_palette is not None:
        bits, table = _color_table(global_palette)
        out += bytes([0x80 | (bits - 1), background, 0]) + table
    else:
        out += bytes([0, background, 0])
    out += extensions
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\x00"
    flags, table = 0x40 if interlace else 0, b""
    if local_palette is not None:
        bits, table = _color_table(local_palette)
        flags |= 0x80 | (bits - 1)
    out += b"," + struct.pack("<HHHH", offset[0], offset[1], w, h) + bytes([flags]) + table
    rows = indices
    if interlace:
        rows = indices[list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
                       + list(range(1, h, 2))]
    out += bytes([min_size]) + (lzw if lzw is not None else gif_lzw(rows.reshape(-1), min_size))
    return bytes(out) + (b";" if trailer else b"")


def bmp_bytes(pixels, bits, header=40, palette=None, compression=0, masks=None, colors=None,
              top_down=False, raw=None, size=None):
    """A BMP of ``pixels`` ([h, w] indices, 16- or 32-bit words, or [h, w, 3]
    RGB) packed bottom-up (top-down with ``top_down``) at ``bits``, or of
    ``raw`` pixel data (RLE) for an image of ``size`` (w, h)."""
    if raw is None:
        h, w = pixels.shape[:2]
        stride = ((w * bits + 31) >> 3) & ~3
        rows = []
        for r in (pixels if top_down else pixels[::-1]):
            if bits in (1, 4):
                b = np.packbits(((r[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                                .astype(np.uint8).reshape(-1)).tobytes()
            elif bits == 8:
                b = r.astype(np.uint8).tobytes()
            elif bits == 16:
                b = r.astype("<u2").tobytes()
            elif bits == 24:
                b = r[:, ::-1].astype(np.uint8).tobytes()
            else:
                b = r.astype("<u4").tobytes()
            rows.append(b.ljust(stride, b"\x00"))
        raw = b"".join(rows)
    else:
        w, h = size
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([c[2], c[1], c[0]]) + (b"" if header == 12 else b"\x00")
                       for c in np.asarray(palette, np.uint8))
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        n = (len(palette) if palette is not None else 0) if colors is None else colors
        hdr = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                          len(raw), 2835, 2835, n, 0)
        if header >= 52:
            m = list(masks or (0, 0, 0)) + [0] * 4
            hdr += struct.pack("<4I", *m[:4])[:16 if header >= 56 else 12]
        hdr = hdr.ljust(header, b"\x00")
        if header == 40 and compression == 3:
            hdr += struct.pack("<3I", *masks[:3])
    off = 14 + len(hdr) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(raw), 0, 0, off) + hdr + pal + raw


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, widening one code earlier than GIF's
    encoder, a clear before the table fills)."""
    bits, nbits = [], 9

    def emit(code):
        bits.extend((code >> i) & 1 for i in range(nbits - 1, -1, -1))
    table, nxt = {bytes([i]): i for i in range(256)}, 258
    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc], nxt = nxt, nxt + 1
        if nxt == (1 << nbits) and nbits < 12:
            nbits += 1
        if nxt >= 4093:
            emit(256)
            table, nxt, nbits = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt == (1 << nbits) and nbits < 12:
            nbits += 1
    emit(257)
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8)).tobytes()


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 255, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_FLIP = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _pack_rows(samples, bits, big):
    rows, w, s = samples.shape
    flat = samples.reshape(rows, w * s)
    if bits == 8:
        return flat.astype(np.uint8)
    if bits == 16:
        return flat.astype(">u2" if big else "<u2").view(np.uint8).reshape(rows, -1)
    b = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8).reshape(rows, -1)
    return np.packbits(b, axis=1)


def tiff_bytes(samples, photometric, bits, *, big=False, compression=1, predictor=1, planar=1,
               tile=None, rows_per_strip=None, extra=(), colormap=None, orientation=None,
               fill_order=1):
    """A baseline TIFF of ``samples`` [h, w, spp]: strips (``rows_per_strip``)
    or tiles (``tile`` = (w, h)), chunky or planar, little- or big-endian,
    raw / LZW / Deflate / PackBits, predictor 2, extra samples, a colour map,
    an orientation and a fill order as asked."""
    h, w, s = samples.shape
    e = ">" if big else "<"
    tw, th = tile if tile else (w, rows_per_strip or h)
    chunks = []
    for plane in ([samples[..., i:i + 1] for i in range(s)] if planar == 2 else [samples]):
        for y in range(0, h, th):
            for x in range(0, w, tw):
                if tile:
                    blk = np.zeros((th, tw, plane.shape[2]), np.int64)
                    part = plane[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                else:
                    blk = plane[y:y + th].astype(np.int64)
                if predictor == 2:
                    blk[:, 1:] = (blk[:, 1:] - blk[:, :-1]) % (1 << bits)
                raw = _pack_rows(blk, bits, big).tobytes()
                raw = {5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress,
                       32773: packbits}.get(compression, lambda b: b)(raw)
                if fill_order == 2:      # the stored bytes, as libtiff reverses them
                    raw = _FLIP[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    out = bytearray(b"MM\x00\x2a" if big else b"II\x2a\x00") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c + (b"\x00" if len(c) % 2 else b"")
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [s]), 284: (3, [planar])}
    for tag, value, on in ((317, predictor, predictor != 1), (266, fill_order, fill_order != 1),
                           (274, orientation, bool(orientation))):
        if on:
            tags[tag] = (3, [value])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(colormap))
    counts = [len(c) for c in chunks]
    if tile:
        tags.update({322: (4, [tw]), 323: (4, [th]), 324: (4, offsets), 325: (4, counts)})
    else:
        tags.update({273: (4, offsets), 278: (4, [th]), 279: (4, counts)})
    ifd_at = len(out)
    data_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, ext = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        payload = struct.pack(e + {3: "H", 4: "L"}[typ] * len(vals), *vals)
        entries += struct.pack(e + "HHL", tag, typ, len(vals))
        if len(payload) <= 4:
            entries += payload.ljust(4, b"\x00")
        else:
            entries += struct.pack(e + "L", data_at + len(ext))
            ext += payload + (b"\x00" if len(payload) % 2 else b"")
    out += struct.pack(e + "H", len(tags)) + entries + bytes(4) + ext
    out[4:8] = struct.pack(e + "L", ifd_at)
    return bytes(out)


if __name__ == "__main__":
    idx = write_fixtures()
    print(f"{len(idx)} fixtures, {sum(v['bytes'] for v in idx.values())} bytes in {FIXTURE_DIR}")
