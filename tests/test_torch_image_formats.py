"""The port's WebP, GIF, BMP, PNM and TIFF decoders against PIL, bit for bit.

``unigen_tpu_torch/data/decode.py::decode_image`` must give the pixels of
PIL's ``Image.open(b).convert("RGB")`` on everything the JAX loaders read:
WebP (lossy at every quality and method, lossless with and without a
palette, alpha, frame 0 of an animation, a first frame smaller than its
canvas), GIF (every LZW code size, interlace, a small first frame over the
background or transparency index, local and grey tables, the deferred
clear, an early end code), BMP (every header, 1 to 32 bits, bit fields,
RLE8 / RLE4 with PIL's delta and end-of-bitmap behaviour), PNM (P1-P6,
comments, maxvals 1 to 65535) and baseline TIFF (strips and tiles, chunky
and planar, both byte orders, raw / LZW / Deflate / PackBits, predictor 2,
every photometric interpretation PIL converts, fill order, orientation).
Truncated and corrupted files are decided as PIL decides them: seeded byte
flips and cuts of each format, the decision (and the pixels where both
decode) compared. Cases PIL will not write are built by
``torch_image_fixtures``. Then the committed fixtures against their JSON,
what PIL reads and the port does not (``UnsupportedImageFormat`` naming it),
and JAX's four loaders against the port's on these formats.
"""
import io
import json
import os
import struct
import tarfile
import warnings

import numpy as np
import pytest
from PIL import Image as PIL

from unigen_tpu.data import dpo_data as J_dpo
from unigen_tpu.data import imagenet as J_imagenet
from unigen_tpu.data import llava as J_llava
from unigen_tpu.data import text2image as J_t2i
from unigen_tpu_torch.data import decode as D
from unigen_tpu_torch.data import dpo_data as P_dpo
from unigen_tpu_torch.data import imagenet as P_imagenet
from unigen_tpu_torch.data import llava as P_llava
from unigen_tpu_torch.data import text2image as P_t2i

from test_prompting import MockTokenizer
from test_torch_data import _add, _close, _same_batches, jax_native_lib, use_jax_native  # noqa: F401
from torch_image_fixtures import (FIXTURE_DIR, bmp_bytes, fixture_image, gif_bytes, gif_lzw,
                                  tiff_bytes)
from torch_jpeg_fixtures import pixel_sha256, synthetic


def _save(img, fmt, **opts):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **opts)
    return buf.getvalue()


def _pil(data):
    """PIL's pixels, or None where PIL raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
        except Exception:
            return None


def _port(data):
    try:
        return D.decode_image(data)
    except D.CorruptImage:
        return None


def _same_as_pil(data):
    want = _pil(data)
    assert want is not None, "PIL does not read the case"
    got = D.decode_image(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _rgba(h, w, seed):
    a = fixture_image(h, w, "RGBA", seed)
    alpha = np.asarray(a)[..., 3].copy()
    alpha[::3, ::2] = 0                  # colour under alpha 0 stays as coded
    return PIL.fromarray(np.dstack([np.asarray(a)[..., :3], alpha]))


# ------------------------------------------------------------------ WebP --

@pytest.mark.parametrize("size", [(1, 1), (17, 9), (255, 129), (640, 480)])
@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("quality", [1, 50, 90, 100])
def test_webp_lossy_equals_pil(size, method, quality):
    w, h = size
    img = PIL.fromarray(synthetic(h, w, quality + method))
    _same_as_pil(_save(img, "WEBP", quality=quality, method=method))


@pytest.mark.parametrize("colors", [2, 4, 16, 256, None])
@pytest.mark.parametrize("method", range(7))
def test_webp_lossless_equals_pil(method, colors):
    img = PIL.fromarray(synthetic(37, 61, method))
    if colors:
        img = img.quantize(colors).convert("RGB")
    _same_as_pil(_save(img, "WEBP", lossless=True, method=method, quality=[0, 50, 100][method % 3]))


@pytest.mark.parametrize("opts", [dict(quality=70), dict(quality=70, alpha_quality=40),
                                  dict(quality=90, method=6, alpha_quality=100),
                                  dict(lossless=True), dict(lossless=True, exact=True)],
                         ids=["lossy", "lossy-alpha-q40", "lossy-m6", "lossless", "exact"])
def test_webp_alpha_equals_pil(opts):
    _same_as_pil(_save(_rgba(45, 67, 3), "WEBP", **opts))


@pytest.mark.parametrize("lossless", [False, True])
def test_webp_animation_frame_0_equals_pil(lossless):
    frames = [PIL.fromarray(synthetic(30, 40, s)) for s in range(3)]
    _same_as_pil(_save(frames[0], "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, quality=60))


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) % 2 else b"")


def _webp_chunks(data):
    pos, out = 12, {}
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out[tag] = data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)
    return out


def _riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _le24(v):
    return struct.pack("<I", v)[:3]


@pytest.mark.parametrize("codec", ["VP8L", "VP8 ", "VP8 +ALPH"])
def test_webp_small_first_frame_on_a_zero_canvas(codec):
    """An ANMF frame 0 smaller than its canvas, at an offset: libwebp decodes
    it into a zeroed canvas (no blending), so PIL's pixels outside it are
    black. PIL writes full-canvas first frames: these bytes are built."""
    img = PIL.fromarray(synthetic(11, 14, 5)) if codec != "VP8 +ALPH" else _rgba(11, 14, 5)
    still = _save(img, "WEBP", lossless=codec == "VP8L", quality=80)
    chunks = _webp_chunks(still)
    payload = b""
    if "ALPH" in codec:
        payload += _chunk(b"ALPH", chunks[b"ALPH"])
    tag = b"VP8L" if codec == "VP8L" else b"VP8 "
    payload += _chunk(tag, chunks[tag])
    frame = _le24(3) + _le24(2) + _le24(13) + _le24(10) + _le24(100) + b"\x00"
    flags = 0x02 | (0x10 if "ALPH" in codec else 0)
    data = _riff(_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _le24(29) + _le24(19)),
                 _chunk(b"ANIM", b"\x00" * 6), _chunk(b"ANMF", frame + payload))
    _same_as_pil(data)
    assert D.decode_image(data)[:4].max() == 0


def test_webp_raw_alpha_and_unknown_chunks_equal_pil():
    """VP8X with an uncompressed ALPH plane (each filter) and chunks libwebp
    skips (ICCP, EXIF, an unknown one)."""
    img = PIL.fromarray(synthetic(9, 17, 2))
    vp8 = _webp_chunks(_save(img, "WEBP", quality=60))[b"VP8 "]
    alpha = np.random.default_rng(0).integers(0, 256, (9, 17)).astype(np.uint8).tobytes()
    for filt in range(4):
        data = _riff(_chunk(b"VP8X", bytes([0x10 | 0x20, 0, 0, 0]) + _le24(16) + _le24(8)),
                     _chunk(b"ICCP", b"\x00" * 5), _chunk(b"ALPH", bytes([filt << 2]) + alpha),
                     _chunk(b"VP8 ", vp8), _chunk(b"ZZZZ", b"abc"))
        _same_as_pil(data)


# ------------------------------------------------------------------- GIF --

def _gif_cases():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 200, (23, 37))
    pal = rng.integers(0, 256, (256, 3))
    big = rng.integers(0, 256, (120, 300))
    grey = np.repeat(np.arange(256)[:, None], 3, axis=1)
    cases = {f"code-size-{ms}{'-interlaced' * il}": gif_bytes(
        idx % (1 << ms), global_palette=pal[:1 << ms], min_size=ms, interlace=il)
        for ms in (2, 3, 5, 8) for il in (False, True)}
    small = idx[:7, :9]
    cases.update({
        "small-first-frame": gif_bytes(small, screen=(37, 23), offset=(5, 3), global_palette=pal),
        "small-first-frame-transparency": gif_bytes(small, screen=(37, 23), offset=(5, 3),
                                                    global_palette=pal, transparency=17),
        "small-first-frame-background": gif_bytes(small, screen=(37, 23), offset=(5, 3),
                                                  global_palette=pal, background=9),
        "frame-past-the-screen": gif_bytes(small, screen=(10, 5), offset=(5, 3), global_palette=pal),
        "local-table": gif_bytes(idx, global_palette=pal, local_palette=pal[::-1]),
        "no-table": gif_bytes(idx),
        "grey-table-is-mode-L": gif_bytes(idx, global_palette=grey),
        "index-past-the-table": gif_bytes(idx, global_palette=pal[:16]),
        "deferred-clear": gif_bytes(big, global_palette=pal),
        "clear-at-4096": gif_bytes(big, global_palette=pal,
                                   lzw=gif_lzw(big.reshape(-1), 8, clear_at_full=True)),
        "comment-and-application-extensions": gif_bytes(idx, global_palette=pal, extensions=(
            b"!\xfe\x05hello\x00!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")),
    })
    for i, mode in enumerate(("P", "L", "1")):
        img = PIL.fromarray(synthetic(29, 41, i)).convert(mode) if mode != "P" else \
            PIL.fromarray(synthetic(29, 41, i)).quantize([2, 16, 256][i % 3] or 256)
        cases[f"pil-{mode}"] = _save(img, "GIF")
        cases[f"pil-{mode}-interlaced-transparency"] = _save(img, "GIF", interlace=True,
                                                             transparency=1)
    return cases


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("name", sorted(GIF_CASES))
def test_gif_equals_pil(name):
    _same_as_pil(GIF_CASES[name])


def test_gif_early_end_code_is_decided_as_pil():
    """An end code before the last row: PIL's decoder waits for more data;
    with none (the file's end), "image file is truncated"."""
    idx = np.random.default_rng(4).integers(0, 64, (20, 30))
    pal = np.random.default_rng(5).integers(0, 256, (64, 3))
    for trailer in (True, False):
        data = gif_bytes(idx, global_palette=pal, min_size=6, trailer=trailer,
                         lzw=gif_lzw(idx.reshape(-1), 6, early_end=True))
        assert _pil(data) is None
        with pytest.raises(D.CorruptImage, match="truncated"):
            D.decode_image(data)


# ------------------------------------------------------------------- BMP --

def _rle8(rows):
    out = bytearray()
    for row in rows:
        i = 0
        while i < len(row):
            j = i
            while j + 1 < len(row) and row[j + 1] == row[i] and j - i < 254:
                j += 1
            if j - i >= 2:
                out += bytes([j - i + 1, row[i]])
                i = j + 1
            elif len(row) - i >= 3:
                seg = row[i:i + 5]
                out += bytes([0, len(seg)]) + bytes(seg) + b"\x00" * (len(seg) % 2)
                i += len(seg)
            else:
                out += bytes([1, row[i]])
                i += 1
        out += b"\x00\x00"
    return bytes(out) + b"\x00\x01"


def _bmp_cases():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 16, (9, 13))
    pal = rng.integers(0, 256, (16, 3))
    rgb = rng.integers(0, 256, (9, 13, 3))
    words16 = rng.integers(0, 65536, (9, 13))
    words32 = rng.integers(0, 2 ** 32, (9, 13), dtype=np.uint64)
    cases = {}
    for hdr in (12, 40, 52, 56, 64, 108, 124):
        cases[f"8bit-header-{hdr}"] = bmp_bytes(img, 8, header=hdr, palette=pal)
        cases[f"4bit-header-{hdr}"] = bmp_bytes(img, 4, header=hdr, palette=pal)
        cases[f"24bit-header-{hdr}"] = bmp_bytes(rgb, 24, header=hdr)
    cases.update({
        "1bit": bmp_bytes(img % 2, 1, palette=pal[:2]),
        "1bit-black-white": bmp_bytes(img % 2, 1, palette=[(0, 0, 0), (255, 255, 255)]),
        "8bit-black-white-palette": bmp_bytes(img % 2, 8, palette=[(0, 0, 0), (255, 255, 255)]),
        "8bit-grey-palette": bmp_bytes(rng.integers(0, 256, (9, 13)), 8,
                                       palette=[(i, i, i) for i in range(256)]),
        "8bit-top-down": bmp_bytes(img, 8, palette=pal, top_down=True),
        "8bit-colors-0": bmp_bytes(img, 8, palette=np.resize(pal, (256, 3)), colors=0),
        "8bit-index-past-palette": bmp_bytes(rng.integers(0, 256, (9, 13)), 8, palette=pal),
        "16bit-555": bmp_bytes(words16, 16),
        "16bit-565-bitfields": bmp_bytes(words16, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "16bit-555-bitfields": bmp_bytes(words16, 16, compression=3, masks=(0x7C00, 0x3E0, 0x1F)),
        "32bit": bmp_bytes(words32, 32),
        "32bit-bitfields-header-40": bmp_bytes(words32, 32, compression=3,
                                               masks=(0xFF0000, 0xFF00, 0xFF)),
    })
    for m in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
              (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 0, 0, 0),
              (0xFF000000, 0xFF00, 0xFF, 0xFF0000)):
        for hdr in (56, 124):
            cases[f"32bit-bitfields-{hdr}-{m[0]:x}-{m[3]:x}"] = bmp_bytes(
                words32, 32, header=hdr, compression=3, masks=m)
    runs = np.repeat(rng.integers(0, 16, (9, 5)), 3, axis=1)[:, :13]
    raw = _rle8(runs[::-1].astype(int).tolist())
    rle = dict(size=(13, 9), palette=pal)
    cases.update({
        "rle8": bmp_bytes(None, 8, compression=1, raw=raw, **rle),
        "rle8-top-down": bmp_bytes(None, 8, compression=1, raw=raw, top_down=True, **rle),
        # PIL's delta takes its offsets from the two bytes after the two it skips
        "rle8-delta": bmp_bytes(None, 8, compression=1, raw=b"\x03\x05\x00\x02\x02\x01\x04\x07"
                                b"\x05\x09" + raw, **rle),
        "rle8-run-past-the-row": bmp_bytes(None, 8, compression=1, raw=b"\x20\x05" + raw, **rle),
        "rle4": bmp_bytes(None, 4, compression=2, raw=b"\x05\x12\x00\x05\x12\x34\x50\x00\x00\x00"
                          * 9 + b"\x00\x01", **rle),
    })
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("name", sorted(BMP_CASES))
def test_bmp_equals_pil(name):
    _same_as_pil(BMP_CASES[name])


def test_bmp_failures_are_pils():
    """An early end of bitmap leaves fewer bytes than pixels ("not enough
    image data"), an RLE4 absolute run past the data, a grey 16-entry
    palette at 4 bits (PIL's L unpacker needs more bytes than a row),
    unsupported bit fields and a truncated raster all fail in both."""
    rng = np.random.default_rng(7)
    img, pal = rng.integers(0, 16, (9, 13)), rng.integers(0, 256, (16, 3))
    raw = _rle8(img[::-1].astype(int).tolist())
    for data in (bmp_bytes(None, 8, compression=1, raw=raw[:len(raw) // 2] + b"\x00\x01",
                           size=(13, 9), palette=pal),
                 bmp_bytes(None, 4, compression=2, raw=b"\x00\x03\x12\x30" * 40 + b"\x00\x01",
                           size=(13, 9), palette=pal),
                 bmp_bytes(img, 4, palette=[(i, i, i) for i in range(16)]),
                 bmp_bytes(rng.integers(0, 65536, (9, 13)), 16, compression=3,
                           masks=(0x7C00, 0x3E0, 0x1E)),
                 bmp_bytes(img, 8, palette=pal)[:-5]):
        assert _pil(data) is None
        with pytest.raises(D.CorruptImage):
            D.decode_image(data)


# ------------------------------------------------------------------- PNM --

def _pnm_cases():
    rng = np.random.default_rng(8)
    cases = {}
    for maxval in (1, 15, 255, 1000, 65535):
        v = rng.integers(0, maxval + 1, (7, 11, 3))
        for kind in (2, 3, 5, 6):
            vv = v[..., :3 if kind in (3, 6) else 1]
            body = (" ".join(str(int(x)) for x in vv.reshape(-1))).encode() if kind < 5 else \
                vv.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
            cases[f"P{kind}-maxval-{maxval}"] = (f"P{kind}\n# a comment\n11 7\n{maxval}\n"
                                                 .encode() + body)
    bits = rng.integers(0, 2, (7, 11))
    cases.update({
        "P4": b"P4\n11 7\n" + np.packbits(bits, axis=1).tobytes(),
        "P1": b"P1 11 7\n" + "".join(str(int(x)) for x in bits.reshape(-1)).encode(),
        "P1-spaced-comments": b"P1\n#c\n11 7\n" + " ".join(
            str(int(x)) for x in bits.reshape(-1)).encode() + b"\n",
        "P5-above-maxval": b"P5 2 1 100 " + bytes([50, 200]),
        "P5-comment-inside-a-token": b"P5 2 1 2#x\n55 " + bytes([50, 200]),
        # PIL's own examples: 500 at maxval 1000 is 255 in P5 (mode I), 128 in P6
        "P5-500-of-1000": b"P5\n1 1\n1000\n\x01\xf4",
        "P6-500-of-1000": b"P6\n1 1\n1000\n\x01\xf4\x01\xf4\x01\xf4",
    })
    for mode in ("RGB", "L", "1"):
        cases[f"pil-{mode}"] = _save(PIL.fromarray(synthetic(13, 21, 1)).convert(mode), "PPM")
    return cases


PNM_CASES = _pnm_cases()


@pytest.mark.parametrize("name", sorted(PNM_CASES))
def test_pnm_equals_pil(name):
    _same_as_pil(PNM_CASES[name])


def test_pnm_scaling_is_pils():
    assert D.decode_image(PNM_CASES["P5-500-of-1000"]).tolist() == [[[255] * 3]]
    assert D.decode_image(PNM_CASES["P6-500-of-1000"]).tolist() == [[[128] * 3]]
    for bad in (b"P2 2 1 100 50 200", b"P6\n4 4\n255\n" + bytes(40), b"P1 2 2 0 1 2 0",
                b"P5 2 1 0 ab", b"P5 2 1 70000 ab", b"P3 1 1"):
        assert _pil(bad) is None
        with pytest.raises(D.CorruptImage):
            D.decode_image(bad)


# ------------------------------------------------------------------ TIFF --

def _tiff_pil_cases():
    base = synthetic(21, 33, 9)
    alpha = np.dstack([base, synthetic(21, 33, 10)[..., :1]])
    images = {"RGB": PIL.fromarray(base), "RGBA": PIL.fromarray(alpha),
              "L": PIL.fromarray(base).convert("L"), "1": PIL.fromarray(base).convert("1"),
              "P": PIL.fromarray(base).quantize(16), "CMYK": PIL.fromarray(base).convert("CMYK"),
              "LA": PIL.fromarray(alpha).convert("LA"),
              "I;16": PIL.fromarray(base[..., 0].astype(np.uint16) * 3)}
    cases = {}
    for mode, img in images.items():
        for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"):
            cases[f"pil-{mode}-{comp}"] = _save(img, "TIFF", compression=comp)
            if mode != "1" and comp != "raw":
                cases[f"pil-{mode}-{comp}-predictor"] = _save(img, "TIFF", compression=comp,
                                                              tiffinfo={317: 2})
    return cases


TIFF_PIL_CASES = _tiff_pil_cases()


@pytest.mark.parametrize("name", sorted(TIFF_PIL_CASES))
def test_tiff_written_by_pil_equals_pil(name):
    _same_as_pil(TIFF_PIL_CASES[name])


def _tiff_layouts():
    rng = np.random.default_rng(11)
    h, w = 23, 37
    smooth = (np.add.outer(np.arange(h), np.arange(w))[..., None] * 7 + np.arange(3) * 40) % 256
    configs = {
        "rgb8": dict(photometric=2, bits=8, samples=smooth),
        "rgb16": dict(photometric=2, bits=16, samples=smooth * 257 + rng.integers(0, 256, (h, w, 3))),
        "grey8": dict(photometric=1, bits=8, samples=smooth[..., :1]),
        "min-is-white8": dict(photometric=0, bits=8, samples=smooth[..., :1]),
        "grey16": dict(photometric=1, bits=16, samples=smooth[..., :1] * 200),
        "bilevel": dict(photometric=0, bits=1, samples=(smooth[..., :1] > 100).astype(int)),
        "grey4": dict(photometric=1, bits=4, samples=smooth[..., :1] % 16),
        "palette8": dict(photometric=3, bits=8, samples=smooth[..., :1],
                         colormap=rng.integers(0, 65536, 768)),
        "palette4": dict(photometric=3, bits=4, samples=smooth[..., :1] % 16,
                         colormap=rng.integers(0, 65536, 48)),
        "cmyk": dict(photometric=5, bits=8, samples=np.concatenate([smooth, smooth[..., :1] // 2], -1)),
        "rgba": dict(photometric=2, bits=8, extra=(2,),
                     samples=np.concatenate([smooth, (smooth[..., :1] * 3) % 256], -1)),
        "rgb-associated-alpha": dict(photometric=2, bits=8, extra=(1,), samples=np.concatenate(
            [smooth // 2, smooth[..., :1] // 2 + 128], -1)),
        "rgb-extra-sample": dict(photometric=2, bits=8, extra=(0,),
                                 samples=np.concatenate([smooth, smooth[..., :1]], -1)),
    }
    layouts = {"strip": dict(), "strips-of-4": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16)),
               "planar": dict(planar=2), "planar-tiles": dict(planar=2, tile=(16, 16)),
               "predictor": dict(predictor=2), "orientation-6": dict(orientation=6),
               "orientation-3": dict(orientation=3), "fill-order-2": dict(fill_order=2)}
    cases = {}
    for cname, cfg in configs.items():
        for lname, layout in layouts.items():
            for comp in (1, 5, 8, 32773):
                if layout.get("predictor") and (cfg["bits"] < 8 or comp in (1, 32773)):
                    continue
                if layout.get("planar") and cfg["samples"].shape[2] == 1:
                    continue
                for big in (False, True):
                    cases[f"{cname}-{lname}-{comp}-{'MM' if big else 'II'}"] = (
                        cname, lname, cfg, dict(layout, compression=comp, big=big))
    return cases


TIFF_LAYOUTS = _tiff_layouts()


@pytest.mark.parametrize("name", sorted(TIFF_LAYOUTS))
def test_tiff_layouts_decided_as_pil(name):
    """Built TIFFs over every layout, codec, byte order and sample layout:
    the port's pixels are PIL's, and where PIL has no unpacker for a layout
    (a plane of LA, associated alpha or an extra sample in raw planar data,
    a bit-reversed min-is-white raw raster) both fail."""
    _, _, cfg, layout = TIFF_LAYOUTS[name]
    cfg = dict(cfg)
    data = tiff_bytes(cfg.pop("samples"), **cfg, **layout)
    want = _pil(data)
    got = _port(data)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_tiff_layout_cases_decode_in_pil():
    """The layout cases are not all failures: with LZW, every sample layout
    decodes in PIL in some layout and every layout in some sample layout."""
    configs, layouts = set(), set()
    for cname, lname, cfg, layout in TIFF_LAYOUTS.values():
        if layout["compression"] != 5 or layout["big"]:
            continue
        cfg = dict(cfg)
        if _pil(tiff_bytes(cfg.pop("samples"), **cfg, **layout)) is not None:
            configs.add(cname)
            layouts.add(lname)
    assert configs == {c for c, *_ in TIFF_LAYOUTS.values()}
    assert layouts == {l for _, l, *_ in TIFF_LAYOUTS.values()}


# ---------------------------------------------- truncated and corrupted --

def _corruption_sources():
    img = PIL.fromarray(synthetic(21, 33, 12))
    rgba = _rgba(21, 33, 13)
    return {
        "webp-lossy": _save(img, "WEBP", quality=70),
        "webp-lossless": _save(img, "WEBP", lossless=True),
        "webp-alpha": _save(rgba, "WEBP", quality=70),
        "webp-alpha-lossless": _save(rgba, "WEBP", lossless=True),
        "webp-palette": _save(img.quantize(16), "WEBP", lossless=True),
        "gif": _save(img.quantize(64), "GIF"),
        "gif-interlaced": _save(img.quantize(64), "GIF", interlace=True),
        "bmp24": _save(img, "BMP"),
        "bmp8": _save(img.quantize(64), "BMP"),
        "bmp-rle8": BMP_CASES["rle8"],
        "ppm": _save(img, "PPM"),
        "pgm-plain": PNM_CASES["P2-maxval-1000"],
        "tiff-raw": _save(img, "TIFF"),
        "tiff-lzw": _save(img, "TIFF", compression="tiff_lzw"),
        "tiff-deflate": _save(img, "TIFF", compression="tiff_adobe_deflate"),
        "tiff-packbits-tiles-MM": tiff_bytes(np.asarray(img), 2, 8, big=True, compression=32773,
                                             tile=(16, 16)),
    }


CORRUPTION_SOURCES = _corruption_sources()
# libtiff rejects a directory PIL's parser accepts in one flip of this set
# (named in ROADMAP.md's "Deliberate differences")
KNOWN_DECISION_DIFFERENCES = {}


@pytest.mark.parametrize("name", sorted(CORRUPTION_SOURCES))
def test_truncated_and_corrupted_files_decided_as_pil(name):
    """Seeded cuts and 1-3 byte flips of each format: the port raises
    where PIL raises and returns PIL's pixels where PIL returns pixels."""
    data = CORRUPTION_SOURCES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    variants = [data[:int(c)] for c in sorted(set(rng.integers(1, len(data), 6).tolist()))]
    for _ in range(40):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        variants.append(bytes(m))
    decided = {True: 0, False: 0}
    for i, v in enumerate(variants):
        want, got = _pil(v), _port(v)
        if (name, i) in KNOWN_DECISION_DIFFERENCES:
            continue
        assert (got is None) == (want is None), (name, i)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} variant {i}")
        decided[want is None] += 1
    assert decided[True] >= 6          # every cut fails
    assert sum(decided.values()) == len(variants) - sum(
        1 for k in KNOWN_DECISION_DIFFERENCES if k[0] == name)


# -------------------------------------------------------------- fixtures --

def test_image_fixtures_match_their_json():
    index = json.loads(open(os.path.join(FIXTURE_DIR, "fixtures.json")).read())
    assert len(index) >= 19
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in index) < 1_500_000
    formats = set()
    for name, meta in sorted(index.items()):
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            data = f.read()
        assert len(data) == meta["bytes"]
        got = D.decode_image(data)
        assert list(got.shape) == meta["shape"] and pixel_sha256(got) == meta["sha256"], name
        assert pixel_sha256(_pil(data)) == meta["sha256"], name
        formats.add(meta["format"])
    assert formats == {"WEBP", "GIF", "BMP", "PPM", "TIFF"}


# ------------------------------------------------- what the port refuses --

def _unsupported_cases():
    img = PIL.fromarray(synthetic(16, 16, 14))
    cases = {
        "JPEG 2000": _save(img, "JPEG2000"),
        "JPEG 2000 codestream": _save(img, "JPEG2000", no_jp2=True),
        "ICO": _save(img, "ICO"),
        "AVIF": _save(img, "AVIF"),
        "QOI": _save(img, "QOI"),
        "TIFF with JPEG": _save(img, "TIFF", compression="jpeg"),
        "TIFF with CCITT Group 4": _save(img.convert("1"), "TIFF", compression="group4"),
        "TIFF with LZMA": _save(img, "TIFF", compression="lzma"),
        "TIFF with ZSTD": _save(img, "TIFF", compression="zstd"),
        "BigTIFF": _save(img, "TIFF", big_tiff=True),
        "TIFF float": _save(PIL.fromarray(synthetic(16, 16, 15)[..., 0].astype(np.float32)), "TIFF"),
        "TIFF predictor 3": _save(PIL.fromarray(synthetic(16, 16, 15)[..., 0].astype(np.float32)),
                                  "TIFF", compression="tiff_lzw", tiffinfo={317: 3}),
        "TIFF YCbCr": tiff_bytes(synthetic(16, 16, 16), 6, 8),
        "PFM": b"Pf\n2 2\n-1.0\n" + np.zeros(4, "<f4").tobytes(),
        "PSD": b"8BPS\x00\x01" + bytes(6) + struct.pack(">HIIHH", 3, 4, 4, 8, 3)
               + bytes(12) + b"\x00\x00" + bytes(48),
    }
    return cases


UNSUPPORTED = _unsupported_cases()


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_what_pil_reads_and_the_port_does_not_raises_unsupported(name):
    """Bytes PIL reads (checked: it opens them) that the port does not
    decode raise ``UnsupportedImageFormat`` naming the format: a stop, not
    a ``CorruptImage`` a loader would skip."""
    data = UNSUPPORTED[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        PIL.open(io.BytesIO(data))
    with pytest.raises(D.UnsupportedImageFormat, match="the port reads") as e:
        D.decode_image(data)
    word = {"AVIF": "AVIF", "BigTIFF": "BigTIFF", "PFM": "PFM", "PSD": "PSD", "QOI": "QOI",
            "ICO": "ICO", "TIFF float": "float", "TIFF predictor 3": "float",
            "TIFF YCbCr": "YCbCr"}.get(name, name.split(" with ")[-1].split(" codestream")[0])
    assert word in str(e.value)


# --------------------------------------------------------------- loaders --

def _webp_shard(path, start, n, size=24):
    """WebP samples (lossy, lossless, alpha; sizes off the resize target)
    with a PNG and a GIF-free caption mix, and one truncated WebP (a
    sample both loaders skip)."""
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            h, w = ((size, size + 8), (size + 10, size), (size + 3, size + 5))[i % 3]
            img = PIL.fromarray(synthetic(h, w, i)) if i % 4 != 3 else _rgba(h, w, i)
            opts = [dict(quality=60 + i), dict(lossless=True), dict(quality=90, method=6),
                    dict(quality=75)][i % 4]
            _add(tf, f"{i:05d}.webp", _save(img, "WEBP", **opts))
            _add(tf, f"{i:05d}.txt", f"a photo of thing {i}".encode())
        data = _save(PIL.fromarray(synthetic(size, size, 99)), "WEBP", quality=80)
        _add(tf, f"{start + n:05d}.webp", data[:len(data) // 2])
        _add(tf, f"{start + n:05d}.txt", b"the caption of a truncated image")


@pytest.mark.parametrize("native", [False, True])
def test_text2image_on_webp_matches_jax(tmp_path, monkeypatch, jax_native_lib, native):
    if native:
        use_jax_native(monkeypatch, jax_native_lib)
    shards = []
    for s in range(2):
        shards.append(str(tmp_path / f"w-{s}.tar"))
        _webp_shard(shards[-1], 10 * s, 8)
    kw = dict(per_device_batch_size=3, resolution=16, seed=6, num_batches=5, use_native=native)
    j, p = list(J_t2i.Text2ImageDataset(shards, **kw)), list(P_t2i.Text2ImageDataset(shards, **kw))
    assert len(j) == len(p) == 5
    for a, b in zip(p, j):
        assert a["input_ids"] == b["input_ids"]
        _close(a["images"], b["images"], False)


def _format_files(size=(20, 28)):
    """name -> bytes: the formats of a LLaVA or ImageNet folder."""
    h, w = size
    img = lambda s: PIL.fromarray(synthetic(h + 2 * (s % 3), w, s))  # noqa: E731
    return {
        "gif_named.jpg": _save(img(1).quantize(128), "GIF"),
        "scan.bmp": _save(img(2), "BMP"),
        "scan8.bmp": _save(img(3).quantize(64), "BMP"),
        "scan.tif": _save(img(4), "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "scan_deflate.tiff": _save(img(5), "TIFF", compression="tiff_adobe_deflate"),
        "photo.ppm": _save(img(6), "PPM"),
        "photo.pgm": _save(img(7).convert("L"), "PPM"),
        "photo.webp": _save(img(8), "WEBP", quality=70),
    }


def _llava_args():
    return dict(per_device_batch_size=3, max_length=48, visual_mode="vq", resolution=16, seed=2)


def _llava_folder(tmp_path, files, broken=None):
    root = tmp_path / "images"
    root.mkdir()
    names = sorted(files)
    for name in names:
        (root / name).write_bytes(files[name])
    if broken:
        (root / broken[0]).write_bytes(broken[1])
        names.append(broken[0])
    convs = [{"image": name, "conversations": [
        {"from": "human", "value": f"<image>\nWhat is {i}?"},
        {"from": "gpt", "value": f"It is thing {i}."}]} for i, name in enumerate(names)]
    path = tmp_path / "c.jsonl"
    path.write_text("\n".join(json.dumps(c) for c in convs) + "\n")
    return str(path), str(root)


def test_llava_on_gif_bmp_tiff_pnm_matches_jax(tmp_path):
    """LLaVA's OCR-VQA ships GIFs under .jpg names: the loaders read them by
    their bytes, beside BMP, TIFF, PPM / PGM and WebP; a truncated GIF is
    the dummy image in both."""
    gif = _format_files()["gif_named.jpg"]
    path, root = _llava_folder(tmp_path, _format_files(), broken=("broken.jpg", gif[:300]))
    j = iter(J_llava.LlavaDataset([path], root, MockTokenizer(), **_llava_args()))
    p = iter(P_llava.LlavaDataset([path], root, MockTokenizer(), **_llava_args()))
    for _ in range(4):
        a, b = next(p), next(j)
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], k != "images")


def test_imagenet_on_pnm_bmp_tiff_webp_matches_jax(tmp_path):
    root = tmp_path / "imagenet"
    files = _format_files(size=(16, 16))
    names = sorted(n for n in files if not n.endswith(".jpg"))
    for c, wnid in enumerate(("n01440764", "n01443537")):
        (root / wnid).mkdir(parents=True)
        for name in names[c::2]:
            (root / wnid / name).write_bytes(files[name])
    (root / "n01443537" / "broken.ppm").write_bytes(files["photo.ppm"][:100])
    for kw in (dict(), dict(prefix_prompt="a photo of ", seed=2)):
        j = iter(J_imagenet.ImageNetDataset(str(root), 3, image_size=16, **kw))
        p = iter(P_imagenet.ImageNetDataset(str(root), 3, image_size=16, **kw))
        _same_batches(j, p, 4, exact=False)


def test_pnm_is_read_not_skipped_as_in_jax(tmp_path):
    """The fault the port had: its sniffer did not know P1-P6, so a valid
    .ppm / .pgm was a corrupt file, skipped by ImageNet and blacked out by
    LLaVA, where JAX reads both through PIL. A folder of a PIL-written PPM
    and PGM: the port's batches are JAX's, and no LLaVA image is the dummy."""
    files = {n: d for n, d in _format_files(size=(16, 16)).items() if n.startswith("photo.p")}
    root = tmp_path / "imagenet" / "n01440764"
    root.mkdir(parents=True)
    for name, data in files.items():
        (root / name).write_bytes(data)
    j = iter(J_imagenet.ImageNetDataset(str(root.parent), 2, image_size=16))
    p = iter(P_imagenet.ImageNetDataset(str(root.parent), 2, image_size=16))
    _same_batches(j, p, 2, exact=False)
    path, images = _llava_folder(tmp_path, files)
    args = dict(_llava_args(), per_device_batch_size=2)
    a = next(iter(P_llava.LlavaDataset([path], images, MockTokenizer(), **args)))
    b = next(iter(J_llava.LlavaDataset([path], images, MockTokenizer(), **args)))
    _close(a["images"], b["images"], False)
    assert all(np.abs(im).max() > 0 for im in a["images"])


def test_dpo_on_lossless_webp_matches_jax(tmp_path):
    root = tmp_path / "pairs"
    root.mkdir()
    names = []
    for i in range(8):
        img = PIL.fromarray(synthetic(20 + 4 * (i % 2), 28, 60 + i))
        if i % 3 == 2:
            img = img.quantize(32)
        names.append(f"{'cr'[i % 2]}{i // 2}.webp")
        data = _save(img, "WEBP", lossless=True, method=i % 7)
        (root / names[-1]).write_bytes(data[:40] if i == 5 else data)
    items = [{"prompt": f"p{i}", "chosen": names[2 * i], "rejected": names[2 * i + 1]}
             for i in range(4)]
    (tmp_path / "pairs.jsonl").write_text("\n".join(json.dumps(x) for x in items) + "\n")
    args = dict(per_device_batch_size=2, resolution=16, seed=3)
    jb = list(J_dpo.DPODataset([str(tmp_path / "pairs.jsonl")], str(root), **args))
    pb = list(P_dpo.DPODataset([str(tmp_path / "pairs.jsonl")], str(root), **args))
    assert len(jb) == len(pb) > 0
    for a, b in zip(pb, jb):
        assert a["batch_prompt_list"] == b["batch_prompt_list"]
        for k in ("batch_chosen_image", "batch_rejected_image"):
            _close(a[k], b[k], False)
