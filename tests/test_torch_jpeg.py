"""The port's image decoders against PIL, and its loaders against the JAX
package's on JPEG data, on the CPU.

``decode_image`` on JPEG equals PIL's ``Image.open(b).convert("RGB")`` bit for
bit (this host's PIL writes every file, and reads it back with its
libjpeg-turbo) for each variant PIL can write: the three chroma
subsamplings, progressive, optimised tables, restart markers, qualities 1
to 100, 16-bit tables, grey, RGB and CMYK, sizes off the MCU grid and 1x1;
the committed fixtures of ``chip_smoke.py``'s ``jpeg`` phase match their
JSON. On broken files the port raises where PIL raises and returns pixels
where PIL does. Adam7-interlaced and 16-bit PNG of every colour type equal
PIL's. JAX's four loaders and the port's give the same batches on JPEG
shards and folders (``test_torch_data._same_batches``' tolerance where an
image is resized).
"""
import io
import json
import os
import struct
import tarfile
import zlib

import numpy as np
import pytest

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
from torch_jpeg_fixtures import FIXTURE_DIR, TRUNCATED, pixel_sha256, synthetic

PIL = pytest.importorskip("PIL.Image")


def _jpeg(h, w, seed=0, mode="RGB", **opts):
    img = PIL.fromarray(synthetic(h, w, seed))
    if mode != "RGB":
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _pil(data):
    """PIL's pixels, or the exception it raises."""
    try:
        return np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:          # noqa: BLE001 - any exception is PIL's skip
        return e


# ------------------------------------------------------------------- JPEG --

JPEG_CASES = {
    "420_q75": ((48, 64), "RGB", dict(quality=75)),
    "444": ((40, 56), "RGB", dict(subsampling=0)),
    "422": ((40, 56), "RGB", dict(subsampling=1)),
    "420": ((40, 56), "RGB", dict(subsampling=2)),
    "progressive_420": ((45, 61), "RGB", dict(progressive=True)),
    "progressive_444_q95": ((33, 47), "RGB", dict(progressive=True, subsampling=0, quality=95)),
    "progressive_422_restarts": ((33, 70), "RGB", dict(progressive=True, subsampling=1,
                                                       restart_marker_rows=1)),
    "optimize_422": ((37, 53), "RGB", dict(optimize=True, subsampling=1)),
    "restart_blocks_420": ((50, 70), "RGB", dict(restart_marker_blocks=3)),
    "restart_blocks_444": ((17, 30), "RGB", dict(restart_marker_blocks=1, subsampling=0)),
    "q1": ((40, 40), "RGB", dict(quality=1)),
    "q50": ((40, 40), "RGB", dict(quality=50)),
    "q95": ((40, 40), "RGB", dict(quality=95)),
    "q100": ((40, 40), "RGB", dict(quality=100)),
    "16bit_tables": ((30, 41), "RGB", dict(qtables=[[9] * 5 + [400] * 59, [2000] * 64])),
    "grey": ((35, 45), "L", dict()),
    "grey_progressive": ((35, 45), "L", dict(progressive=True, quality=60)),
    "cmyk": ((30, 38), "CMYK", dict()),
    "cmyk_progressive": ((30, 38), "CMYK", dict(progressive=True)),
    "off_grid_17x9": ((9, 17), "RGB", dict()),
    "off_grid_3x2_420": ((2, 3), "RGB", dict(subsampling=2)),
    "off_grid_5x3_422": ((3, 5), "RGB", dict(subsampling=1)),
    "1x1": ((1, 1), "RGB", dict()),
    "1x1_grey": ((1, 1), "L", dict()),
    "tall_1x40_420": ((40, 1), "RGB", dict(subsampling=2)),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_equals_pil(case):
    (h, w), mode, opts = JPEG_CASES[case]
    data = _jpeg(h, w, seed=len(case), mode=mode, **opts)
    want = _pil(data)
    got = D.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_jpeg_adobe_rgb_and_component_ids_equal_pil():
    """No JFIF: an Adobe marker with transform 0 means RGB samples; without
    one, component ids 'R', 'G', 'B' do (libjpeg's colour-space guess)."""
    data = _jpeg(24, 40, seed=3, subsampling=0)
    app0 = data.index(b"\xff\xe0")
    body = data[:app0] + data[app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big"):]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    sof = body.index(b"\xff\xc0")
    sos = body.index(b"\xff\xda")
    rgb_ids = bytearray(body)
    for i in range(3):
        rgb_ids[sof + 10 + 3 * i] = rgb_ids[sos + 5 + 2 * i] = b"RGB"[i]
    for variant in (body[:2] + adobe + body[2:], bytes(rgb_ids), body):
        want = _pil(variant)
        np.testing.assert_array_equal(D.decode_image(variant), want)


def test_jpeg_fixtures_match_their_json():
    """The committed fixtures: the port's pixels and PIL's have the JSON's
    hash; the truncated one fails in both."""
    with open(os.path.join(FIXTURE_DIR, "fixtures.json")) as f:
        index = json.load(f)
    assert len(index) == 13 and sum(v["bytes"] for v in index.values()) < 1_100_000
    for name, meta in index.items():
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            data = f.read()
        assert len(data) == meta["bytes"], name
        if meta["sha256"] is None:
            assert name == TRUNCATED and isinstance(_pil(data), OSError)
            with pytest.raises(D.CorruptImage, match="truncated"):
                D.decode_image(data)
            continue
        got = D.decode_image(data)
        assert list(got.shape) == meta["shape"], name
        assert pixel_sha256(got) == meta["sha256"] == pixel_sha256(_pil(data)), name


def _entropy_start(data):
    """The offset of the first scan's entropy-coded bytes."""
    sos = data.index(b"\xff\xda")
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def _drop_segments(data, marker):
    out, pos = bytearray(data[:2]), 2
    while True:
        m, length = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xDA:
            return bytes(out + data[pos:])
        if m != marker:
            out += data[pos:pos + 2 + length]
        pos += 2 + length


def _broken_cases():
    base = _jpeg(40, 56, seed=1, quality=80)
    prog = _jpeg(40, 56, seed=2, quality=80, progressive=True)
    rst = _jpeg(40, 56, seed=4, quality=80, restart_marker_blocks=2)
    cases = {}
    for name, data in (("baseline", base), ("progressive", prog), ("restarts", rst)):
        start = _entropy_start(data)
        cases[f"{name}_truncated_mid"] = data[:(start + len(data)) // 2]
        cases[f"{name}_without_eoi"] = data[:-2]
        cases[f"{name}_header_only"] = data[:start]
        for k, pos in enumerate((start + 7, start + (len(data) - start) // 2, len(data) - 9)):
            for x in (0x01, 0x5A):
                cases[f"{name}_flip{k}_{x:02x}"] = data[:pos] + bytes([data[pos] ^ x]) + \
                    data[pos + 1:]
            cases[f"{name}_ff{k}"] = data[:pos] + b"\xff" + data[pos + 1:]
        dqt = data.index(b"\xff\xdb")
        for delta in (-1, 1, 40):
            n = int.from_bytes(data[dqt + 2:dqt + 4], "big") + delta
            cases[f"{name}_dqt_length{delta:+d}"] = data[:dqt + 2] + n.to_bytes(2, "big") + \
                data[dqt + 4:]
        sof = data.index(b"\xff\xc0" if name != "progressive" else b"\xff\xc2")
        cases[f"{name}_sof_length"] = data[:sof + 3] + bytes([data[sof + 3] + 3]) + \
            data[sof + 4:]
        app0 = data.index(b"\xff\xe0")
        cases[f"{name}_app0_length"] = data[:app0 + 3] + bytes([data[app0 + 3] + 5]) + \
            data[app0 + 4:]
        cases[f"{name}_no_dht"] = _drop_segments(data, 0xC4)
        cases[f"{name}_no_dqt"] = _drop_segments(data, 0xDB)
    return cases


BROKEN = _broken_cases()


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_jpeg_decided_as_pil(case):
    """Truncations, flipped and 0xFF entropy bytes, bad marker lengths,
    missing tables: ``CorruptImage`` exactly where PIL raises; where PIL
    returns pixels the port does, equal to PIL's unless the entropy data is
    corrupt (where libjpeg only warns, the port's pixels may differ)."""
    data = BROKEN[case]
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(D.CorruptImage):
            D.decode_image(data)
        return
    got = D.decode_image(data)
    assert got.shape == want.shape
    if "flip" not in case and "_ff" not in case:
        np.testing.assert_array_equal(got, want)


def test_broken_jpeg_cases_cover_both_decisions():
    decisions = {isinstance(_pil(d), Exception) for name, d in BROKEN.items()
                 if "no_dht" in name or "flip" in name or "ff" in name}
    assert decisions == {True, False}
    # a baseline file without tables decodes with libjpeg-turbo's standard ones
    assert not isinstance(_pil(BROKEN["baseline_no_dht"]), Exception)
    assert isinstance(_pil(BROKEN["progressive_no_dht"]), Exception)


@pytest.mark.parametrize("marker,variant", [(0xC9, "arithmetic-coded JPEG (SOF9)"),
                                            (0xCA, "arithmetic-coded JPEG (SOF10)"),
                                            (0xC3, "lossless JPEG (SOF3)"),
                                            (0xC5, "hierarchical JPEG (SOF5)")])
def test_unsupported_jpeg_variants_raise_naming_them(marker, variant):
    data = _jpeg(16, 16)
    sof = data.index(b"\xff\xc0")
    bad = data[:sof + 1] + bytes([marker]) + data[sof + 2:]
    with pytest.raises(D.UnsupportedImageFormat, match=variant.replace("(", r"\(")
                       .replace(")", r"\)")):
        D.decode_image(bad)
    twelve = data[:sof + 4] + bytes([12]) + data[sof + 5:]
    with pytest.raises(D.UnsupportedImageFormat, match="12-bit JPEG"):
        D.decode_image(twelve)


# -------------------------------------------------------------------- PNG --

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_raw(samples, depth, color, interlace, palette=None):
    """A PNG of ``samples`` [H, W, C] (values below 2**depth), every row
    filter 0, Adam7 passes when ``interlace``."""
    h, w = samples.shape[:2]
    rows = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        for row in sub:
            flat = row.reshape(-1)
            if depth == 16:
                line = flat.astype(">u2").tobytes()
            elif depth == 8:
                line = flat.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(flat.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
                line = np.packbits(bits.reshape(-1)).tobytes()
            rows += b"\x00" + line

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))
    out = D.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                    interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")


PNG_CASES = [(depth, color, interlace) for interlace in (0, 1)
             for depth, color in ((1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
                                  (1, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6))
             if interlace or depth == 16]


@pytest.mark.parametrize("depth,color,interlace", PNG_CASES)
def test_interlaced_and_16bit_png_equal_pil(depth, color, interlace):
    rng = np.random.default_rng(depth * 10 + color)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((13, 11), (1, 1), (3, 9)):
        samples = rng.integers(0, 2 ** depth, size=(h, w, ch))
        if depth == 16 and color == 0:
            samples[0, 0] = 200          # PIL's I;16 clips to 255 on the way to RGB
        palette = rng.integers(0, 256, size=(2 ** depth, 3)).astype(np.uint8) \
            if color == 3 else None
        data = _png_raw(samples, depth, color, interlace, palette)
        np.testing.assert_array_equal(D.decode_image(data), _pil(data))


# ---------------------------------------------------------------- loaders --

def _jpeg_shard(path, start, n, size=24):
    """n samples of JPEG images (one in four progressive, one in five grey,
    every size off the resize target) with one PNG, txt captions, and one
    truncated JPEG (a sample both loaders skip)."""
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            h, w = ((size, size + 8), (size + 10, size), (size + 3, size + 5))[i % 3]
            if i % 7 == 6:
                img = PIL.fromarray(synthetic(h, w, i))
                buf = io.BytesIO()
                img.save(buf, format="PNG")
                _add(tf, f"{i:05d}.png", buf.getvalue())
            else:
                _add(tf, f"{i:05d}.jpg", _jpeg(h, w, seed=i, mode="L" if i % 5 == 4 else "RGB",
                                               progressive=i % 4 == 1, quality=70 + i % 25))
            _add(tf, f"{i:05d}.txt", f"a photo of thing {i}".encode())
        _add(tf, f"{start + n:05d}.jpg", _jpeg(size, size, seed=99)[:300])
        _add(tf, f"{start + n:05d}.txt", b"the caption of a truncated image")


@pytest.mark.parametrize("native", [False, True])
def test_text2image_on_jpeg_matches_jax(tmp_path, monkeypatch, jax_native_lib, native):
    if native:
        use_jax_native(monkeypatch, jax_native_lib)
    shards = []
    for s in range(2):
        shards.append(str(tmp_path / f"j-{s}.tar"))
        _jpeg_shard(shards[-1], 10 * s, 8)
    kw = dict(per_device_batch_size=3, resolution=16, seed=6, num_batches=5, use_native=native)
    j, p = list(J_t2i.Text2ImageDataset(shards, **kw)), list(P_t2i.Text2ImageDataset(shards, **kw))
    assert len(j) == len(p) == 5
    for a, b in zip(p, j):
        assert a["input_ids"] == b["input_ids"]
        _close(a["images"], b["images"], False)


def _jpeg_folder(root, names, size=(20, 28)):
    root.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        data = _jpeg(size[0] + 4 * (i % 2), size[1], seed=50 + i, mode="L" if i == 2 else "RGB",
                     progressive=i % 3 == 1, subsampling=i % 3)
        (root / name).write_bytes(data[:200] if name.startswith("broken") else data)


def test_llava_on_jpeg_matches_jax(tmp_path):
    root = tmp_path / "coco"
    _jpeg_folder(root, [f"im{i}.jpg" for i in range(4)] + ["broken.jpg"])
    convs = [{"image": f"im{i}.jpg" if i < 4 else "broken.jpg", "conversations": [
        {"from": "human", "value": f"<image>\nWhat is {i}?"},
        {"from": "gpt", "value": f"It is thing {i}."}]} for i in range(5)]
    path = tmp_path / "c.jsonl"
    path.write_text("\n".join(json.dumps(c) for c in convs) + "\n")
    args = dict(per_device_batch_size=3, max_length=48, visual_mode="vq", resolution=16, seed=2)
    j = iter(J_llava.LlavaDataset([str(path)], str(root), MockTokenizer(), **args))
    p = iter(P_llava.LlavaDataset([str(path)], str(root), MockTokenizer(), **args))
    for _ in range(3):
        a, b = next(p), next(j)
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], k != "images")


def test_dpo_on_jpeg_matches_jax(tmp_path):
    root = tmp_path / "pairs"
    names = [f"{side}{i}.jpg" for i in range(4) for side in "cr"]
    names[5] = "broken_r2.jpg"
    _jpeg_folder(root, names)
    items = [{"prompt": f"p{i}", "chosen": names[2 * i], "rejected": names[2 * i + 1]}
             for i in range(4)]
    (tmp_path / "pairs.jsonl").write_text("\n".join(json.dumps(x) for x in items) + "\n")
    args = dict(per_device_batch_size=2, resolution=16, seed=3)
    j = J_dpo.DPODataset([str(tmp_path / "pairs.jsonl")], str(root), **args)
    p = P_dpo.DPODataset([str(tmp_path / "pairs.jsonl")], str(root), **args)
    jb, pb = list(j), list(p)
    assert len(jb) == len(pb) > 0
    for a, b in zip(pb, jb):
        assert a["batch_prompt_list"] == b["batch_prompt_list"]
        for k in ("batch_chosen_image", "batch_rejected_image"):
            _close(a[k], b[k], False)


def test_imagenet_on_jpeg_matches_jax(tmp_path):
    root = tmp_path / "imagenet"
    for c, wnid in enumerate(("n01440764", "n01443537")):
        _jpeg_folder(root / wnid, [f"x{i}.JPEG" if (c, i) != (1, 1) else "broken.JPEG"
                                   for i in range(3)], size=(16, 16))
    for kw in (dict(), dict(prefix_prompt="a photo of ", seed=2)):
        j = iter(J_imagenet.ImageNetDataset(str(root), 3, image_size=16, **kw))
        p = iter(P_imagenet.ImageNetDataset(str(root), 3, image_size=16, **kw))
        _same_batches(j, p, 4, exact=False)

