"""The port's data layer (``unigen_tpu_torch/data``) against the JAX package's
(``unigen_tpu/data``) on the same files and seeds, on the CPU.

Every file is built in the test (PIL, pyarrow and ``tarfile``, which this
host has). Exact: keys, captions (short/long mixing, ``<person>``, prefixes,
caption prompts), skipped samples, ``pipe:`` streams, parquet crops and
row sharding, LLaVA ids and labels, DPO sampling and order, ImageNet
captions, ``combined_loader``'s cycling and the dataflow helpers. Pixels:
exact where the image already has the target size, else within 2 levels
(2 / 127.5 in ±1 units) on under 1% of the values. The PNG decoder equals
PIL's pixels on PIL-written PNGs of every colour type and on PNGs written
here with each of the five row filters; the native tar stream equals the
Python reader on one pass.
"""
import io
import json
import os
import subprocess
import sys
import tarfile
import zlib

import numpy as np
import pytest

from unigen_tpu.data import combined as J_combined
from unigen_tpu.data import conversation as J_conv
from unigen_tpu.data import dataflows as J_flows
from unigen_tpu.data import dpo_data as J_dpo
from unigen_tpu.data import imagenet as J_imagenet
from unigen_tpu.data import lm_data as J_lm
from unigen_tpu.data import llava as J_llava
from unigen_tpu.data import text2image as J_t2i
from unigen_tpu.data import transform as J_transform
from unigen_tpu_torch.data import combined as P_combined
from unigen_tpu_torch.data import conversation as P_conv
from unigen_tpu_torch.data import dataflows as P_flows
from unigen_tpu_torch.data import decode as D
from unigen_tpu_torch.data import dpo_data as P_dpo
from unigen_tpu_torch.data import imagenet as P_imagenet
from unigen_tpu_torch.data import lm_data as P_lm
from unigen_tpu_torch.data import llava as P_llava
from unigen_tpu_torch.data import native as N
from unigen_tpu_torch.data import text2image as P_t2i
from unigen_tpu_torch.data import transform as P_transform

from test_prompting import MockTokenizer

PIL = pytest.importorskip("PIL.Image")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_jax_native(directory) -> str:
    """JAX's own ``csrc/tarloader.cpp`` compiled with its Makefile's flags
    into ``directory`` (nothing is written under ``csrc/``)."""
    out = os.path.join(str(directory), "libtarloader.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
                    "-shared", "-o", out, os.path.join(REPO, "csrc", "tarloader.cpp")],
                   check=True, capture_output=True)
    return out


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    return build_jax_native(tmp_path_factory.mktemp("jax_native"))


def use_jax_native(monkeypatch, lib):
    """JAX's loaders with their native streamer built, as after ``make -C csrc``."""
    import unigen_tpu.data.native as J_native
    monkeypatch.setattr(J_native, "_LIB_PATH", lib)
    monkeypatch.setattr(J_native, "_LIB", None)


def _image(h, w, seed):
    """A smooth uint8 image (small PNGs; the resize sees structure)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = rng.integers(0, 256, size=3)
    img = (base + 3 * x[..., None] + 5 * y[..., None] + rng.integers(0, 40, (h, w, 3))) % 256
    return img.astype(np.uint8)


def _pil_png(arr, mode=None):
    img = PIL.fromarray(arr)
    if mode == "P4":
        img = img.quantize(12)
    elif mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _filter_rows(rows, ft, bpp):
    """The PNG filter ``ft`` applied to [H, stride] uint8 rows."""
    rows = rows.astype(np.int64)
    prev = np.vstack([np.zeros((1, rows.shape[1]), np.int64), rows[:-1]])
    left = np.hstack([np.zeros((rows.shape[0], bpp), np.int64), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros((rows.shape[0], bpp), np.int64), prev[:, :-bpp]])
    if ft == 0:
        pred = 0
    elif ft == 1:
        pred = left
    elif ft == 2:
        pred = prev
    elif ft == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((rows - pred) & 255).astype(np.uint8)


def _png(w, h, color, raw, interlace=0):
    """A PNG of 8-bit pixels whose inflated IDAT stream is ``raw``."""
    def chunk(t, body):
        return (len(body).to_bytes(4, "big") + t + body
                + zlib.crc32(t + body).to_bytes(4, "big"))
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, color, 0, 0, interlace])
    return (D.PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _png_with_filters(arr, filters):
    """(PNG bytes, inflated stream) of an 8-bit grey / grey+alpha / RGB /
    RGBA image whose row y uses ``filters[y % len(filters)]``."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * ch)
    filtered = {ft: _filter_rows(rows, ft, ch) for ft in set(filters)}
    raw = b"".join(bytes([filters[y % len(filters)]])
                   + filtered[filters[y % len(filters)]][y].tobytes() for y in range(h))
    return _png(w, h, {1: 0, 2: 4, 3: 2, 4: 6}[ch], raw), raw


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _shard(path, start, n, size=16, bad=True):
    """n samples: PNG images (sizes cycling through size x size and two
    other aspects), json captions (short + long, long only with ``<person>``
    and a stripped prefix, a dict long caption) or txt; one corrupt image."""
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            key = f"{i:05d}"
            h, w = ((size, size), (size, size + 6), (size + 10, size))[i % 3]
            _add(tf, f"{key}.png", _pil_png(_image(h, w, i)))
            if i % 4 == 0:
                _add(tf, f"{key}.txt", f"a plain caption {i}".encode())
            else:
                meta = ({"prompt": f"The image shows <person> with cat {i}",
                         "short_caption": f"cat {i}"} if i % 4 == 1 else
                        {"caption": f"In this image, a <person> {i}"} if i % 4 == 2 else
                        {"Task2": {"Caption": f"This image depicts dog {i}"}, "Task1": f"dog {i}"})
                _add(tf, f"{key}.json", json.dumps(meta).encode())
        if bad:
            _add(tf, f"{start + n:05d}x.png", b"\x89PNG\r\n\x1a\n broken")
            _add(tf, f"{start + n:05d}x.txt", b"caption of a broken image")


def _close(got, want, exact):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 2 / 127.5 + 1e-6
    assert (diff > 1e-6).mean() < 0.01


def _same_batches(jax_it, port_it, n, exact=True):
    for _ in range(n):
        j, p = next(jax_it), next(port_it)
        assert set(j) == set(p)
        for k in j:
            if isinstance(j[k], np.ndarray):
                _close(p[k], j[k], exact or k not in ("images",))
            else:
                assert p[k] == j[k], k


# ------------------------------------------------------------------ decoder --

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P4", "1"])
def test_decode_png_matches_pil(mode):
    data = _pil_png(_image(23, 37, 1), mode)
    want = np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(D.decode_image(data), want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decode_png_every_filter(channels):
    """Rows written with each of the five filters (and all five in turn)
    decode to the encoded pixels and to PIL's; the native unfilter equals
    the numpy reference."""
    arr = _image(11, 19, channels)[:, :, :channels] if channels > 1 else _image(11, 19, 0)[:, :, 0]
    if channels == 2:
        arr = np.dstack([_image(11, 19, 5)[:, :, 0], _image(11, 19, 6)[:, :, 1]])
    if channels == 4:
        arr = np.dstack([_image(11, 19, 7), _image(11, 19, 8)[:, :, :1]])
    rgb = np.repeat(arr[..., None], 3, 2) if channels == 1 else \
        np.repeat(arr[..., :1], 3, 2) if channels == 2 else arr[..., :3]
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        data, raw = _png_with_filters(arr, filters)
        np.testing.assert_array_equal(D.decode_image(data), rgb)
        np.testing.assert_array_equal(D.decode_image(data),
                                      np.asarray(PIL.open(io.BytesIO(data)).convert("RGB")))
        stride = 19 * channels
        np.testing.assert_array_equal(N.png_unfilter(raw, 11, stride, channels),
                                      D.png_unfilter_numpy(raw, 11, stride, channels))


def test_decode_failures():
    """A broken image is ``CorruptImage`` (a skipped sample); a JPEG-compressed
    TIFF raises ``UnsupportedImageFormat`` naming the compression (the port
    imports no PIL). An interlaced PNG short of its passes' bytes is broken;
    a 16-bit PNG decodes as PIL's."""
    png = _pil_png(_image(8, 8, 0))
    for bad in (b"not an image", png[:40], png[:-20],
                png[:20] + bytes([png[20] ^ 1]) + png[21:]):
        with pytest.raises(D.CorruptImage):
            D.decode_image(bad)
    with pytest.raises(D.CorruptImage, match="filter type 7"):
        D.decode_image(_png(4, 4, 0, bytes([0, 1, 2, 3, 4]) * 3 + bytes([7, 1, 2, 3, 4])))
    buf = io.BytesIO()
    PIL.fromarray(_image(8, 8, 0)).save(buf, format="TIFF", compression="jpeg")
    with pytest.raises(D.UnsupportedImageFormat, match="TIFF with JPEG compression"):
        D.decode_image(buf.getvalue())
    with pytest.raises(D.CorruptImage, match="truncated PNG pixels"):
        D.decode_image(_png(4, 4, 0, bytes(20), interlace=1))
    buf = io.BytesIO()
    PIL.fromarray(_image(8, 8, 0)[:, :, 0].astype(np.uint16) * 257).save(buf, format="PNG")
    np.testing.assert_array_equal(D.decode_image(buf.getvalue()),
                                  np.asarray(PIL.open(io.BytesIO(buf.getvalue())).convert("RGB")))


def test_loaders_raise_on_an_undecodable_format(tmp_path):
    """A JPEG 2000 file under a .jpg name (PIL reads it, the port does not):
    both readers stop, naming the format, rather than skip the sample."""
    path = str(tmp_path / "jp2.tar")
    buf = io.BytesIO()
    PIL.fromarray(_image(8, 8, 0)).save(buf, format="JPEG2000")
    with tarfile.open(path, "w") as tf:
        _add(tf, "00000.jpg", buf.getvalue())
        _add(tf, "00000.txt", b"a caption")
    for native in (False, True):
        ds = P_t2i.Text2ImageDataset([path], per_device_batch_size=1, resolution=8,
                                     use_native=native)
        with pytest.raises(RuntimeError, match="JPEG 2000 image: the port reads"):
            next(iter(ds))


def test_native_library_builds_from_the_port(tmp_path):
    """The library is keyed on the source and flags and lives in the
    port's build directory; JAX's ``csrc/`` is not touched."""
    path = N.build()
    assert path.parent == N.BUILD_DIR and path.name.startswith("libtarloader-")
    assert N.load_library() is N.load_library()
    assert N.SOURCE == N._PKG / "csrc" / "tarloader.cpp"
    assert N.SOURCES == (N.SOURCE, *(N._PKG / "csrc" / f"{name}.cpp" for name in (
        "jpeg", "webp_lossy", "webp_lossless", "gif", "bmp", "tiff")))


@pytest.mark.parametrize("loader", ["llava", "dpo", "imagenet", "t2i_python", "t2i_native"])
def test_loaders_raise_when_the_native_library_cannot_build(tmp_path, monkeypatch, loader):
    """A compiler that fails, with nothing built: every loader raises
    ``NativeLibraryError``; none takes it for a bad sample (a zero image,
    a skipped pair, file or sample)."""
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(N.NativeLibraryError, match="false failed"):
        if loader == "llava":
            paths, root = _llava_files(tmp_path, (16, 16))
            ds = P_llava.LlavaDataset(paths, root, MockTokenizer(), 2, max_length=48,
                                      visual_mode="vq", resolution=16)
        elif loader == "dpo":
            paths, root = _dpo_files(tmp_path, 4)
            ds = P_dpo.DPODataset(paths, root, 2, resolution=16)
        elif loader == "imagenet":
            (tmp_path / "n01440764").mkdir()
            with open(tmp_path / "n01440764" / "x.png", "wb") as f:
                f.write(_pil_png(_image(16, 16, 0)))
            ds = P_imagenet.ImageNetDataset(str(tmp_path), 1, image_size=16)
        else:
            _shard(str(tmp_path / "s.tar"), 0, 3)
            ds = P_t2i.Text2ImageDataset([str(tmp_path / "s.tar")], 2, resolution=16,
                                         use_native=loader == "t2i_native")
        next(iter(ds))


# --------------------------------------------------------------- transforms --

@pytest.mark.parametrize("hw", [(16, 16), (16, 22), (26, 16), (9, 12), (40, 33)])
def test_transforms_match_jax(hw):
    arr = _image(*hw, seed=hw[0] * 7 + hw[1])
    exact = hw == (16, 16)
    _close(P_transform.image_transform(arr, 16), J_transform.image_transform(arr, 16), exact)
    _close(P_transform.image_transform(arr, 16, normalize=False),
           J_transform.image_transform(arr, 16, normalize=False), exact)
    got, want = P_transform.pad_image(arr, (24, 20)), J_transform.pad_image(arr, (24, 20))
    assert got.dtype == want.dtype == np.uint8
    _close(got.astype(np.float64) / 127.5, want.astype(np.float64) / 127.5, False)


# ------------------------------------------------------------- tar shards --

def test_brace_expand_and_tar_iteration_match_jax(tmp_path):
    assert P_t2i.brace_expand("s-{000..011}.tar") == J_t2i.brace_expand("s-{000..011}.tar")
    path = str(tmp_path / "s.tar")
    _shard(path, 0, 6)
    assert list(P_t2i.iterate_tar_samples(path)) == list(J_t2i.iterate_tar_samples(path))
    assert list(P_t2i.iterate_tar_samples(str(tmp_path / "missing.tar"))) == []
    with pytest.raises(FileNotFoundError, match="none of the shards exists"):
        P_t2i.Text2ImageDataset([str(tmp_path / "gone-{0..2}.tar")], 2, use_native=False)
    P_t2i.Text2ImageDataset([str(tmp_path / "gone-0.tar"), path], 2)   # one is enough
    pipe = f"pipe:cat {path}"
    assert list(P_t2i.iterate_tar_samples(pipe)) == list(J_t2i.iterate_tar_samples(pipe))


@pytest.mark.parametrize("caption_prompt", [False, True])
def test_text2image_matches_jax(tmp_path, caption_prompt):
    """The Python reader over three shards (one through ``pipe:``): the same
    batches, captions and skips as JAX's, the images exact at the target
    size and within 2 levels where resized."""
    shards = []
    for s in range(3):
        _shard(str(tmp_path / f"s-{s:02d}.tar"), 10 * s, 7)
        shards.append(str(tmp_path / f"s-{s:02d}.tar"))
    for spec in ([str(tmp_path / "s-{00..02}.tar")], [shards[0], f"pipe:cat {shards[1]}"]):
        kw = dict(per_device_batch_size=4, resolution=16, short_caption_ratio=0.5,
                  add_caption_prompt=caption_prompt, person_substitution="man", seed=3,
                  num_batches=6, use_native=False)
        j = list(J_t2i.Text2ImageDataset(spec, **kw))
        p = list(P_t2i.Text2ImageDataset(spec, **kw))
        assert len(p) == len(j) == 6
        for a, b in zip(p, j):
            assert a["input_ids"] == b["input_ids"]
            _close(a["images"], b["images"], False)
        captions = [c for b in p for c in b["input_ids"]]
        assert not any("<person>" in c or c.startswith("The image") for c in captions)
        assert any(c.split("\n")[-1].startswith("cat ") for c in captions)
        assert any("Man with cat" in c for c in captions)
        assert all(c.split("\n")[0] in P_t2i.CAPTION_PROMPTS for c in captions) == caption_prompt


def test_native_stream_equals_python_reader(tmp_path):
    """One pass over unresampled shards: the native streamer gives the
    Python reader's samples (each shard in order; the shard order its own),
    and the resampled stream never ends."""
    shards = [str(tmp_path / f"n-{s}.tar") for s in range(3)]
    for s, path in enumerate(shards):
        _shard(path, 10 * s, 5)
    py = {path: list(P_t2i.iterate_tar_samples(path)) for path in shards}
    for path in shards:
        assert list(N.NativeTarStream([path], seed=0, resample=False)) == py[path]
    stream = list(N.NativeTarStream(shards, seed=5, resample=False))
    by_key = sorted(stream, key=lambda s: s["__key__"])
    assert by_key == sorted((s for v in py.values() for s in v), key=lambda s: s["__key__"])
    resampled = N.NativeTarStream(shards, seed=1, resample=True)
    it = iter(resampled)
    assert len([next(it) for _ in range(40)]) == 40
    resampled.close()


def test_text2image_native_matches_jax_native(tmp_path, monkeypatch, jax_native_lib):
    """With JAX's native loader built from its own source, the default
    datasets give the same batches."""
    use_jax_native(monkeypatch, jax_native_lib)
    shards = []
    for s in range(2):
        _shard(str(tmp_path / f"s-{s}.tar"), 10 * s, 6)
        shards.append(str(tmp_path / f"s-{s}.tar"))
    kw = dict(per_device_batch_size=3, resolution=16, seed=4, num_batches=5)
    j, p = J_t2i.Text2ImageDataset(shards, **kw), P_t2i.Text2ImageDataset(shards, **kw)
    assert j.use_native is True and p.use_native is True
    for a, b in zip(list(p), list(j)):
        assert a["input_ids"] == b["input_ids"]
        _close(a["images"], b["images"], False)


# ------------------------------------------------------------------ parquet --

def test_parquet_matches_jax(tmp_path, monkeypatch):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    files = []
    for f in range(2):
        texts = [("word " * (7 * i + 3 * f + 1)).strip() if i % 5 else "" for i in range(13)]
        path = str(tmp_path / f"lm-{f}.parquet")
        pq.write_table(pa.table({"content": texts}), path)
        files.append(path)
    files.append(str(tmp_path / "missing.parquet"))
    for kw in (dict(), dict(process_index=1, process_count=3, subsample=0.7, seed=2)):
        args = dict(files=files, per_device_batch_size=3, max_length_chars=40, **kw)
        j, p = iter(J_lm.ParquetTextDataset(**args)), iter(P_lm.ParquetTextDataset(**args))
        for _ in range(12):
            assert next(p) == next(j)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        next(iter(P_lm.ParquetTextDataset(files, 2)))
    with pytest.raises(ValueError, match="no parquet files"):
        P_lm.ParquetTextDataset([], 2)


# -------------------------------------------------------------------- LLaVA --

def _llava_files(tmp_path, size):
    root = tmp_path / "llava_images"
    root.mkdir(exist_ok=True)
    for i in range(4):
        with open(root / f"im{i}.png", "wb") as f:
            f.write(_pil_png(_image(size[0], size[1], 40 + i)))
    with open(root / "broken.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n broken")
    convs = [[{"from": "human", "value": f"<image>\nWhat is {i}?"},
              {"from": "gpt", "value": f"It is thing {i}."},
              {"from": "human", "value": "And then?"}, {"from": "gpt", "value": "Nothing."}]
             for i in range(5)]
    a = [{"image": f"im{i}.png", "conversations": convs[i][:2] if i % 2 else convs[i]}
         for i in range(4)] + [{"image": "broken.png", "conversations": convs[4][:2]},
                               {"image": "missing.png", "conversations": convs[0][:2]}]
    b = [{"image": f"im{3 - i}.png", "conversations": [
        {"role": "user", "content": "<image> caption?"},
        {"role": "assistant", "content": f"A picture {i}."}]} for i in range(3)]
    with open(tmp_path / "a.jsonl", "w") as f:
        f.write("\n".join(json.dumps(x) for x in a) + "\n")
    with open(tmp_path / "b.json", "w") as f:
        json.dump(b, f)
    return [str(tmp_path / "a.jsonl"), str(tmp_path / "b.json")], str(root)


@pytest.mark.parametrize("mode,size,extra", [
    ("vq", (16, 16), dict(resolution=16)),
    ("vq", (20, 16), dict(resolution=16, prompt_type="plain", sampling_ratios=[0.3, 0.7])),
    ("siglip", (384, 384), dict(with_system=True)),
    ("naflex", (32, 64), dict(naflex_patch_size=8, naflex_max_patches=32)),
    ("naflex", (40, 56), dict(naflex_patch_size=8, naflex_max_patches=32)),
])
def test_llava_dataset_matches_jax(tmp_path, mode, size, extra):
    paths, root = _llava_files(tmp_path, size)
    tok = MockTokenizer()
    args = dict(per_device_batch_size=3, max_length=48, visual_mode=mode, seed=5, **extra)
    if extra.get("prompt_type") == "plain":
        paths = paths[1:] + paths[1:]
    j = iter(J_llava.LlavaDataset(paths, root, tok, **args))
    p = iter(P_llava.LlavaDataset(paths, root, tok, **args))
    exact = size in ((16, 16), (384, 384), (32, 64))
    for _ in range(4):
        a, b = next(p), next(j)
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], exact or k != "images")


# ---------------------------------------------------------------------- DPO --

def _dpo_files(tmp_path, n, size=16, bad=(3,)):
    root = tmp_path / "dpo_images"
    root.mkdir(exist_ok=True)
    items = []
    for i in range(n):
        for side in ("c", "r"):
            with open(root / f"{side}{i}.png", "wb") as f:
                f.write(b"broken" if i in bad and side == "r" else
                        _pil_png(_image(size, size + 4 * (i % 2), 100 + 2 * i + (side == "r"))))
        items.append({"prompt": f"prompt {i}", "chosen": f"c{i}.png", "rejected": f"r{i}.png"})
    with open(tmp_path / "pairs.jsonl", "w") as f:
        f.write("\n".join(json.dumps(x) for x in items) + "\n")
    with open(tmp_path / "pairs2.json", "w") as f:
        json.dump(items[::-1], f)
    return [str(tmp_path / "pairs.jsonl"), str(tmp_path / "pairs2.json")], str(root)


@pytest.mark.parametrize("strategy,numbers", [("all", None), ("first", ["3", "50%"]),
                                              ("end", ["40%", "2"]), ("random", ["5", "30%"])])
def test_dpo_dataset_matches_jax(tmp_path, strategy, numbers):
    paths, root = _dpo_files(tmp_path, 9)
    args = dict(per_device_batch_size=2, resolution=16, sampling_strategy=strategy,
                sampling_number=numbers, seed=1)
    j, p = J_dpo.DPODataset(paths, root, **args), P_dpo.DPODataset(paths, root, **args)
    assert p.items == j.items
    for _ in range(2):          # two epochs: the second reshuffles
        jb, pb = list(j), list(p)
        assert len(jb) == len(pb) > 0
        for a, b in zip(pb, jb):
            assert a["batch_prompt_list"] == b["batch_prompt_list"]
            for k in ("batch_chosen_image", "batch_rejected_image"):
                _close(a[k], b[k], False)
    import random
    items = [{"i": i} for i in range(10)]
    for strat, num in (("first", "25%"), ("end", "3"), ("random", "4"), ("all", "1")):
        assert P_dpo.apply_sampling(items, strat, num, random.Random(2)) == \
            J_dpo.apply_sampling(items, strat, num, random.Random(2))


# ----------------------------------------------------------------- ImageNet --

def test_imagenet_matches_jax(tmp_path):
    root = tmp_path / "imagenet"
    for c, wnid in enumerate(("n01440764", "n01443537", "n99999999")):
        (root / wnid).mkdir(parents=True)
        for i in range(3):
            with open(root / wnid / f"x{i}.png", "wb") as f:
                f.write(b"bad" if (c, i) == (1, 1) else _pil_png(_image(16, 16, 10 * c + i)))
    (root / "notes.txt").write_text("not a class folder")
    assert P_imagenet.load_synset_mapping() == J_imagenet.load_synset_mapping()
    for kw in (dict(), dict(prefix_prompt="a photo of ", seed=2)):
        j = iter(J_imagenet.ImageNetDataset(str(root), 4, image_size=16, **kw))
        p = iter(P_imagenet.ImageNetDataset(str(root), 4, image_size=16, **kw))
        _same_batches(j, p, 5)


# ---------------------------------------------------- combined, text helpers --

def test_combined_loader_matches_jax():
    def flows():
        return {"a": [1, 2, 3], "b": iter(range(100)), "c": ["x", "y"]}
    for mode in ("max_size_cycle", "min_size"):
        j = list(zip(range(9), J_combined.combined_loader(flows(), mode)))
        p = list(zip(range(9), P_combined.combined_loader(flows(), mode)))
        assert p == j
    assert list(P_combined.combined_loader({"a": []})) == []


def test_conversation_and_dataflows_match_jax():
    for name in ("qwen_1_5", "qwen_2.5"):
        jc, pc = J_conv.conv_templates[name].copy(), P_conv.conv_templates[name].copy()
        for c in (jc, pc):
            c.append_message(c.roles[0], "hi")
            c.append_message(c.roles[1], None)
        assert pc.get_prompt() == jc.get_prompt()
    for caption in ("The image shows a red cat on a mat", "in this image, we see this is a dog"):
        assert P_flows.question_prompt(caption) == J_flows.question_prompt(caption)
        assert P_flows.remove_caption_prefix(caption) == J_flows.remove_caption_prefix(caption)
    text = "Is there a cat?; Is the cat red?; ; garbage"
    assert P_flows.parse_questions(text) == J_flows.parse_questions(text) == \
        ["Is there a cat?", "Is the cat red?", "garbage?"]
    gen = lambda p: "Is there a cat?; Is the cat red?"  # noqa: E731
    prompts = [{"id": "x", "prompt": "a red cat"}, {"item_id": 3, "prompt": "The image shows b"}]
    assert P_flows.build_question_table(prompts, gen) == J_flows.build_question_table(prompts, gen)
    answer = lambda img, q: "Yes" if "cat" in q else "no idea"  # noqa: E731
    qs = [["Is there a cat?", "Is it red?"]]
    assert P_flows.pseudo_label_images(["img1"], qs, answer) == \
        J_flows.pseudo_label_images(["img1"], qs, answer)
    for cands in ([{"image": "a.png", "score": 1.0}, {"image": "b.png", "score": 0.2}],
                  [{"image": "a", "score": 0.5}, {"image": "b", "score": 0.5}]):
        assert P_flows.select_preference_pairs(cands) == J_flows.select_preference_pairs(cands)


def test_prefetch_keeps_order_errors_and_stops():
    import threading
    from unigen_tpu_torch.data.prefetch import prefetch

    def items(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise ValueError(f"bad item {i}")
            yield {"i": i}
    assert list(prefetch(items(7))) == [{"i": i} for i in range(7)]
    it = prefetch(items(9, fail_at=4))
    assert [next(it)["i"] for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="bad item 4"):
        next(it)
    before = threading.active_count()
    it = prefetch(items(10 ** 9))
    assert next(it) == {"i": 0}
    it.close()
    assert threading.active_count() == before
