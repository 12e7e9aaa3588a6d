"""The port's native data library (``unigen_tpu_torch/csrc/tarloader.cpp`` and
the image decoders beside it: ``jpeg.cpp``, ``webp_lossy.cpp``,
``webp_lossless.cpp``, ``gif.cpp``, ``bmp.cpp`` and ``tiff.cpp``): the
threaded tar-shard streamer, the PNG row unfilter and the decoders, over
``ctypes``.

The library is compiled from all the sources at first use by ``g++ -O3
-std=c++17 -fPIC -Wall -Wextra -pthread`` (one process a source, in
parallel, then linked with ``-shared``) into
``unigen_tpu_torch/build/`` (as ``ops/_cuda.py`` builds the CUDA kernels), its
file name keyed on a hash of the sources and the flags, so an edited source is
rebuilt. A failed build
raises: nothing falls back to the Python reader because the compiler is
missing, and the loaders let ``NativeLibraryError`` through where they skip
a bad sample. ``NativeTarStream`` yields the same sample dicts as
``text2image.iterate_tar_samples``, so ``Text2ImageDataset`` can swap
backends; ``png_unfilter`` reverses the PNG filters, ``jpeg_decode``,
``webp_vp8_decode``, ``webp_vp8l_decode``, ``webp_alpha_decode``,
``gif_decode``, ``bmp_decode``, ``tiff_lzw_decode``, ``tiff_packbits_decode``,
``tiff_unpredict`` and ``tiff_to_rgb`` decode for ``data/decode.py`` and the
format modules beside it. All release the GIL (``ctypes`` does), so a loader's prefetch
thread decodes beside the training loop.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tarloader.cpp"
SOURCES = (SOURCE, *(_PKG / "csrc" / f"{name}.cpp" for name in (
    "jpeg", "webp_lossy", "webp_lossless", "gif", "bmp", "tiff")))
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()      # a loader's prefetch thread may be the first caller


class NativeLibraryError(RuntimeError):
    """The library could not be built or loaded: a fault of the machine,
    never of a sample."""


class DecodeError(ValueError):
    """A decoder of the library failed: a broken image (PIL raises on it
    too) or, with ``unsupported`` set, a variant the decoder does not read."""

    def __init__(self, msg: str, unsupported: bool = False):
        super().__init__(msg)
        self.unsupported = unsupported


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtarloader-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there (one compiler
    process a source, all started together, then one link); raises with the
    compiler's output if a compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which(cxx) is None:
        raise NativeLibraryError(f"{cxx} not found: the native data library needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objects = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o") for src in SOURCES]
    compile_flags = [f for f in CXX_FLAGS if f != "-shared"]
    try:
        procs = [subprocess.Popen([cxx, *compile_flags, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objects)]
        failed = [(src, proc.communicate()[0], proc.returncode)
                  for src, proc in zip(SOURCES, procs)]
        failed = [(src, log) for src, log, rc in failed if rc != 0]
        if not failed:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, objects)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                failed = [(Path("the link"), proc.stdout + proc.stderr)]
        if failed:
            names = " + ".join(src.name for src, _ in failed)
            raise NativeLibraryError(f"{cxx} failed for {names}:\n"
                                     + "".join(log for _, log in failed))
        os.replace(tmp, out)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library (built at the first call); raises
    ``NativeLibraryError`` if it cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = build()
            try:
                _LIB = _load(path)
            except (OSError, AttributeError) as e:
                raise NativeLibraryError(f"cannot load {path}: {e}") from e
    return _LIB


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tls_open.restype = ctypes.c_void_p
    lib.tls_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_uint, ctypes.c_int, ctypes.c_int]
    lib.tls_next.restype = ctypes.c_long
    lib.tls_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
    lib.tls_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    lib.tls_close.argtypes = [ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                 ctypes.c_int, ctypes.c_void_p]
    for prefix in ("jpeg", "gif", "bmp"):
        info, decode = getattr(lib, f"{prefix}_info"), getattr(lib, f"{prefix}_decode_rgb")
        info.restype = decode.restype = ctypes.c_int
        info.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                         ctypes.c_char_p, ctypes.c_int]
        decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
                           ctypes.c_char_p, ctypes.c_int]
    for name in ("webp_vp8_decode", "webp_vp8l_decode", "webp_alpha_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
                       ctypes.c_char_p, ctypes.c_int]
    lib.tiff_unpredict.restype = None
    lib.tiff_unpredict.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.tiff_to_rgb.restype = None
    lib.tiff_to_rgb.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    return lib


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """``height`` rows of (filter byte + ``stride`` bytes) -> [height, stride]
    uint8 with the filters reversed; raises ``ValueError`` on a filter type
    outside 0-4."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{len(raw)} bytes for {height} rows of {stride + 1}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    bad = load_library().png_unfilter(src.ctypes.data, height, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type {src[(bad - 1) * (stride + 1)]}")
    return out


def _decode_rgb(prefix: str, data: bytes) -> np.ndarray:
    """``<prefix>_info`` then ``<prefix>_decode_rgb``: uint8 [H, W, 3]."""
    lib = load_library()
    info = (ctypes.c_int * 5)()
    msg = ctypes.create_string_buffer(256)
    rc = getattr(lib, f"{prefix}_info")(data, len(data), info, msg, len(msg))
    if rc == 0:
        out = np.empty((info[1], info[0], 3), np.uint8)
        rc = getattr(lib, f"{prefix}_decode_rgb")(data, len(data), out.ctypes.data, out.nbytes,
                                                  msg, len(msg))
        if rc == 0:
            return out
    raise DecodeError(msg.value.decode("utf-8", "replace"), unsupported=rc == 2)


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3], the pixels of PIL's
    ``Image.open(b).convert("RGB")`` (``csrc/jpeg.cpp``); raises
    ``DecodeError`` where PIL raises, and with ``unsupported`` set for a
    variant the decoder does not read (arithmetic, lossless, hierarchical,
    12-bit)."""
    return _decode_rgb("jpeg", data)


def gif_decode(data: bytes) -> np.ndarray:
    """GIF bytes -> uint8 [H, W, 3], frame 0 as PIL gives it
    (``csrc/gif.cpp``); raises ``DecodeError`` where PIL raises."""
    return _decode_rgb("gif", data)


def bmp_decode(data: bytes) -> np.ndarray:
    """BMP bytes -> uint8 [H, W, 3] as PIL gives them (``csrc/bmp.cpp``);
    raises ``DecodeError`` where PIL raises."""
    return _decode_rgb("bmp", data)


def _webp_call(name: str, payload: bytes, shape) -> np.ndarray:
    out = np.empty(shape, np.uint8)
    msg = ctypes.create_string_buffer(256)
    if getattr(load_library(), name)(payload, len(payload), shape[1], shape[0],
                                     out.ctypes.data, msg, len(msg)):
        raise DecodeError(msg.value.decode("utf-8", "replace"))
    return out


def webp_vp8_decode(payload: bytes, width: int, height: int) -> np.ndarray:
    """A "VP8 " chunk's payload -> uint8 [H, W, 3] RGB, as libwebp decodes
    it (``csrc/webp_lossy.cpp``); raises ``DecodeError`` where it fails."""
    return _webp_call("webp_vp8_decode", payload, (height, width, 3))


def webp_vp8l_decode(payload: bytes, width: int, height: int) -> np.ndarray:
    """A "VP8L" chunk's payload -> uint8 [H, W, 4] RGBA
    (``csrc/webp_lossless.cpp``); raises ``DecodeError`` where libwebp fails."""
    return _webp_call("webp_vp8l_decode", payload, (height, width, 4))


def webp_alpha_decode(payload: bytes, width: int, height: int) -> np.ndarray:
    """An "ALPH" chunk's payload -> uint8 [H, W] alpha
    (``csrc/webp_lossless.cpp``); raises ``DecodeError`` where libwebp fails."""
    return _webp_call("webp_alpha_decode", payload, (height, width))


def _tiff_codec(name: str, data: bytes, size: int) -> np.ndarray:
    out = np.zeros(size, np.uint8)
    msg = ctypes.create_string_buffer(256)
    rc = getattr(load_library(), name)(data, len(data), out.ctypes.data, size, msg, len(msg))
    if rc < 0:
        raise DecodeError(msg.value.decode("utf-8", "replace"), unsupported=rc == -2)
    return out


def tiff_lzw_decode(data: bytes, size: int) -> np.ndarray:
    """A TIFF LZW strip or tile -> its first ``size`` bytes, as libtiff's
    LZWDecode gives them (``csrc/tiff.cpp``); raises ``DecodeError`` where it
    fails (a corrupt table, too little data), with ``unsupported`` set for
    old-style LZW."""
    return _tiff_codec("tiff_lzw_decode", data, size)


def tiff_packbits_decode(data: bytes, size: int) -> np.ndarray:
    """A TIFF PackBits strip or tile -> its first ``size`` bytes, as
    libtiff's PackBitsDecode gives them; raises ``DecodeError`` where it
    fails (too little data)."""
    return _tiff_codec("tiff_packbits_decode", data, size)


def tiff_unpredict(buf: np.ndarray, rows: int, row_bytes: int, samples: int, bits: int,
                   big_endian: bool) -> None:
    """Undoes TIFF predictor 2 (horizontal differencing) in place on
    ``rows`` rows of ``row_bytes``, ``samples`` samples a pixel of 8 or 16
    bits (16-bit samples in the file's byte order)."""
    load_library().tiff_unpredict(buf.ctypes.data, rows, row_bytes, samples, bits,
                                  int(big_endian))


def tiff_to_rgb(px: np.ndarray, kind: int) -> np.ndarray:
    """[H, W, 4] uint8 bands -> uint8 [H, W, 3] by PIL's conversion ``kind``:
    0 CMYK -> RGB, 1 RGBa (associated alpha) -> RGB."""
    px = np.ascontiguousarray(px, np.uint8)
    out = np.empty(px.shape[:2] + (3,), np.uint8)
    load_library().tiff_to_rgb(px.ctypes.data, px.shape[0] * px.shape[1], kind,
                               out.ctypes.data)
    return out


def _parse_blob(raw: bytes) -> Dict:
    off = 0
    (key_len,) = struct.unpack_from("<H", raw, off)
    off += 2
    key = raw[off:off + key_len].decode("utf-8", "replace")
    off += key_len
    (n_parts,) = struct.unpack_from("<H", raw, off)
    off += 2
    sample: Dict = {"__key__": key}
    for _ in range(n_parts):
        (ext_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        ext = raw[off:off + ext_len].decode("utf-8", "replace")
        off += ext_len
        (data_len,) = struct.unpack_from("<I", raw, off)
        off += 4
        sample[ext.lower()] = raw[off:off + data_len]
        off += data_len
    return sample


class NativeTarStream:
    """Background-threaded multi-shard sample stream (the C++ core): with
    ``resample`` shards drawn with replacement forever, else one pass over
    the shards in a shuffled order."""

    def __init__(self, shards: Sequence[str], seed: int = 0, resample: bool = False,
                 queue_cap: int = 64):
        lib = load_library()
        arr = (ctypes.c_char_p * len(shards))(*[s.encode() for s in shards])
        self._lib = lib
        self._h = lib.tls_open(arr, len(shards), seed & 0xFFFFFFFF,
                               1 if resample else 0, queue_cap)
        if not self._h:
            raise RuntimeError("tls_open failed")

    def __iter__(self) -> Iterator[Dict]:
        ptr = ctypes.POINTER(ctypes.c_ubyte)()
        while self._h:
            size = self._lib.tls_next(self._h, ctypes.byref(ptr))
            if size <= 0:
                return
            raw = ctypes.string_at(ptr, size)
            self._lib.tls_free(ptr)
            yield _parse_blob(raw)

    def close(self):
        if self._h:
            self._lib.tls_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
