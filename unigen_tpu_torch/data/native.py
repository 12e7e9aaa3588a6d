"""The port's native data library (``unigen_tpu_torch/csrc/tarloader.cpp`` and
``csrc/jpeg.cpp``): the threaded tar-shard streamer, the PNG row unfilter and
the JPEG decoder, over ``ctypes``.

The library is compiled from both sources at first use by ``g++ -O3
-std=c++17 -fPIC -Wall -Wextra -pthread -shared`` into
``unigen_tpu_torch/build/`` (as ``ops/_cuda.py`` builds the CUDA kernels), its
file name keyed on a hash of the sources and the flags, so an edited source is
rebuilt. A failed build
raises: nothing falls back to the Python reader because the compiler is
missing, and the loaders let ``NativeLibraryError`` through where they skip
a bad sample. ``NativeTarStream`` yields the same sample dicts as
``text2image.iterate_tar_samples``, so ``Text2ImageDataset`` can swap
backends; ``png_unfilter`` reverses the PNG filters and ``jpeg_decode``
decodes a JPEG for ``data/decode.py``. Both release the GIL (``ctypes``
does), so a loader's prefetch thread decodes beside the training loop.
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
JPEG_SOURCE = _PKG / "csrc" / "jpeg.cpp"
SOURCES = (SOURCE, JPEG_SOURCE)
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()      # a loader's prefetch thread may be the first caller


class NativeLibraryError(RuntimeError):
    """The library could not be built or loaded: a fault of the machine,
    never of a sample."""


class JpegError(ValueError):
    """``jpeg_decode`` failed: a broken stream (PIL raises on it too) or,
    with ``unsupported`` set, a JPEG variant the decoder does not read."""

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
    """The library's path, compiled first if it is not there; raises with
    the compiler's output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which(cxx) is None:
        raise NativeLibraryError(f"{cxx} not found: the native data library needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        names = " + ".join(src.name for src in SOURCES)
        raise NativeLibraryError(f"{cxx} failed for {names}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                              ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode_rgb.restype = ctypes.c_int
    lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                    ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
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


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3], the pixels of PIL's
    ``Image.open(b).convert("RGB")`` (``csrc/jpeg.cpp``); raises
    ``JpegError`` where PIL raises, and with ``unsupported`` set for a
    variant the decoder does not read (arithmetic, lossless, hierarchical,
    12-bit)."""
    lib = load_library()
    info = (ctypes.c_int * 5)()
    msg = ctypes.create_string_buffer(256)
    rc = lib.jpeg_info(data, len(data), info, msg, len(msg))
    if rc == 0:
        out = np.empty((info[1], info[0], 3), np.uint8)
        rc = lib.jpeg_decode_rgb(data, len(data), out.ctypes.data, out.nbytes, msg, len(msg))
        if rc == 0:
            return out
    raise JpegError(msg.value.decode("utf-8", "replace"), unsupported=rc == 2)


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
