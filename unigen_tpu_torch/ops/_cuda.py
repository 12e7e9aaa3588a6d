"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``. Libraries are built at first use
into ``unigen_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash
of the source so that an edited source is rebuilt. ``build()`` starts one
``nvcc`` per source and waits for all of them, so a cold start costs the
slowest single compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("attention", "fused_conv", "int4", "int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C entry points of each source; every one returns a cudaError_t as int.
SIGNATURES = {
    "attention": {
        # dtype, q, k, v, kvalid, q_start (or None), out, scratch (or None), B, Lq, S, H,
        # KVH, Dh, nsplit, scale, stream
        "chunk_attention_launch": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _P),
        # dtype, q, k, v, meta, out, lse (or None), B, L, H, KVH, Dh, scale, stream
        "flash_attention_launch": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        # dtype, q, k, v, meta, dout, lse, scratch, dq, dk, dv, B, L, H, KVH, Dh, splits,
        # scale, stream
        "flash_attention_backward_launch": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _I, _I, _F, _P),
    },
    "fused_conv": {
        # dtype, x, ab, w, bias, out, B, H, W, C, Cout, stream
        "conv3x3_gn_swish_launch": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # x dtype, x, scale/bias dtype, scale, bias, ab, scratch, B, H*W, C, groups, nsplit,
        # eps, stream
        "gn_affine_launch": (_I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    },
    "int4": {
        # x, packed, scale4, act_scale, bias, bias dtype, out, out dtype, scratch (or None),
        # T, K, N, n, group, stream
        "w4a8_dense_launch": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P),
        # dtype, x, x_int8 (or None), act_scale (or None), amax (or None), T, K, stream
        "quantize_activations_launch": (_I, _P, _P, _P, _P, _I, _I, _P),
    },
    "int8": {
        # acc, acc dtype, act_scale, scale (or None), bias (or None), bias dtype, out,
        # out dtype, M, n, ld, stream
        "w8a8_epilogue_launch": (_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all at once.

    Returns ``{name: {"seconds": s, "log": ptxas output}}`` for the sources
    compiled by this call. Raises with the compiler output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    done = {}
    failed = []
    for name, out, tmp, t0, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    the argument and result types of its entry points declared."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, where the kernel is queued."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype) -> int:
    """0 = float32, 1 = bfloat16 (the two types the kernels are built for)."""
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")
