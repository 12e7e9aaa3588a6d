#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``unigen_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``unigen_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes (bf16), at
a ragged shape and in fp32, drives the GenEval text-to-image path
(``build_pipeline`` -> ``generate_images``) at the flagship width with random
weights, checks that the path went through every kernel, and compares a tiny
fp32 run through the kernels on the card with the plain versions on the CPU
under shared noise. Every check that fails makes the exit code nonzero. The
last line of stdout is a JSON object naming the device; the line before it
holds the kernels' measurements. Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.

``--phases`` (default: build,kernels,flagship,tiny) runs a subset, for
quick checks; adding ``profile`` traces one more warm flagship run with
``torch.profiler`` and prints where the device time goes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PHASES = ("build", "kernels", "flagship", "tiny")
OPTIONAL_PHASES = ("profile",)
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
FP32_PEAK = 67e12       # H100 SXM fp32 (non-tensor) FLOP/s
HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
PROMPTS = ("a photo of a red apple on a wooden table",
           "two dogs playing in the snow",
           "a blue bicycle leaning against a brick wall",
           "a bowl of ramen with chopsticks, studio lighting")


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def time_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _err_tol(got, ref, rtol):
    """(max |got - ref|, rtol x max(1, max |ref|))."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, rtol * max(1.0, ref.abs().max().item())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa_ms(q, k, v, mask, iters):
    """One torch call computing the same attention (a yardstick, never used by the port)."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def _attn_inputs(gen, b, lq, s, h, kvh, dh, dtype):
    import torch
    q = torch.randn((b, lq, h, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kvh, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kvh, dh), generator=gen, device="cuda").to(dtype)
    return q, k, v


def phase_chunk(gen, b, lq, lp, dtype, rtol, iters, timed):
    """Chunk attention: q [b, lq, 12, 128] against a cache of lp prefix slots
    (left pads masked out) plus the lq chunk slots. The tolerance is relative
    to the largest output magnitude."""
    import torch
    from unigen_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
    h, kvh, dh = 12, 2, 128
    s = lp + lq
    q, k, v = _attn_inputs(gen, b, lq, s, h, kvh, dh, dtype)
    pads = torch.arange(b, device="cuda") * 7 % (lp // 2)        # left pads per row
    kvalid = torch.arange(s, device="cuda")[None] >= pads[:, None]
    got = chunk_attention(q, k, v, kvalid)
    ref = chunk_attention_plain(q, k, v, kvalid)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "chunk_attention output not finite")
    print(f"  chunk_attention {dtype} q{list(q.shape)} S={s}: max_abs_err {err:.3e} "
          f"(tol {tol:.2e})")
    check(err <= tol, f"chunk_attention {dtype} S={s} disagrees with its plain version")
    if not timed:
        return None
    ms = time_ms(lambda: chunk_attention(q, k, v, kvalid), iters)
    plain_ms = time_ms(lambda: chunk_attention_plain(q, k, v, kvalid), iters)
    lib_ms = sdpa_ms(q, k, v, kvalid[:, None, None, :], iters)
    flops = 4.0 * h * dh * lq * kvalid.sum().item()
    b_ms, by = bound(flops, nbytes(q, k, v, kvalid, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms)


def phase_flash(gen, b, l, dtype, rtol, iters, timed, ragged_bits=False):
    """Flash attention over a left-padded prefix (pad bit, causal); with
    ``ragged_bits`` also bidir_q / bidir_k / segment bits and all-pad rows."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    h, kvh, dh = 12, 2, 128
    q, k, v = _attn_inputs(gen, b, l, l, h, kvh, dh, dtype)
    pos = torch.arange(l, device="cuda")[None]
    pads = torch.arange(b, device="cuda")[:, None] * 11 % (l // 2)
    pad = pos < pads
    z = torch.zeros_like(pad)
    meta = M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)
    if ragged_bits:
        pad = pad.clone()
        pad[0] = True                                             # one all-pad row
        meta = M.AttnMeta(pad=pad, bidir_q=(pos % 5 == 0).expand(b, l) & ~pad,
                          bidir_k=(pos % 7 == 3).expand(b, l) & ~pad,
                          seg=(pos >= l // 3).to(torch.int32).expand(b, l))
    bits = M.pack_meta(meta)
    got = flash_attention(q, k, v, bits)
    ref = flash_attention_plain(q, k, v, bits)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "flash_attention output not finite")
    print(f"  flash_attention {dtype} q{list(q.shape)}{' omni/seg bits' if ragged_bits else ''}:"
          f" max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"flash_attention {dtype} L={l} disagrees with its plain version")
    if not timed:
        return None
    ms = time_ms(lambda: flash_attention(q, k, v, bits), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, bits), iters)
    vis = meta.visibility()
    lib_ms = sdpa_ms(q, k, v, vis, iters)
    # visible (q, k) pairs, plus a uniform average over all keys for each all-masked row
    dead_rows = (~vis.any(-1)).sum().item()
    flops = 4.0 * h * dh * vis.sum().item() + 2.0 * h * dh * l * dead_rows
    b_ms, by = bound(flops, nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms)


def phase_conv(gen, b, hw, c, cout, dtype, rtol, iters, timed, gn=True):
    """Fused GN + swish + conv3x3 at [b, hw, hw, c] -> cout; the tolerance is
    relative to the largest output magnitude."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops.fused_conv import conv3x3_gn_swish, conv3x3_gn_swish_plain
    x = (torch.randn((b, hw, hw, c), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    conv_p = {"kernel": (torch.randn((3, 3, c, cout), generator=gen, device="cuda")
                         * (9 * c) ** -0.5).to(dtype),
              "bias": (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(dtype)}
    gn_p = {"scale": (1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")).to(dtype),
            "bias": (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)} \
        if gn else None
    got = conv3x3_gn_swish(conv_p, gn_p, x)
    ref = conv3x3_gn_swish_plain(conv_p, gn_p, x)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "conv3x3_gn_swish output not finite")
    print(f"  conv3x3_gn_swish {dtype} x{list(x.shape)}->{cout}{'' if gn else ' (no GN)'}: "
          f"max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"conv3x3_gn_swish {dtype} {list(x.shape)} disagrees")
    if not timed:
        return None
    ms = time_ms(lambda: conv3x3_gn_swish(conv_p, gn_p, x), iters)
    plain_ms = time_ms(lambda: conv3x3_gn_swish_plain(conv_p, gn_p, x), iters)
    xc = x.permute(0, 3, 1, 2)
    wc = conv_p["kernel"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    g = min(32, c)

    def library():
        y = F.silu(F.group_norm(xc, g, gn_p["scale"], gn_p["bias"], 1e-6))
        return F.conv2d(y, wc, conv_p["bias"], padding=1)
    lib_ms = time_ms(library, iters)
    flops = 2.0 * b * hw * hw * 9 * c * cout
    b_ms, by = bound(flops, nbytes(x, conv_p["kernel"], conv_p["bias"], got)
                     + 2 * b * c * 4, BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (group_norm+silu+conv2d) "
          f"{lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms)


def run_kernel_phases(results):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    # Tolerances are relative to the largest output magnitude m (at least 1).
    # bf16 keeps 8 significant bits, so one output rounding is up to 2^-8 m;
    # the plain attention also rounds P to bf16 before P.V (attention: 2^-7 m,
    # two roundings), the plain conv rounds the conv before adding its bias and
    # sums 9 C products (conv: 2^-6 m). fp32: only the order of fp32 sums
    # differs, with TF32 off (attention 2e-5 m, conv 1e-4 m as in the CPU tests).
    print("phase: kernels (main-path shapes in bf16, a ragged shape, fp32)")
    results["chunk_attention"] = phase_chunk(gen, 8, 258, 148, bf16, 2 ** -7, 20, True)
    phase_chunk(gen, 3, 37, 61, bf16, 2 ** -7, 0, False)          # ragged: S = 98
    phase_chunk(gen, 8, 258, 148, f32, 2e-5, 0, False)
    results["flash_attention"] = phase_flash(gen, 8, 148, bf16, 2 ** -7, 20, True)
    phase_flash(gen, 3, 133, bf16, 2 ** -7, 0, False, ragged_bits=True)
    phase_flash(gen, 3, 133, f32, 2e-5, 0, False, ragged_bits=True)
    results["conv3x3_gn_swish"] = phase_conv(gen, 4, 256, 128, 128, bf16, 2 ** -6, 5, True)
    phase_conv(gen, 4, 16, 512, 512, bf16, 2 ** -6, 0, False)
    phase_conv(gen, 2, 37, 96, 80, bf16, 2 ** -6, 0, False)       # ragged tiles, C != Cout
    phase_conv(gen, 2, 37, 96, 80, bf16, 2 ** -6, 0, False, gn=False)
    phase_conv(gen, 2, 64, 256, 128, f32, 1e-4, 0, False)


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------

def _counters():
    from unigen_tpu_torch.ops.chunk_attention import chunk_attention
    from unigen_tpu_torch.ops.flash_attention import flash_attention
    from unigen_tpu_torch.ops.fused_conv import conv3x3_gn_swish
    return {"flash_attention": flash_attention, "chunk_attention": chunk_attention,
            "conv3x3_gn_swish": conv3x3_gn_swish}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def profile_flagship(run_once, warm_s: float, top: int = 12) -> None:
    """Device time by kernel over one more warm flagship run. Busy time is the
    union of the device intervals (GPU annotations overlap their kernels and
    are not counted twice); the idle share is taken against the unprofiled
    warm run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_once()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in events:
        if not e.is_user_annotation:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy = busy_us / 1e3
    print(f"  profile: device busy {busy:.1f} ms (union of device intervals) in a profiled "
          f"wall of {prof_s * 1e3:.1f} ms; unprofiled warm wall {warm_s * 1e3:.1f} ms; "
          f"idle share {max(0.0, 1 - busy / (warm_s * 1e3)):.3f}")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:100]}")


def run_flagship(results, profile=False):
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: flagship path (Qwen2.5-1.5B + MAGViTv2, random init, bf16, 4 prompts, "
          "guidance 6, 50 steps, max_text_len 128)")
    t0 = time.perf_counter()
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"  build_pipeline {time.perf_counter() - t0:.2f} s")
    layers = pipe.cfg.llm.num_hidden_layers
    expect = {"flash_attention": layers, "chunk_attention": layers * 50,
              "conv3x3_gn_swish": 44}
    counts = None
    for run in ("cold", "warm"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = pipe.generate_images(list(PROMPTS), gen, guidance_scale=6.0, timesteps=50,
                                     max_text_len=128, return_codes=True)
        pixels = pipe.decode_codes(codes)
        enqueued = time.perf_counter() - t0      # the host's share: work queued, not done
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        print(f"  {run} run: {dt:.3f} s ({enqueued:.3f} s to enqueue), "
              f"{len(PROMPTS) / dt:.4f} images/s, launches {counts}")
        check(counts == expect, f"flagship launch counts {counts} != {expect}")
        check(bool(((codes >= 0) & (codes < pipe.cfg.codebook_size)).all()),
              "flagship codes out of [0, 8192)")
        check(tuple(pixels.shape) == (len(PROMPTS), 256, 256, 3),
              f"flagship pixels shape {tuple(pixels.shape)}")
        check(bool(torch.isfinite(pixels).all()), "flagship pixels not finite")
    if profile:
        def run_once():
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            pipe.decode_codes(pipe.generate_images(list(PROMPTS), gen, guidance_scale=6.0,
                                                   timesteps=50, max_text_len=128,
                                                   return_codes=True))
        profile_flagship(run_once, dt)
    ids, _ = pipe.prompt_ids(list(PROMPTS), 128)
    print(f"  prompt length {ids.shape[1]} (prefix {ids.shape[1] - 258}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship"] = {"seconds": dt, "enqueue_s": enqueued,
                           "images_per_s": len(PROMPTS) / dt}
    return counts


def run_tiny():
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 path, kernels on the card vs plain versions on the CPU, "
          "shared noise")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3)
    gpu = cpu.to("cuda")
    b, steps = len(PROMPTS), 8
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    rng = np.random.default_rng(5)
    u_sample = rng.random((steps, b, n, cb), dtype=np.float32)
    u_mask = rng.random((steps, b, n), dtype=np.float32)
    kw = dict(guidance_scale=6.0, timesteps=steps, max_text_len=16, return_codes=True)
    _reset_counts()
    codes_gpu = gpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample).cuda(), torch.from_numpy(u_mask).cuda()), **kw)
    pix_gpu = gpu.decode_codes(codes_gpu)
    torch.cuda.synchronize()
    counts = _read_counts()
    codes_cpu = cpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample), torch.from_numpy(u_mask)), **kw)
    pix_cpu = cpu.decode_codes(codes_gpu.cpu())
    agree = (codes_gpu.cpu() == codes_cpu).float().mean().item()
    perr = (pix_gpu.cpu() - pix_cpu).abs().max().item()
    print(f"  token agreement {agree:.4f} (need >= 0.99), launches {counts}, "
          f"decode max_abs_err {perr:.3e} (tol 1e-4)")
    check(all(v > 0 for v in counts.values()), f"tiny path skipped a kernel: {counts}")
    check(agree >= 0.99, f"tiny token agreement {agree}")
    check(perr <= 1e-4, f"tiny decode disagrees: {perr}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES + OPTIONAL_PHASES))
    phases = set(ap.parse_args(argv).phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from unigen_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the unigen_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    # fp32 references are full fp32: TF32 off for matmuls and cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          "allow_tf32 matmul=False cudnn=False")
    results = {}
    counts = {}
    try:
        t0 = time.perf_counter()
        built = _cuda.build()
        for name, info in built.items():
            regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
            print(f"  built {name}.cu in {info['seconds']:.1f} s; ptxas: "
                  + " | ".join(regs))
        print(f"phase: build {time.perf_counter() - t0:.1f} s "
              f"({', '.join(_cuda.SOURCES)}, one nvcc each, in parallel)")
        if "kernels" in phases:
            run_kernel_phases(results)
        if "flagship" in phases:
            counts = run_flagship(results, profile="profile" in phases)
        if "tiny" in phases:
            run_tiny()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {"chunk_attention": "unigen_tpu/ops/chunk_attention.py:70",
                "flash_attention": "unigen_tpu/ops/flash_attention.py:95",
                "conv3x3_gn_swish": "unigen_tpu/ops/fused_conv.py:239"}
    sources = {"chunk_attention": "unigen_tpu_torch/csrc/attention.cu",
               "flash_attention": "unigen_tpu_torch/csrc/attention.cu",
               "conv3x3_gn_swish": "unigen_tpu_torch/csrc/fused_conv.cu"}
    kernels = []
    for name in replaces:
        row = {"name": name, "route": "cuda", "source": sources[name],
               "replaces": replaces[name], "launches": counts.get(name)}
        row.update(results.get(name) or {})
        kernels.append(row)
    if "flagship" in results:
        print(f"flagship: {results['flagship']['images_per_s']:.4f} images/s "
              f"({results['flagship']['seconds']:.3f} s for {len(PROMPTS)} images) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
