#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``unigen_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``unigen_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the main paths' shapes and dtypes
(bf16; the tokenizer's encoder in fp32, the dtype of its pixels), at ragged
shapes and in fp32, and drives the main paths at the flagship width
with random weights, each with the launch counts set to 0 just before it and
read just after:

* ``flagship``: GenEval text-to-image (``build_pipeline`` ->
  ``generate_images`` -> ``decode_codes``), Qwen2.5-1.5B + MAGViTv2;
* ``flagship_int8``: the same t2i call on W8A8, the JAX package's shipped
  t2i default (``build_pipeline(quantization="int8")``: backbone and image
  head int8, ``torch._int_mm`` plus the epilogue kernel ``csrc/int8.cu``);
* ``understand``: SigLIP VQA (``build_pipeline(vision=True)`` ->
  ``quantize_unigen_params_int4`` -> ``understand``), SigLIP-SO400M + the MM
  projector + Qwen2.5-1.5B in W4A8, 8 images of 384 px, 128 new tokens
  greedy; then once more with the bf16 backbone as a yardstick;
* ``understand_int8``: the same call as JAX's ``int8+kv``
  (``build_pipeline(vision=True, quantization="int8",
  quantized_cache=True)``: tower, backbone and text head W8A8, K/V int8);
* ``flagship_ar``: the t2i call with ``mode="ar"`` (255 cached steps, one
  image token each, cond and uncond rows);
* ``understand_discrete``: VQA over the tokenizer's codes, 8 fp32 images of
  256 px through the MAGViTv2 encoder (kernel 3 at its 7 shapes in fp32,
  counted by shape), the mmu prompt right-padded to 1,603, 128 greedy tokens;
* ``score``: ``score_continuations`` of 8 (image, question, continuation)
  requests, one cache-free forward;
* ``geneval``: ``evaluation.geneval.run_geneval`` over 2 prompts x 4
  samples, every PNG read back against its batch's pixels.

It checks that each path went through every kernel it runs (fixed launch
counts), and compares tiny fp32 runs through the kernels on the card with
the plain versions on the CPU (t2i under shared noise; W4A8 understand,
greedy; int8 t2i and understand with the int8 cache; the codes of
``encode_pixels``, AR t2i under shared noise, ``understand_discrete``
greedy and ``score_continuations``). The W8A8 epilogue is
held to its plain version bit for bit at every shape of the int8 paths and
timed with the whole layer against bf16 ``F.linear``. Kernel 4 (the
W4A8 product, its epilogue fused) and the per-token quantization are held
to their plain versions bit for bit at every shape of the W4A8 path, on
every route, and each W4A8 layer is timed whole against bf16 ``F.linear``. Kernel 3
(GroupNorm statistics + fused conv, two launches) is held to its plain version
and timed at all 11 conv shapes of the MAGViTv2 decoder and all 7 of its
encoder; the flagship and understand_discrete phases count its launches by
shape in the warm run, and the sums of launches x ms over a t2i batch and
over an encode are taken from those counts. Every check that
fails makes the exit code nonzero. The last line of stdout is a JSON object
naming the device; the line before it holds the kernels' measurements.
Without a CUDA device, or without the package beside it, the script exits
nonzero and prints no result. Kernel times (``ms``, ``plain_ms``,
``library_ms``) are device times from ``torch.profiler``; bounds are
computed from each phase's inputs against the H100 SXM's published peaks.

``--phases`` (default: build,kernels,flagship,flagship_int8,flagship_ar,
understand,understand_int8,understand_discrete,score,geneval,tiny) runs a
subset, for quick checks; adding ``profile`` traces one more warm run of each path with ``torch.profiler`` and prints
where the device time goes, by kernel and by family (the port's kernels,
cuBLAS, plain-torch copies, reductions and elementwise kernels).
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time

PHASES = ("build", "kernels", "flagship", "flagship_int8", "flagship_ar", "understand",
          "understand_int8", "understand_discrete", "score", "geneval", "tiny")
OPTIONAL_PHASES = ("profile",)
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
INT8_PEAK = 1979e12     # H100 SXM dense int8 tensor-core OP/s
FP32_PEAK = 67e12       # H100 SXM fp32 (non-tensor) FLOP/s
HBM_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
PROMPTS = ("a photo of a red apple on a wooden table",
           "two dogs playing in the snow",
           "a blue bicycle leaning against a brick wall",
           "a bowl of ramen with chopsticks, studio lighting")
QUESTIONS = ("What is in this image?",
             "How many people are in the picture?",
             "What color is the car on the left?",
             "Describe the scene in one sentence.",
             "Is it day or night?",
             "What is the man holding in his hand?",
             "Which animal is sitting on the sofa?",
             "What is written on the red sign?")
NEW_TOKENS = 128
# continuations of 1-16 tokens (one byte-tokenizer token a character) scored
# after QUESTIONS by the score phase
CONTINUATIONS = ("A", "Two.", "Red.", "A busy street.", "Day", "An umbrella", "A cat",
                 "STOP, no entry!!")


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def call_ms(fn, iters: int) -> float:
    """Wall time per call of back-to-back calls, between CUDA events: the
    device's time when it is the slower side, else the host's."""
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


def time_ms(fn, iters: int) -> float:
    """Device time per call: the summed durations of the kernels that ``fn``
    launches, from ``torch.profiler`` over ``iters`` calls after a warm-up.
    Unlike ``call_ms`` it does not count the host's time between launches,
    which at decode shapes is longer than the kernels themselves. A trace now
    and then comes back with some or all of its device records missing, so
    traces are taken until two hold the same number of device records (at
    most four), and the mean of the fullest ones counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    while len(traces) < 4:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        traces.append((len(us), sum(us)))
        counts = [n for n, _ in traces if n > 0]
        if len(counts) > len(set(counts)):
            break
    most = max(n for n, _ in traces)
    if most == 0:
        raise Failed(f"the profiler recorded no device time in {len(traces)} traces")
    kept = [us for n, us in traces if n == most]
    return sum(kept) / len(kept) / 1e3 / iters


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


def _measured(err, ms, plain_ms, lib_ms, b_ms, by, at):
    """The JSON fields of one timed kernel phase; ``at`` names the shape."""
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms, at=at)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def attn_flops(vis, h, kvh, dh):
    """The operations masked attention needs under visibility ``vis`` [B, 1,
    Lq, S]: q.k and p.v on each visible (query, key) pair of every head, and
    for a batch row with fully masked queries the mean of V over all keys
    once per KV head (every such query's output is that mean), not once per
    query."""
    dead_batches = (~vis.any(-1)).flatten(1).any(-1).sum().item()
    return 4.0 * h * dh * vis.sum().item() + 1.0 * kvh * dh * vis.shape[-1] * dead_batches


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
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by,
                     f"t2i chunk step q [{b},{lq},{h},{dh}], S={s}")


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
    b_ms, by = bound(attn_flops(vis, h, kvh, dh), nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, f"t2i prefill q [{b},{l},{h},{dh}]")


# Every kernel-3 call of the MAGViTv2 decoder (models/magvit.py, MagvitConfig(),
# batch 4): (H = W, C, Cout, GroupNorm before the conv, launches a t2i batch).
# 44 launches, 40 with GroupNorm. The counts are what run_flagship checks its
# census against; the kernels line takes its counts from that census.
DECODER_CONVS = ((16, 512, 512, True, 10), (32, 512, 512, False, 1), (32, 512, 256, True, 1),
                 (32, 256, 256, True, 7), (64, 256, 256, False, 1), (64, 256, 256, True, 6),
                 (128, 256, 256, False, 1), (128, 256, 128, True, 1), (128, 128, 128, True, 7),
                 (256, 128, 128, False, 1), (256, 128, 128, True, 8))


# Every kernel-3 call of the MAGViTv2 encoder (models/magvit.py, MagvitConfig(),
# batch 8, the understand_discrete phase, fp32 like its pixels): (H = W, C,
# Cout, GroupNorm before the conv, launches a call): 40 launches, all with GroupNorm.
ENCODER_CONVS = ((256, 128, 128, True, 8), (128, 128, 256, True, 1), (128, 256, 256, True, 5),
                 (64, 256, 256, True, 8), (32, 256, 512, True, 1), (32, 512, 512, True, 5),
                 (16, 512, 512, True, 12))


def _conv_inputs(gen, b, h, w, c, cout, dtype, gn, shift=0.5, spread=2.0):
    import torch
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") * spread + shift).to(dtype)
    conv_p = {"kernel": (torch.randn((3, 3, c, cout), generator=gen, device="cuda")
                         * (9 * c) ** -0.5).to(dtype),
              "bias": (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(dtype)}
    gn_p = {"scale": (1 + 0.3 * torch.randn((c,), generator=gen, device="cuda")).to(dtype),
            "bias": (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dtype)} \
        if gn else None
    return x, conv_p, gn_p


def phase_gn(gen, b, h, w, c, dtype, shift=0.5, spread=2.0, p_dtype=None):
    """GroupNorm statistics folded into (A, B): the kernel against its plain
    version within 1e-5 of max(|A|, |B|). Returns the max abs error."""
    import torch
    from unigen_tpu_torch.ops.fused_conv import gn_affine, gn_affine_plain
    x, _, gn_p = _conv_inputs(gen, b, h, w, c, 1, dtype, True, shift, spread)
    if p_dtype is not None:
        gn_p = {k: v.to(p_dtype) for k, v in gn_p.items()}
    got, ref = gn_affine(gn_p, x), gn_affine_plain(gn_p, x)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()
    check(got.shape == (b, 2, c) and bool(torch.isfinite(got).all()), "gn_affine output")
    check(err <= tol, f"gn_affine {dtype} {[b, h, w, c]} (x = {shift} + {spread} N(0, 1)): "
          f"max_abs_err {err:.3e} > {tol:.3e}")
    return err


def phase_conv(gen, b, h, w, c, cout, dtype, rtol, iters=0, gn=True, part="decoder"):
    """Fused GN + swish + conv3x3 at [b, h, w, c] -> cout; the tolerance is
    relative to the largest output magnitude. Timed (``iters`` > 0): the
    whole wrapper (statistics + conv), its plain version, cuDNN's
    ``group_norm + silu + conv2d`` (``conv2d`` alone without GN) and, with
    GN, the statistics launch alone against its plain version."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import fused_conv as FC
    x, conv_p, gn_p = _conv_inputs(gen, b, h, w, c, cout, dtype, gn)
    got = FC.conv3x3_gn_swish(conv_p, gn_p, x)
    ref = FC.conv3x3_gn_swish_plain(conv_p, gn_p, x)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "conv3x3_gn_swish output not finite")
    print(f"  conv3x3_gn_swish {dtype} x{list(x.shape)}->{cout}{'' if gn else ' (no GN)'}: "
          f"max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"conv3x3_gn_swish {dtype} {list(x.shape)} disagrees")
    if not iters:
        return None
    ms = time_ms(lambda: FC.conv3x3_gn_swish(conv_p, gn_p, x), iters)
    plain_ms = time_ms(lambda: FC.conv3x3_gn_swish_plain(conv_p, gn_p, x), iters)
    xc = x.permute(0, 3, 1, 2)
    wc = conv_p["kernel"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        y = F.silu(F.group_norm(xc, min(32, c), gn_p["scale"], gn_p["bias"], 1e-6)) if gn else xc
        return F.conv2d(y, wc, conv_p["bias"], padding=1)
    lib_ms = time_ms(library, iters)
    ab_bytes = 2 * b * c * 4 if gn else 0
    b_ms, by = bound(2.0 * b * h * w * 9 * c * cout,
                     nbytes(x, conv_p["kernel"], conv_p["bias"], got) + ab_bytes,
                     BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK)
    out = dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                         f"MAGViT {part} [{b},{h},{w},{c}]->{cout}{'' if gn else ', no GN'}"
                         f"{'' if dtype == torch.bfloat16 else f', {dtype}'}"),
               launches_per_batch=None)
    line = (f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"({'group_norm+silu+conv2d' if gn else 'conv2d'}) {lib_ms:.4f}  "
            f"bound_ms {b_ms:.4f} ({by})")
    if gn:
        ab = FC.gn_affine(gn_p, x)
        ab_ref = FC.gn_affine_plain(gn_p, x)
        gn_err = (ab - ab_ref).abs().max().item()
        check(gn_err <= 1e-5 * ab_ref.abs().max().item(), f"gn_affine {list(x.shape)} disagrees")
        gn_ms = time_ms(lambda: FC.gn_affine(gn_p, x), iters)
        gn_plain = time_ms(lambda: FC.gn_affine_plain(gn_p, x), iters)
        gb_ms, gby = bound(0.0, nbytes(x, gn_p["scale"], gn_p["bias"], ab), BF16_PEAK)
        out["gn"] = dict(_measured(gn_err, gn_ms, gn_plain, None, gb_ms, gby,
                                   f"GroupNorm statistics of [{b},{h},{w},{c}]"),
                         launches_per_batch=None)
        line += (f"\n    gn_affine alone ms {gn_ms:.4f}  plain_ms {gn_plain:.4f}  "
                 f"bound_ms {gb_ms:.4f} ({gby})  max_abs_err {gn_err:.3e}")
    print(line)
    return out


def run_conv_phases(results):
    """Kernel 3 and the GroupNorm statistics at every decoder shape (bf16,
    batch 4, timed) and every encoder shape (fp32, batch 8, timed), the statistics at a large mean against the spread and at
    C < 32, and the conv at ragged shapes, C != Cout, C % 8 != 0 (plain loads)
    and in fp32."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase: kernels, conv3x3_gn_swish and gn_affine at the decoder's 11 shapes")
    shapes = [phase_conv(gen, 4, hw, hw, c, cout, bf16, 2 ** -6, 20 if hw < 128 else 5, gn)
              for hw, c, cout, gn, _ in DECODER_CONVS]
    conv_rows = [{k: v for k, v in s.items() if k != "gn"} for s in shapes]
    gn_rows = [s.get("gn") for s in shapes]
    # the last shape, [4, 256, 256, 128] -> 128 with GN, heads each kernel's row;
    # launches_per_batch and batch_ms stay null unless the flagship phase counts them
    results["conv3x3_gn_swish"] = conv_rows[-1]
    conv_rows[-1].update(shapes=conv_rows[:-1], batch_ms=None)
    results["gn_affine"] = gn_rows[-1]
    gn_rows[-1].update(shapes=[r for r in gn_rows[:-1] if r], batch_ms=None)
    results["conv_rows"] = [(key[:4], conv, gn_row)
                            for key, conv, gn_row in zip(DECODER_CONVS, conv_rows, gn_rows)]
    print("phase: kernels, conv3x3_gn_swish and gn_affine at the encoder's 7 shapes (batch 8, "
          "fp32: understand_discrete encodes fp32 pixels, and the encoder runs in their dtype)")
    enc = [phase_conv(gen, 8, hw, hw, c, cout, f32, 1e-4, 10 if hw < 128 else 3, gn,
                      part="encoder") for hw, c, cout, gn, _ in ENCODER_CONVS]
    enc_rows = [{k: v for k, v in e.items() if k != "gn"} for e in enc]
    conv_rows[-1]["shapes"] += enc_rows
    gn_rows[-1]["shapes"] += [e["gn"] for e in enc]
    results["encoder_conv_rows"] = [(key[:4], row, e["gn"])
                                    for key, row, e in zip(ENCODER_CONVS, enc_rows, enc)]
    worst = 0.0
    for b, h, w, c, dtype, shift, p_dtype in ((4, 256, 256, 128, bf16, 100.0, None),
                                              (4, 256, 256, 128, f32, 100.0, None),
                                              (2, 19, 37, 16, bf16, 100.0, None),
                                              (2, 19, 37, 12, f32, 0.5, bf16),
                                              (2, 19, 37, 96, bf16, 0.5, f32)):
        worst = max(worst, phase_gn(gen, b, h, w, c, dtype, shift, 1.0, p_dtype))
    print("  gn_affine at x = 100 + N(0, 1) (bf16 and fp32, C 128 and 16), C 12 and 96 with "
          f"scale and bias in another type: within 1e-5 of max |A|, |B| (largest err {worst:.3e})")
    phase_conv(gen, 2, 37, 37, 96, 80, bf16, 2 ** -6)         # ragged tiles, C != Cout
    phase_conv(gen, 2, 37, 37, 96, 80, bf16, 2 ** -6, gn=False)
    phase_conv(gen, 2, 19, 37, 16, 24, bf16, 2 ** -6)         # one channel chunk
    phase_conv(gen, 2, 19, 37, 24, 40, bf16, 2 ** -6)         # channels past C by cp.async
    phase_conv(gen, 2, 19, 37, 12, 20, bf16, 2 ** -6)         # C % 8 != 0: plain loads
    phase_conv(gen, 2, 64, 64, 256, 128, f32, 1e-4)
    phase_conv(gen, 2, 19, 37, 96, 80, f32, 1e-4, gn=False)


_PIPELINES = {}


def flagship_pipeline(vision=False):
    """The seed-0 bf16 flagship pipeline (with the SigLIP tower when
    ``vision``), built once and shared by the phases that drive it and by
    the kernels phase, which takes its prompt layouts from it."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    if vision not in _PIPELINES:
        t0 = time.perf_counter()
        _PIPELINES[vision] = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda",
                                            seed=0, vision=vision)
        torch.cuda.synchronize()
        print(f"  build_pipeline('flagship', vision={vision}) {time.perf_counter() - t0:.2f} s")
    return _PIPELINES[vision]


def understand_prompt_shape(pipe, questions=QUESTIONS):
    """(L, prompt lengths) of the understand prefill, from the pipeline's
    ``_vqa_parts``: part1, the image tokens and part2 (<|eoi|> and each
    question's template without its first token, right-padded)."""
    p = pipe.vision_cfg.num_patches
    part1, part2, q_lens = pipe._vqa_parts(questions, p, None)
    return part1.shape[1] + p + part2.shape[1], (part1.shape[1] + p + q_lens).tolist()


def ar_prompt_layout(pipe, prompts=PROMPTS):
    """(Lp, left pads of each of the 2B rows) of the AR prefill: the cond and
    uncond rows of the pipeline's ``prompt_ids`` (text budget 128) without
    the image block that ``t2i_generate_ar`` cuts off."""
    import numpy as np
    ids, uncond = pipe.prompt_ids(list(prompts), 128)
    prompt = np.concatenate([ids, uncond])[:, :-(pipe.cfg.num_vq_tokens + 1)]
    return prompt.shape[1], (prompt == pipe.prompting.pad_id).sum(axis=1).tolist()


def mmu_prompt_layout(pipe, questions=QUESTIONS):
    """(ids [B, max_seq_len], prompt lengths, <|eoi|> id) of the
    understand_discrete prompt, from the pipeline's ``_mmu_prompt`` (the
    codes' values do not move the mask)."""
    import numpy as np
    codes = np.zeros((len(questions), pipe.cfg.num_vq_tokens), np.int64)
    ids, plen = pipe._mmu_prompt(codes, questions)
    return ids, plen.tolist(), pipe.prompting.sptids_dict["<|eoi|>"]


def score_conts(pipe):
    import numpy as np
    return [np.asarray(pipe.prompting._tokenize(c)[0]) for c in CONTINUATIONS]


def score_layout(pipe, questions=QUESTIONS):
    """(L, prompt lengths) of the scoring forward, from the pipeline's
    ``_score_parts`` at ``score_continuations``' bucket: part1, the image
    tokens and part2c."""
    from unigen_tpu_torch.pipeline import SCORE_LENGTH_BUCKET
    p = pipe.vision_cfg.num_patches
    part1, part2c, _, l2_real = pipe._score_parts(questions, score_conts(pipe), p, None,
                                                  SCORE_LENGTH_BUCKET)
    off = part1.shape[1] + p
    return off + part2c.shape[1], (off + l2_real).tolist()


def phase_flash_siglip(gen, b, dtype, rtol, iters):
    """SigLIP-SO400M attention: q/k/v [b, 729, 16, 72] zero-padded to the
    kernel's head dim 80, every token bidirectional, scale 72^-1/2."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_plain,
                                                      kernel_head_dim)
    l, h, dh = 729, 16, 72
    q, k, v = _attn_inputs(gen, b, l, l, h, h, dh, dtype)
    pad = kernel_head_dim(dh) - dh
    qp, kp, vp = (F.pad(t, (0, pad)) for t in (q, k, v))
    bits = torch.full((b, l), M.BIDIRQ_BIT, dtype=torch.int32, device="cuda")
    got = flash_attention(qp, kp, vp, bits, scale=dh ** -0.5)[..., :dh]
    ref = flash_attention_plain(qp, kp, vp, bits, scale=dh ** -0.5)[..., :dh]
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), "flash_attention (SigLIP) output not finite")
    print(f"  flash_attention {dtype} SigLIP q{list(q.shape)} padded to {dh + pad}: "
          f"max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, "flash_attention at the SigLIP shape disagrees with its plain version")
    ms = time_ms(lambda: flash_attention(qp, kp, vp, bits, scale=dh ** -0.5), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(qp, kp, vp, bits, scale=dh ** -0.5), 3)
    lib_ms = sdpa_ms(q, k, v, None, iters)
    b_ms, by = bound(4.0 * b * h * dh * l * l, nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa, dh 72) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by,
                     f"SigLIP q/k/v [{b},{l},{h},{dh}->{dh + pad}], all bidirectional")


def phase_flash_mmu(gen, b, l, prompt_len, dtype, rtol, iters):
    """The understanding prefill: q [b, l, 12, 128], k/v [b, l, 2, 128],
    mmu_vit metadata (729-key image block after 3 prefix tokens, pads from
    each row's prompt length)."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    plen = torch.as_tensor(prompt_len, device="cuda")
    meta = M.mmu_vit_attn_meta(b, l, num_tokens=729, prefix_length=3, prompt_len=plen)
    return phase_flash_meta(gen, meta, dtype, rtol, iters,
                            f"understand prefill q [{b},{l},12,128], mmu_vit meta")


def phase_flash_meta(gen, meta, dtype, rtol, iters, at):
    """Flash attention of q [b, l, 12, 128], k/v [b, l, 2, 128] under the
    metadata ``meta`` (a path's prefill); timed when ``iters`` > 0."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    h, kvh, dh = 12, 2, 128
    b, l = meta.pad.shape
    q, k, v = _attn_inputs(gen, b, l, l, h, kvh, dh, dtype)
    bits = M.pack_meta(meta)
    got = flash_attention(q, k, v, bits)
    ref = flash_attention_plain(q, k, v, bits)
    torch.cuda.synchronize()
    err, tol = _err_tol(got, ref, rtol)
    check(bool(torch.isfinite(got).all()), f"flash_attention ({at}) output not finite")
    print(f"  flash_attention {dtype} {at}: max_abs_err {err:.3e} (tol {tol:.2e})")
    check(err <= tol, f"flash_attention at {at} disagrees with its plain version")
    if not iters:
        return None
    ms = time_ms(lambda: flash_attention(q, k, v, bits), iters)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, bits), 3)
    vis = meta.visibility()
    lib_ms = sdpa_ms(q, k, v, vis, iters)
    b_ms, by = bound(attn_flops(vis, h, kvh, dh), nbytes(q, k, v, bits, got), BF16_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms (sdpa) {lib_ms:.4f}  "
          f"bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, lib_ms, b_ms, by, at)


def phase_chunk_decode(gen, b, l, prompt_len, step, dtype, rtol, iters, timed=True,
                       new_tokens=NEW_TOKENS, masked=False, left_pads=None,
                       at="understand decode step"):
    """One understanding decode step: q [b, 1, 12, 128] against the cache of
    l + new_tokens slots, visible = the row's prompt slots and the decoded
    slots (with ``left_pads``, the prompt slots from each row's pads on: the
    AR t2i step). Both routes of the kernel (unsplit, and split over the keys at 8
    and at 15 splits) are held against the plain version through the
    wrapper's ``_launch``; with ``masked``, keys 128..255 are invisible to
    every row (a fully masked split at 8 splits) and row 0 sees no key at
    all. Timed warm (one K/V pair, which stays in L2) and cold (a cycle of
    K/V pairs larger than L2, as the path's 28 layers' caches are)."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import chunk_attention as CA
    h, kvh, dh = 12, 2, 128
    s = l + new_tokens
    q, k, v = _attn_inputs(gen, b, 1, s, h, kvh, dh, dtype)
    slots = torch.arange(s, device="cuda")[None]
    plen = torch.as_tensor(prompt_len, device="cuda")[:, None]
    kvalid = (slots < plen) | ((slots >= l) & (slots <= l + step))
    if left_pads is not None:
        kvalid &= slots >= torch.as_tensor(left_pads, device="cuda")[:, None]
    if masked:
        kvalid[:, 128:256] = False
        kvalid[0] = False
    ref = CA.chunk_attention_plain(q, k, v, kvalid)
    chosen = CA.kv_splits(b, 1, s, h, kvh)
    routes = sorted({1, 8, 15, chosen})
    errs = {}
    for n in routes:
        got = CA._launch(q, k, v, kvalid, n)
        torch.cuda.synchronize()
        errs[n], tol = _err_tol(got, ref, rtol)
        check(bool(torch.isfinite(got).all()), f"chunk_attention (decode, {n} splits) not finite")
        check(errs[n] <= tol, f"chunk_attention {dtype} decode S={s} with {n} splits: "
              f"max_abs_err {errs[n]:.3e} (tol {tol:.2e})")
    before = CA.chunk_attention.launches
    got = CA.chunk_attention(q, k, v, kvalid)
    check(CA.chunk_attention.launches == before + 1, "chunk_attention counted no single launch")
    check(bool(torch.equal(got, CA._launch(q, k, v, kvalid, chosen))),
          "chunk_attention did not take the route kv_splits names")
    err = errs[chosen]
    print(f"  chunk_attention {dtype} decode q{list(q.shape)} S={s}"
          f"{' (a masked split, a masked row)' if masked else ''}: the rule splits {chosen}x; "
          "max_abs_err by splits " + ", ".join(f"{n}: {e:.3e}" for n, e in errs.items())
          + f" (tol {tol:.2e})")
    if not timed:
        return None
    check(chosen > 1, f"the decode step q{list(q.shape)} S={s} did not take the split route")
    ms_by = {n: time_ms(lambda n=n: CA._launch(q, k, v, kvalid, n), iters) for n in routes}
    ms = time_ms(lambda: CA.chunk_attention(q, k, v, kvalid), iters)
    plain_ms = time_ms(lambda: CA.chunk_attention_plain(q, k, v, kvalid), iters)
    lib_ms = sdpa_ms(q, k, v, kvalid[:, None, None, :], iters)
    # cold: 10 K/V pairs of this shape (75 MB) against 50 MB of L2
    pairs = [(k, v)] + [tuple(_attn_inputs(gen, b, 1, s, h, kvh, dh, dtype)[1:])
                        for _ in range(9)]

    def cold(fn):
        ring = itertools.cycle(pairs)
        return time_ms(lambda: fn(*next(ring)), 5 * len(pairs))
    cold_by = {n: cold(lambda kk, vv, n=n: CA._launch(q, kk, vv, kvalid, n)) for n in routes}
    mask4 = kvalid[:, None, None, :]
    lib_cold = cold(lambda kk, vv: F.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask4,
        enable_gqa=True))
    b_ms, by = bound(4.0 * h * dh * kvalid.sum().item(), nbytes(q, k, v, kvalid, got),
                     BF16_PEAK)
    print(f"    ms {ms:.4f} ({chosen} splits)  plain_ms {plain_ms:.4f}  library_ms (sdpa) "
          f"{lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    print("    by splits (1 = unsplit), warm / cold ms: "
          + ", ".join(f"{n}: {ms_by[n]:.4f} / {cold_by[n]:.4f}" for n in routes)
          + f"; sdpa cold {lib_cold:.4f}")
    return dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                          f"{at} q [{b},1,12,128], S={s}, {chosen} splits"),
                ms_cold=cold_by[chosen])


def phase_w4a8(gen, t, k, n, group, iters, timed, label="", bias=True):
    """Kernel 4 at [t, k] -> n (weights packed from a normal * k^-1/2 matrix;
    activations quantized from a bf16 normal by the plain version; a bf16
    bias, or with ``bias=False`` the fp32 zeros a layer without one gets).
    The product alone (``w4a8_matmul``, fp32 [t, Npad]) and the fused dense
    launch (``dense_int4_prequant``: product, ``* act_scale + bias``, cast;
    bf16 and, untimed, fp32 [t, n]) must equal their plain versions bit for
    bit, and at t <= 16 so must the route the wrapper does not choose (split
    over groups or not). Timed: the fused launch (what the path runs) against
    its plain version, its bound and bf16 ``F.linear`` (with the bias where
    the layer has one), and the whole layer, ``dense_int4`` (quantization +
    fused launch, what one layer enqueues), against the same ``F.linear``."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import int4
    from unigen_tpu_torch.ops.quantization import quantize_activations_plain
    bf16 = torch.bfloat16
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    dense = {"kernel": w}
    if bias:
        dense["bias"] = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(bf16)
    p = int4.quantize_dense_int4(dense, group)
    packed, scale = p[int4.KEY], p["scale4"]
    npad = packed.shape[1]
    x = torch.randn((t, k), generator=gen, device="cuda").to(bf16)
    x8, act = quantize_activations_plain(x)
    got = int4.w4a8_matmul(x8, packed, scale, group=group)
    check(bool(torch.equal(got, int4.w4a8_matmul_plain(x8, packed, scale, group=group))),
          f"w4a8_matmul {label} T={t} K={k} N={n} differs from its plain version")
    split = int4.splits_over_groups(t, npad)
    other_ms = None
    for out_dtype in ((bf16,) if timed else (bf16, torch.float32)):
        dref = int4.dense_int4_prequant_plain(p, x8, act, out_dtype)
        dgot = int4.dense_int4_prequant(p, x8, act, out_dtype)
        torch.cuda.synchronize()
        check(dgot.shape == (t, n) and bool(torch.isfinite(dgot).all()),
              f"w4a8 dense {label} output {tuple(dgot.shape)} not finite")
        check(bool(torch.equal(dgot, dref)), f"w4a8 dense {label} T={t} K={k} N={n} group {group} "
              f"{out_dtype} differs from its plain version")
        if t <= 16:    # the same layer on the route not chosen

            def other_path(od=out_dtype):
                return int4._dense_launch(x8, packed, scale, act, p["bias"], od, group, not split)
            check(bool(torch.equal(other_path(), dgot)),
                  f"w4a8 dense {label}: split and unsplit differ")
            if timed:
                other_ms = time_ms(other_path, iters)
    err = (dgot.float() - dref.float()).abs().max().item()
    layer_ref = int4.dense_int4_prequant_plain(p, x8, act, bf16)
    check(bool(torch.equal(int4.dense_int4(p, x), layer_ref)),
          f"dense_int4 {label} (quantization + fused launch) differs from the plain composition")
    print(f"  w4a8 {label} T={t} K={k} N={n} (Npad {npad}) group {group}"
          f"{', split over groups' if split else ''}: product, fused dense"
          f"{'' if timed else ' (bf16 and fp32)'}{' and the other route' if t <= 16 else ''}"
          " equal their plain versions bit for bit")
    if not timed:
        return None

    def fused():
        return int4.dense_int4_prequant(p, x8, act, bf16)
    ms = time_ms(fused, iters)
    matmul_ms = time_ms(lambda: int4.w4a8_matmul(x8, packed, scale, group=group), iters)
    plain_ms = time_ms(lambda: int4.dense_int4_prequant_plain(p, x8, act, bf16), 3)
    wb = (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).to(bf16)
    bb = p["bias"] if bias else None

    def library():
        return F.linear(x, wb, bb)
    lib_ms = time_ms(library, iters)
    layer_ms = time_ms(lambda: int4.dense_int4(p, x), iters)
    layer_call = call_ms(lambda: int4.dense_int4(p, x), iters)
    lib_call = call_ms(library, iters)
    # the first n columns of the padded weights are all the layer needs
    b_ms, by = bound(2.0 * t * k * n, nbytes(x8, packed[:, :n], scale[:, :n], act, p["bias"], dgot),
                     INT8_PEAK)
    print(f"    fused launch ms {ms:.4f}  (product alone, fp32 [T, Npad] {matmul_ms:.4f}"
          + (f"; {'unsplit' if split else 'split'} route {other_ms:.4f}" if other_ms else "")
          + f")  plain_ms {plain_ms:.4f}  library_ms (bf16 F.linear{' + bias' if bias else ''})"
          f" {lib_ms:.4f}  bound_ms {b_ms:.4f} ({by})")
    print(f"    layer (quantization + fused launch) device {layer_ms:.4f} ms, back to back "
          f"{layer_call:.4f} ms; bf16 F.linear back to back {lib_call:.4f} ms")
    return dict(_measured(err, ms, plain_ms, lib_ms, b_ms, by,
                          f"{label} T={t} K={k} N={n} group {group}"
                          + (", split over groups" if split else "")),
                matmul_ms=matmul_ms, other_route_ms=other_ms, layer_ms=layer_ms,
                layer_call_ms=layer_call, library_call_ms=lib_call)


def phase_quant(gen, t, k, dtype, iters, timed, label=""):
    """Per-token quantization of x [t, k] (normal * 3; where there are rows
    for them, an all-zero row and a row of scale 1 with exact .5 ties and
    +-127): both outputs must equal the plain version's bit for bit."""
    import torch
    from unigen_tpu_torch.ops.quantization import (quantize_activations,
                                                   quantize_activations_plain)
    x = torch.randn((t, k), generator=gen, device="cuda") * 3
    if t > 2:
        x[1] = 0.0
        ties = torch.tensor([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0], device="cuda")
        x[2] = ties.repeat(-(-k // 8))[:k]
    x = x.to(dtype)
    (q, s), (qr, sr) = quantize_activations(x), quantize_activations_plain(x)
    torch.cuda.synchronize()
    check(bool(torch.equal(q, qr)) and bool(torch.equal(s, sr)),
          f"quantize_activations {label} T={t} K={k} {dtype} differs from its plain version")
    err = float(max((q.int() - qr.int()).abs().max().item(), (s - sr).abs().max().item()))
    print(f"  quantize_activations {label} T={t} K={k} {dtype}: equal to the plain version "
          f"(max_abs_err {err})")
    if not timed:
        return None
    ms = time_ms(lambda: quantize_activations(x), iters)
    plain_ms = time_ms(lambda: quantize_activations_plain(x), iters)
    b_ms, by = bound(0.0, nbytes(x, q, s), INT8_PEAK)
    print(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms none  bound_ms {b_ms:.4f} ({by})")
    return _measured(err, ms, plain_ms, None, b_ms, by, f"{label} x [{t},{k}] {dtype}")


def phase_head_dims(gen):
    """Flash and chunk attention (both routes) at every head dim the
    wrappers' callers may pad to (``KERNEL_HEAD_DIMS``), bf16 and fp32: a dim
    that the source does not instantiate fails to launch here."""
    import torch
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops.chunk_attention import (_launch, chunk_attention,
                                                      chunk_attention_plain)
    from unigen_tpu_torch.ops.flash_attention import (KERNEL_HEAD_DIMS, flash_attention,
                                                      flash_attention_plain)
    b, l = 2, 37
    pos = torch.arange(l, device="cuda")[None].expand(b, l)
    pad = pos < torch.tensor([[0], [5]], device="cuda")
    z = torch.zeros_like(pad)
    bits = M.pack_meta(M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z))
    worst = 0.0
    for dtype, rtol in ((torch.bfloat16, 2 ** -7), (torch.float32, 2e-5)):
        for dh in KERNEL_HEAD_DIMS:
            q, k, v = _attn_inputs(gen, b, l, l, 4, 2, dh, dtype)
            q1, k1, v1 = _attn_inputs(gen, b, 1, 90, 4, 2, dh, dtype)   # one row: it may split
            seen = torch.arange(90, device="cuda")[None] >= torch.tensor([[0], [5]], device="cuda")
            for name, got, ref in (
                    ("flash", flash_attention(q, k, v, bits), flash_attention_plain(q, k, v, bits)),
                    ("chunk", chunk_attention(q, k, v, ~pad), chunk_attention_plain(q, k, v, ~pad)),
                    ("chunk (split)", _launch(q1, k1, v1, seen, 2),
                     chunk_attention_plain(q1, k1, v1, seen))):
                err, tol = _err_tol(got, ref, rtol)
                check(bool(torch.isfinite(got).all()) and err <= tol,
                      f"{name}_attention {dtype} head dim {dh}: max_abs_err {err} (tol {tol})")
                worst = max(worst, err / tol)
    print(f"  flash and chunk attention (unsplit and split) at head dims {KERNEL_HEAD_DIMS}, "
          "bf16 and fp32: all "
          f"match their plain versions (largest err/tol {worst:.3f})")


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
    # Kernel 4 and the quantization: bit for bit (torch.equal), every dtype.
    print("phase: kernels (main-path shapes in bf16, a ragged shape, fp32)")
    results["chunk_attention"] = phase_chunk(gen, 8, 258, 148, bf16, 2 ** -7, 20, True)
    phase_chunk(gen, 3, 37, 61, bf16, 2 ** -7, 0, False)          # ragged: S = 98
    phase_chunk(gen, 8, 258, 148, f32, 2e-5, 0, False)
    results["flash_attention"] = phase_flash(gen, 8, 148, bf16, 2 ** -7, 20, True)
    phase_flash(gen, 3, 133, bf16, 2 ** -7, 0, False, ragged_bits=True)
    phase_flash(gen, 3, 133, f32, 2e-5, 0, False, ragged_bits=True)
    run_conv_phases(results)

    print("phase: kernels at the understanding path's shapes (bf16 unless noted)")
    pipe, vpipe = flagship_pipeline(), flagship_pipeline(vision=True)
    l, plen = understand_prompt_shape(vpipe)
    b = len(QUESTIONS)
    results["chunk_attention"]["shapes"] = [
        phase_chunk_decode(gen, b, l, plen, 64, bf16, 2 ** -7, 50)]
    for dtype, rtol in ((bf16, 2 ** -7), (f32, 2e-5)):
        phase_chunk_decode(gen, b, l, plen, 64, dtype, rtol, 0, False, masked=True)
        # ragged S: 98 (two splits, the last of 34 keys), 66 (a last split of 2), 1
        phase_chunk_decode(gen, 3, 61, [61, 40, 7], 5, dtype, rtol, 0, False, new_tokens=37,
                           masked=True)
        phase_chunk_decode(gen, 3, 61, [61, 40, 7], 4, dtype, rtol, 0, False, new_tokens=5)
        phase_chunk_decode(gen, 2, 0, [0, 0], 0, dtype, rtol, 0, False, new_tokens=1)
    phase_chunk_decode(gen, b, l, plen, 64, f32, 2e-5, 0, False)
    results["flash_attention"]["shapes"] = [phase_flash_siglip(gen, b, bf16, 2 ** -7, 20),
                                            phase_flash_mmu(gen, b, l, plen, bf16, 2 ** -7, 20)]
    phase_flash_mmu(gen, 3, 800, [800, 741, 733], f32, 2e-5, 1)

    print("phase: kernels at the AR t2i, discrete understanding and scoring shapes (bf16)")
    from unigen_tpu_torch.ops import masks as M
    lp, pads = ar_prompt_layout(pipe)
    rows = 2 * len(PROMPTS)
    pos = torch.arange(lp, device="cuda")[None].expand(rows, lp)
    pad = pos < torch.as_tensor(pads, device="cuda")[:, None]
    z = torch.zeros_like(pad)
    ids, mmu_plen, eoi = mmu_prompt_layout(pipe)
    l_score, score_plen = score_layout(vpipe)
    results["flash_attention"]["shapes"] += [
        phase_flash_meta(gen, M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z), bf16, 2 ** -7, 20,
                         f"AR t2i prefill q [{rows},{lp},12,128], pad bits"),
        phase_flash_meta(gen, M.mmu_attn_meta(torch.as_tensor(ids, device="cuda"), eoi,
                                              torch.as_tensor(mmu_plen, device="cuda")),
                         bf16, 2 ** -7, 10,
                         f"understand_discrete prefill q [{b},{ids.shape[1]},12,128], mmu meta"),
        phase_flash_meta(gen, M.mmu_vit_attn_meta(
            b, l_score, num_tokens=729, prefix_length=3,
            prompt_len=torch.as_tensor(score_plen, device="cuda")), bf16, 2 ** -7, 20,
            f"score forward q [{b},{l_score},12,128], mmu_vit meta")]
    results["chunk_attention"]["shapes"] += [
        phase_chunk_decode(gen, rows, lp, [lp] * rows, 128, bf16, 2 ** -7, 50, new_tokens=256,
                           left_pads=pads, at="AR t2i step"),
        phase_chunk_decode(gen, b, ids.shape[1], mmu_plen, 64, bf16, 2 ** -7, 50,
                           at="understand_discrete decode step")]
    # kernel 4 and the quantization at every W4A8 shape of the understand call:
    # decode T = 8 and prefill T = 8 x 787; q/k/v carry a bf16 bias, the rest
    # the fp32 zeros a layer without one gets
    t_pre = b * l
    w4 = [phase_w4a8(gen, b, 1536, 8960, 256, 50, True, "decode gate/up", bias=False),
          phase_w4a8(gen, b, 1536, 1536, 256, 50, True, "decode q/o"),
          phase_w4a8(gen, b, 1536, 256, 256, 50, True, "decode k/v"),
          phase_w4a8(gen, b, 8960, 1536, 256, 50, True, "decode down", bias=False),
          phase_w4a8(gen, b, 1536, 159867, 256, 20, True, "decode head", bias=False),
          phase_w4a8(gen, t_pre, 1536, 1536, 256, 10, True, "prefill q/o"),
          phase_w4a8(gen, t_pre, 1536, 256, 256, 10, True, "prefill k/v"),
          phase_w4a8(gen, t_pre, 1536, 8960, 256, 10, True, "prefill gate/up", bias=False),
          phase_w4a8(gen, t_pre, 8960, 1536, 256, 10, True, "prefill down", bias=False)]
    results["w4a8_matmul"] = dict(w4[0], shapes=w4[1:])
    qa = [phase_quant(gen, b, 1536, bf16, 50, True, "decode"),
          phase_quant(gen, b, 8960, bf16, 50, True, "decode down input"),
          phase_quant(gen, t_pre, 1536, bf16, 10, True, "prefill"),
          phase_quant(gen, t_pre, 8960, bf16, 10, True, "prefill down input")]
    results["quantize_activations"] = dict(qa[0], shapes=qa[1:])
    phase_head_dims(gen)
    run_w8a8_phases(results)
    # ragged T, N and groups on every route: both routes at T 5 (split chosen),
    # the prefill body with 16-byte copies (T 37, 300) and with plain loads
    # (group 16: half-groups of 8 bytes)
    for t, k, n, group in ((5, 128, 96, 32), (5, 512, 1000, 64), (37, 512, 1000, 64),
                           (37, 256, 96, 32), (70, 256, 512, 16), (300, 1024, 1000, 256)):
        phase_w4a8(gen, t, k, n, group, 0, False, "ragged", bias=n != 1000)
    for t, k, dtype in ((1, 999, f32), (37, 1000, bf16), (6296, 8960, f32)):
        phase_quant(gen, t, k, dtype, 0, False, "ragged")

def phase_w8a8(gen, t, k, n, iters, timed, label="", bias_dtype=None):
    """The W8A8 layer at [t, k] -> n: weights quantized from a normal * k^-1/2
    matrix, activations from a bf16 normal by the plain quantization, a bias
    of ``bias_dtype`` or none. ``torch._int_mm`` (on rows padded to 32 at
    t <= 16) must give the exact product; the epilogue kernel must equal its
    plain version bit for bit (bf16 and, untimed, fp32 out), and so must the
    whole layer ``dense_int8`` against the plain composition. Timed: the
    epilogue launch against its plain version and its byte bound; the product
    alone; the whole layer (quantization, product, epilogue: what one layer
    enqueues) against bf16 ``F.linear`` (with the bias where the layer has
    one), on the device and back to back."""
    import torch
    import torch.nn.functional as F
    from unigen_tpu_torch.ops import quantization as QZ
    bf16 = torch.bfloat16
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    dense = {"kernel": w}
    if bias_dtype is not None:
        dense["bias"] = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(bias_dtype)
    p = QZ.quantize_dense(dense)
    w8, scale, bias = p[QZ.KEY], p["scale"], p.get("bias")
    x = torch.randn((t, k), generator=gen, device="cuda").to(bf16)
    x8, act = QZ.quantize_activations_plain(x)
    acc = QZ.int8_matmul(x8, w8)
    check(acc.shape == (t, w8.shape[0]) and bool(torch.equal(acc.double(),
                                                             x8.double() @ w8.double().t())),
          f"int8_matmul {label} T={t} K={k} N={n} is not the exact product")
    for out_dtype in ((bf16,) if timed else (bf16, torch.float32)):
        ref = QZ.w8a8_epilogue_plain(acc, act, scale, bias, out_dtype)
        got = QZ.w8a8_epilogue(acc, act, scale, bias, out_dtype)
        torch.cuda.synchronize()
        check(got.shape == (t, n) and bool(torch.isfinite(got).all()),
              f"w8a8_epilogue {label} output {tuple(got.shape)} not finite")
        check(bool(torch.equal(got, ref)), f"w8a8_epilogue {label} T={t} N={n} {out_dtype} "
              "differs from its plain version")
    check(bool(torch.equal(QZ.dense_int8(p, x), QZ.dense_int8_prequant_plain(p, x8, act, bf16))),
          f"dense_int8 {label} (quantization + _int_mm + epilogue) differs from the plain "
          "composition")
    print(f"  w8a8 {label} T={t} K={k} N={n} (Npad {w8.shape[0]}, bias "
          f"{'none' if bias is None else str(bias_dtype).split('.')[-1]}): exact product; "
          f"epilogue{'' if timed else ' (bf16 and fp32)'} and layer equal their plain versions "
          "bit for bit")
    if not timed:
        return None
    ms = time_ms(lambda: QZ.w8a8_epilogue(acc, act, scale, bias, bf16), iters)
    plain_ms = time_ms(lambda: QZ.w8a8_epilogue_plain(acc, act, scale, bias, bf16), iters)
    mm_ms = time_ms(lambda: QZ.int8_matmul(x8, w8), iters)
    layer_ms = time_ms(lambda: QZ.dense_int8(p, x), iters)
    layer_call = call_ms(lambda: QZ.dense_int8(p, x), iters)
    wb = w.t().contiguous().to(bf16)

    def library():
        return F.linear(x, wb, bias)
    lib_ms = time_ms(library, iters)
    lib_call = call_ms(library, iters)
    b_ms, by = bound(0.0, nbytes(acc[:, :n], act, scale, got) + (0 if bias is None else
                                                                 nbytes(bias)), INT8_PEAK)
    lb_ms, lby = bound(2.0 * t * k * n, nbytes(x, w8[:n], scale, got) + (0 if bias is None else
                                                                        nbytes(bias)), INT8_PEAK)
    print(f"    epilogue ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {b_ms:.4f} ({by})  "
          f"library_ms none")
    print(f"    layer: device {layer_ms:.4f} ms (_int_mm {mm_ms:.4f}), bound {lb_ms:.4f} ({lby}); "
          f"bf16 F.linear{' + bias' if bias is not None else ''} {lib_ms:.4f}; back to back "
          f"layer {layer_call:.4f}, F.linear {lib_call:.4f}")
    return dict(_measured(0.0, ms, plain_ms, None, b_ms, by,
                          f"{label} [{t},{n}] of [{t},{k}] x [{k},{n}]"),
                int_mm_ms=mm_ms, layer_ms=layer_ms, layer_bound_ms=lb_ms,
                linear_ms=lib_ms, layer_call_ms=layer_call, linear_call_ms=lib_call)


def phase_int_mm_layout(gen, t, k, n, iters):
    """torch._int_mm with the W8A8 leaf's weight ([Npad, K], read as its
    transpose) against the same weight stored [K, N]: the device kernels of
    each (the leaf's may hold no copy or transpose) and their times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from unigen_tpu_torch.ops import quantization as QZ
    x8 = torch.randint(-127, 128, (t, k), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    w_kn = w.t().contiguous()
    QZ.int8_matmul(x8, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        QZ.int8_matmul(x8, w)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.is_user_annotation]
    check(bool(names) and not any("copy" in m.lower() or "transpose" in m.lower() for m in names),
          f"torch._int_mm on the W8A8 weight layout launched {names}")
    leaf_ms = time_ms(lambda: torch._int_mm(x8, w.t()), iters)
    kn_ms = time_ms(lambda: torch._int_mm(x8, w_kn), iters)
    print(f"  torch._int_mm [{t},{k}] x [{k},{n}]: the leaf's [N, K] weight {leaf_ms:.4f} ms "
          f"({names[0][:70]}), a [K, N] weight {kn_ms:.4f} ms; no copy kernel")
    return {"leaf_ms": leaf_ms, "kn_ms": kn_ms, "kernel": names[0]}


def run_w8a8_phases(results):
    """The W8A8 layer at every shape of the int8 paths: t2i (prefill 8 x 148
    rows, steps 8 x 258, the image head on 4 x 256 blended rows), the
    understand call (SigLIP 8 x 729, prefill 8 x 787, decode 8 rows and the
    159,867-wide head); timed at the t2i step and decode shapes and one
    prefill and one SigLIP shape; ragged shapes and an fp32 bias untimed."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase: kernels, the W8A8 layer (torch._int_mm + the epilogue kernel) at the int8 "
          "paths' shapes (bf16 activations)")
    l, _ = understand_prompt_shape(flagship_pipeline(vision=True))
    b = len(QUESTIONS)
    t_step, t_pre, t_vit = 8 * 258, b * l, b * 729
    timed = [phase_w8a8(gen, t_step, 1536, 8960, 20, True, "t2i step gate/up"),
             phase_w8a8(gen, t_step, 1536, 1536, 20, True, "t2i step q", bf16),
             phase_w8a8(gen, t_step, 1536, 256, 20, True, "t2i step k/v", bf16),
             phase_w8a8(gen, t_step, 8960, 1536, 20, True, "t2i step down"),
             phase_w8a8(gen, 4 * 256, 1536, 8192, 20, True, "t2i image head"),
             phase_w8a8(gen, b, 1536, 8960, 50, True, "decode gate/up"),
             phase_w8a8(gen, b, 1536, 1536, 50, True, "decode q", bf16),
             phase_w8a8(gen, b, 1536, 256, 50, True, "decode k/v", bf16),
             phase_w8a8(gen, b, 8960, 1536, 50, True, "decode down"),
             phase_w8a8(gen, b, 1536, 159867, 20, True, "decode head"),
             phase_w8a8(gen, t_pre, 1536, 8960, 10, True, "understand prefill gate/up"),
             phase_w8a8(gen, t_vit, 1152, 4304, 10, True, "SigLIP fc1", bf16)]
    for t, k, n, label, bias in ((8 * 148, 1536, 1536, "t2i prefill q", bf16),
                                 (8 * 148, 1536, 256, "t2i prefill k/v", bf16),
                                 (8 * 148, 1536, 8960, "t2i prefill gate/up", None),
                                 (8 * 148, 8960, 1536, "t2i prefill down", None),
                                 (t_step, 1536, 1536, "t2i step o", None),
                                 (b, 1536, 1536, "decode o", None),
                                 (t_pre, 1536, 1536, "understand prefill q", bf16),
                                 (t_pre, 1536, 256, "understand prefill k/v", bf16),
                                 (t_pre, 8960, 1536, "understand prefill down", None),
                                 (t_vit, 1152, 1152, "SigLIP q/k/v/o", bf16),
                                 (t_vit, 4304, 1152, "SigLIP fc2", bf16),
                                 (5, 128, 96, "ragged", None), (37, 512, 1000, "ragged", f32),
                                 (16, 64, 161, "ragged", bf16), (17, 96, 40, "ragged", f32),
                                 (300, 1024, 1000, "ragged", bf16)):
        phase_w8a8(gen, t, k, n, 0, False, label, bias)
    results["w8a8_epilogue"] = dict(timed[0], shapes=timed[1:],
                                    int_mm_layout=phase_int_mm_layout(gen, t_step, 1536, 8960,
                                                                      20))


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------

def _counters():
    """Every launch count a path phase reads: the port's kernels, and
    ``int8_matmul`` (the W8A8 layers' ``torch._int_mm`` calls on the card)."""
    from unigen_tpu_torch.ops.chunk_attention import chunk_attention
    from unigen_tpu_torch.ops.flash_attention import flash_attention
    from unigen_tpu_torch.ops.fused_conv import conv3x3_gn_swish, gn_affine
    from unigen_tpu_torch.ops.int4 import w4a8_matmul
    from unigen_tpu_torch.ops.quantization import (int8_matmul, quantize_activations,
                                                   w8a8_epilogue)
    return {"flash_attention": flash_attention, "chunk_attention": chunk_attention,
            "conv3x3_gn_swish": conv3x3_gn_swish, "gn_affine": gn_affine,
            "w4a8_matmul": w4a8_matmul, "quantize_activations": quantize_activations,
            "w8a8_epilogue": w8a8_epilogue, "int8_matmul": int8_matmul}


NO_LAUNCHES = dict.fromkeys(("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                             "gn_affine", "w4a8_matmul", "quantize_activations",
                             "w8a8_epilogue", "int8_matmul"), 0)


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


# the port's hand-written kernels: a profile prints them even below its top rows
PORT_KERNELS = ("attention_bf16_kernel", "chunk_split_bf16_kernel", "chunk_combine_kernel",
                "w4a8_", "quantize_kernel", "conv3x3", "gn_partial", "gn_finish",
                "w8a8_epilogue")
# kernel families by name, first match wins: what is the port's, cuBLAS's, and
# what is left of plain-torch elementwise work
FAMILIES = (("kernel 4 (w4a8_*)", ("w4a8_",)), ("quantization kernel", ("quantize_kernel",)),
            ("W8A8 epilogue kernel", ("w8a8_epilogue",)),
            ("cuBLAS int8 GEMMs (torch._int_mm)", ("gemm_s8", "_s8_", "i8i8")),
            ("attention kernels 1, 2", ("attention_bf16", "chunk_split", "chunk_combine",
                                        "attention_fp32")),
            ("conv kernel 3", ("conv3x3",)),
            ("GroupNorm statistics kernel", ("gn_partial", "gn_finish")),
            ("cuBLAS / cuDNN GEMMs and convs", ("gemm", "nvjet", "cutlass", "xmma", "cudnn")),
            ("plain-torch copies and casts", ("copy",)),
            ("plain-torch reductions", ("reduce",)),
            ("plain-torch elementwise", ("elementwise", "index", "scatter", "gather", "cat",
                                         "fill")))


def profile_run(run_once, warm_s: float, top: int = 12) -> None:
    """Device time by kernel over one more warm run of a path. Busy time is the
    union of the device intervals (GPU annotations overlap their kernels and
    are not counted twice); the idle share is taken against the unprofiled
    warm run's wall time. The port's kernels are printed by name wherever they
    rank, and every kernel is summed into a family (``FAMILIES``)."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (ms, count)) in enumerate(ranked):
        if rank < top or any(k in name for k in PORT_KERNELS):
            print(f"    {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<6d} {name[:100]}")
    families = {}
    for name, (ms, count) in by_name.items():
        low = name.lower()
        fam = next((f for f, keys in FAMILIES if any(k in low for k in keys)), "other")
        f_ms, f_count = families.get(fam, (0.0, 0))
        families[fam] = (f_ms + ms, f_count + count)
    print("  by family:")
    for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<7d} {fam}")


@contextlib.contextmanager
def conv_census(census):
    """Counts, while it is open, the launches of kernel 3 and of the GroupNorm
    statistics that each of the decoder's conv calls makes, by (H = W, C, Cout,
    GN) into ``census`` as [conv launches, statistics launches]."""
    from unigen_tpu_torch.models import magvit
    from unigen_tpu_torch.ops import fused_conv as FC
    real = magvit.conv3x3_gn_swish

    def counted(conv_p, gn_p, x, *args, **kw):
        conv0, gn0 = FC.conv3x3_gn_swish.launches, FC.gn_affine.launches
        out = real(conv_p, gn_p, x, *args, **kw)
        n = census.setdefault((x.shape[1], x.shape[3], conv_p["kernel"].shape[3],
                               gn_p is not None), [0, 0])
        n[0] += FC.conv3x3_gn_swish.launches - conv0
        n[1] += FC.gn_affine.launches - gn0
        return out
    magvit.conv3x3_gn_swish = counted
    try:
        yield census
    finally:
        magvit.conv3x3_gn_swish = real


def conv_batch_sums(results):
    """Fills kernel 3's and the statistics' launches_per_batch and batch_ms
    (the sum of launches x ms over a t2i batch, the decoder's) and
    encoder_batch_ms (over an understand_discrete call, the encoder's) from
    the censuses of the flagship and understand_discrete runs; they stay
    null where that phase or the timed shapes did not run."""
    for part, rows_key, census_key, field, phase in (
            ("decoder", "conv_rows", "conv_census", "batch_ms", "flagship"),
            ("encoder", "encoder_conv_rows", "encoder_census", "encoder_batch_ms",
             "understand_discrete")):
        rows, census = results.get(rows_key), results.get(census_key)
        if not rows:
            continue
        if census is None:
            print(f"  sum of launches x ms over the {part}: not computed (the {phase} phase, "
                  "which counts the launches by shape, did not run)")
            results["conv3x3_gn_swish"][field] = results["gn_affine"][field] = None
            continue
        _conv_sum(results, part, rows, census, field)


def _conv_sum(results, part, rows, census, field):
    total = gn_total = b_total = lib_total = 0.0
    for key, conv_row, gn_row in rows:
        n_conv, n_gn = census.get(key, (0, 0))
        conv_row["launches_per_batch"] = n_conv
        total += n_conv * conv_row["ms"]
        b_total += n_conv * conv_row["bound_ms"]
        lib_total += n_conv * conv_row["library_ms"]
        if gn_row is not None:
            gn_row["launches_per_batch"] = n_gn
            gn_total += n_gn * gn_row["ms"]
    results["conv3x3_gn_swish"][field] = total
    results["gn_affine"][field] = gn_total
    print(f"kernel 3 in the {part} (the path run's launches by shape x each shape's ms): "
          f"{total:.4f} ms (statistics + conv), of it the statistics {gn_total:.4f} ms; bound "
          f"{b_total:.4f} ms; cuDNN {lib_total:.4f} ms")


def _timed_runs(name, run_once, expect, runs=("cold", "warm"), census=None, validate=None,
                work=None):
    """Runs a path ``runs`` times, each with the launch counts set to 0 just
    before and read just after, checks them against ``expect`` and each
    run's output with ``validate``; ``work`` = (count, unit) prints a rate.
    The warm run also counts kernel 3's launches by shape into ``census``
    when given. Returns (the last run's output, its wall seconds, enqueue
    seconds, counts)."""
    import torch
    for run in runs:
        _reset_counts()
        torch.cuda.synchronize()
        with conv_census(census) if census is not None and run == "warm" else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            out = run_once()
            enqueued = time.perf_counter() - t0  # the host's share: work queued, not done
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = _read_counts()
        rate = f", {work[0] / dt:.4f} {work[1]}/s" if work else ""
        print(f"  {name} {run} run: {dt:.3f} s ({enqueued:.3f} s to enqueue){rate}, "
              f"launches {counts}")
        check(counts == expect, f"{name} launch counts {counts} != {expect}")
        if validate is not None:
            validate(out)
    return out, dt, enqueued, counts


def _t2i_checker(name, pipe):
    """Checks a t2i run's (codes, pixels): codes in the codebook, finite
    pixels of 256 px."""
    import torch

    def validate(out):
        codes, pixels = out
        check(tuple(codes.shape) == (len(PROMPTS), pipe.cfg.num_vq_tokens) and
              bool(((codes >= 0) & (codes < pipe.cfg.codebook_size)).all()), f"{name} codes")
        check(tuple(pixels.shape) == (len(PROMPTS), 256, 256, 3) and
              bool(torch.isfinite(pixels).all()), f"{name} pixels")
    return validate


def _t2i_run(pipe, **kw):
    """One GenEval t2i call of the 4 prompts (guidance 6, text budget 128,
    generator seed 0) and its decode: () -> (codes, pixels)."""
    import torch

    def run_once():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        codes = pipe.generate_images(list(PROMPTS), gen, guidance_scale=6.0, max_text_len=128,
                                     return_codes=True, **kw)
        return codes, pipe.decode_codes(codes)
    return run_once


def run_flagship(results, profile=False):
    import torch
    print("phase: flagship path (Qwen2.5-1.5B + MAGViTv2, random init, bf16, 4 prompts, "
          "guidance 6, 50 steps, max_text_len 128)")
    pipe = flagship_pipeline()
    layers = pipe.cfg.llm.num_hidden_layers
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * 50,
                  conv3x3_gn_swish=44, gn_affine=40)
    census = {}
    run_once = _t2i_run(pipe, timesteps=50)
    # the warm run also counts kernel 3's launches by shape (44 wrapped Python
    # calls; their cost is within the run's noise)
    (codes, _), dt, enqueued, counts = _timed_runs(
        "flagship", run_once, expect, census=census, validate=_t2i_checker("flagship", pipe),
        work=(len(PROMPTS), "images"))
    expect_census = {(hw, c, cout, gn): [n, n if gn else 0]
                     for hw, c, cout, gn, n in DECODER_CONVS}
    print("  warm run, kernel 3 launches by (H = W, C, Cout, GN): [conv, statistics]: "
          + ", ".join(f"{k}: {v}" for k, v in sorted(census.items())))
    check(census == expect_census, f"decoder conv launches {census} != {expect_census}")
    results["conv_census"] = census
    if profile:
        profile_run(run_once, dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.decode_codes(codes)
        torch.cuda.synchronize()
        print("  profile of the decoder alone (decode_codes):")
        profile_run(lambda: pipe.decode_codes(codes), time.perf_counter() - t0)
    ids, _ = pipe.prompt_ids(list(PROMPTS), 128)
    print(f"  prompt length {ids.shape[1]} (prefix {ids.shape[1] - 258}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship"] = {"seconds": dt, "enqueue_s": enqueued,
                           "images_per_s": len(PROMPTS) / dt}
    results["flagship_codes"] = codes
    return counts


def run_flagship_int8(results, profile=False):
    """The t2i flagship on W8A8, JAX's shipped t2i default
    (``build_pipeline(quantization="int8")``: backbone and image head int8):
    the same seed-0 weights, prompts and generator seed as ``run_flagship``,
    fixed launch counts, images/s, and the codes' agreement with the bf16 run
    of this call (random weights: not a gate)."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: flagship_int8 path (the flagship t2i with build_pipeline(quantization="
          "'int8'): W8A8 backbone and image head, the same weights, prompts and seeds)")
    t0 = time.perf_counter()
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0,
                          quantization="int8")
    torch.cuda.synchronize()
    print(f"  build_pipeline(quantization='int8') {time.perf_counter() - t0:.2f} s")
    layers, steps = pipe.cfg.llm.num_hidden_layers, 50
    # the prefill (7 projections a layer, 4 quantizations) and 50 steps, each
    # with the image head (one more of each)
    dense = 7 * layers * (steps + 1) + steps
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * steps,
                  conv3x3_gn_swish=44, gn_affine=40,
                  quantize_activations=4 * layers + steps * (4 * layers + 1),
                  w8a8_epilogue=dense, int8_matmul=dense)
    run_once = _t2i_run(pipe, timesteps=steps)
    (codes, _), dt, enqueued, counts = _timed_runs(
        "flagship_int8", run_once, expect, validate=_t2i_checker("flagship_int8", pipe),
        work=(len(PROMPTS), "images"))
    out = {"seconds": dt, "enqueue_s": enqueued, "images_per_s": len(PROMPTS) / dt}
    if "flagship_codes" in results:
        out["agreement_with_bf16"] = (codes == results["flagship_codes"]).float().mean().item()
        bf = results["flagship"]
        print(f"  beside the bf16 run of this call: {bf['seconds']:.3f} s ({bf['enqueue_s']:.3f} s "
              f"to enqueue), {bf['images_per_s']:.4f} images/s; codes agree with bf16's on "
              f"{out['agreement_with_bf16']:.4f} (random weights; not a gate)")
    if profile:
        profile_run(run_once, dt)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship_int8"] = out
    return counts


def _vqa_pixels(pipe):
    """8 uint8 images at the tower's size, from generator seed 7."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    size = pipe.vision_cfg.image_size
    return torch.randint(0, 256, (len(QUESTIONS), size, size, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)


def _token_checker(name, vocab, b=len(QUESTIONS)):
    def validate(toks):
        check(tuple(toks.shape) == (b, NEW_TOKENS) and bool(((toks >= 0) & (toks < vocab)).all()),
              f"{name} tokens {tuple(toks.shape)} out of range")
    return validate


def run_understand(results, profile=False):
    """SigLIP VQA at full width: bf16, 8 uint8 images of 384 px, 8 questions,
    128 new tokens, greedy; the backbone and text head in W4A8 (group 256),
    then the same call with the bf16 backbone as a yardstick."""
    import dataclasses
    import torch
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    print("phase: understand path (SigLIP-SO400M + projector + Qwen2.5-1.5B W4A8, random "
          f"init, bf16, {len(QUESTIONS)} images of 384 px, {NEW_TOKENS} new tokens, greedy)")
    pipe = flagship_pipeline(vision=True)
    t0 = time.perf_counter()
    qpipe = dataclasses.replace(pipe, params=quantize_unigen_params_int4(pipe.params, pipe.cfg))
    torch.cuda.synchronize()
    print(f"  quantize_unigen_params_int4 {time.perf_counter() - t0:.2f} s")
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    layers = pipe.cfg.llm.num_hidden_layers
    per_forward = 7 * layers + 1                     # q, k, v, o, gate, up, down + head
    quant_per_forward = 4 * layers + 1               # q/k/v, o, gate/up, down + head
    expect_q = dict(NO_LAUNCHES, flash_attention=pipe.vision_cfg.num_layers_used + layers,
                    chunk_attention=layers * (NEW_TOKENS - 1),
                    w4a8_matmul=per_forward * NEW_TOKENS,
                    quantize_activations=quant_per_forward * NEW_TOKENS)
    validate = _token_checker("understand", pipe.cfg.llm.vocab_size)

    def run(p):
        return p.understand(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)

    out = {}
    for name, p, expect in (("w4a8", qpipe, expect_q),
                            ("bf16", pipe, dict(expect_q, w4a8_matmul=0, quantize_activations=0))):
        toks, dt, enqueued, counts = _timed_runs(f"understand {name}", lambda p=p: run(p), expect,
                                                 validate=validate, work=(b * NEW_TOKENS, "tokens"))
        out[name] = {"seconds": dt, "enqueue_s": enqueued, "tokens_per_s": b * NEW_TOKENS / dt,
                     "tokens": toks, "counts": counts}
    agree = (out["w4a8"]["tokens"] == out["bf16"]["tokens"]).float().mean().item()
    print(f"  W4A8 vs bf16 backbone token agreement {agree:.4f} (random weights; not a gate)")
    if profile:
        for name, p in (("w4a8", qpipe), ("bf16", pipe)):
            print(f"  profile of the {name} understand call:")
            profile_run(lambda: run(p), out[name]["seconds"])
    l, _ = understand_prompt_shape(pipe)
    p = pipe.vision_cfg.num_patches
    print(f"  prompt length {l} (3 + {p} image + {l - 3 - p} question), cache "
          f"{l + NEW_TOKENS} slots, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["understand"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                             for k, v in out.items()}
    results["understand_tokens"] = {k: v["tokens"] for k, v in out.items()}
    return out["w4a8"]["counts"]


def run_understand_int8(results, profile=False):
    """SigLIP VQA as JAX's ``int8+kv``: ``build_pipeline(vision=True,
    quantization="int8", quantized_cache=True)`` puts the tower, the backbone
    and the text head on W8A8 and keeps K/V in int8. The same weights,
    pixels, questions and 128 greedy tokens as ``run_understand``; tokens/s
    beside its W4A8 and bf16 runs of this call."""
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: understand_int8 path (SigLIP-SO400M + Qwen2.5-1.5B, all W8A8, int8 KV cache, "
          f"{len(QUESTIONS)} images of 384 px, {NEW_TOKENS} new tokens, greedy)")
    t0 = time.perf_counter()
    pipe = build_pipeline("flagship", dtype=torch.bfloat16, device="cuda", seed=0, vision=True,
                          quantization="int8", quantized_cache=True)
    torch.cuda.synchronize()
    print(f"  build_pipeline(vision=True, quantization='int8', quantized_cache=True) "
          f"{time.perf_counter() - t0:.2f} s")
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    layers, vit = pipe.cfg.llm.num_hidden_layers, pipe.vision_cfg.num_layers_used
    # a forward: 7 projections and 4 quantizations a layer, and the head; the
    # tower: q/k/v, o, fc1, fc2 on 4 quantizations a layer. No chunk kernel:
    # the int8 cache's decode steps run the plain q8 attention.
    dense = (7 * layers + 1) * NEW_TOKENS + 6 * vit
    expect = dict(NO_LAUNCHES, flash_attention=vit + layers,
                  quantize_activations=(4 * layers + 1) * NEW_TOKENS + 4 * vit,
                  w8a8_epilogue=dense, int8_matmul=dense)

    def run_once():
        return pipe.understand(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)
    toks, dt, enqueued, counts = _timed_runs(
        "understand_int8 (int8+kv)", run_once, expect,
        validate=_token_checker("understand_int8", pipe.cfg.llm.vocab_size),
        work=(b * NEW_TOKENS, "tokens"))
    out = {"seconds": dt, "enqueue_s": enqueued, "tokens_per_s": b * NEW_TOKENS / dt}
    if "understand" in results:
        u = results["understand"]
        out["agreement_with_bf16"] = (
            toks == results["understand_tokens"]["bf16"]).float().mean().item()
        print(f"  beside this call's understand runs: W4A8 {u['w4a8']['tokens_per_s']:.2f} "
              f"tokens/s ({u['w4a8']['seconds']:.3f} s), bf16 {u['bf16']['tokens_per_s']:.2f} "
              f"tokens/s ({u['bf16']['seconds']:.3f} s); tokens agree with bf16's on "
              f"{out['agreement_with_bf16']:.4f} (random weights; not a gate)")
    if profile:
        profile_run(run_once, dt)
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["understand_int8"] = out
    return counts


def run_flagship_ar(results, profile=False):
    """GenEval t2i with ``mode="ar"``: the 4 prompts, guidance 6, bf16; one
    prefill and 255 cached steps of 8 rows (cond and uncond), then the
    decoder."""
    import torch
    print("phase: flagship_ar path (Qwen2.5-1.5B + MAGViTv2, random init, bf16, 4 prompts, "
          "mode='ar', guidance 6, max_text_len 128)")
    pipe = flagship_pipeline()
    layers, n = pipe.cfg.llm.num_hidden_layers, pipe.cfg.num_vq_tokens
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * (n - 1),
                  conv3x3_gn_swish=44, gn_affine=40)
    run_once = _t2i_run(pipe, mode="ar")
    _, dt, enqueued, counts = _timed_runs("flagship_ar", run_once, expect,
                                          validate=_t2i_checker("flagship_ar", pipe),
                                          work=(len(PROMPTS), "images"))
    if profile:
        profile_run(run_once, dt)
    lp, _ = ar_prompt_layout(pipe)
    print(f"  prefill [{2 * len(PROMPTS)}, {lp}], cache {lp + n} slots, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["flagship_ar"] = {"seconds": dt, "enqueue_s": enqueued,
                              "images_per_s": len(PROMPTS) / dt}
    return counts


def run_understand_discrete(results, profile=False):
    """VQA over the tokenizer's codes: 8 fp32 images of 256 px in [-1, 1]
    through the MAGViTv2 encoder (in the pixels' dtype, batch 8), the mmu
    prompt right-padded to 1,603, the bf16 backbone, 128 greedy tokens;
    kernel 3's launches counted by shape."""
    import torch
    print("phase: understand_discrete path (MAGViTv2 encoder on fp32 pixels + Qwen2.5-1.5B bf16, "
          f"random init, {len(QUESTIONS)} images of 256 px, {NEW_TOKENS} new tokens, greedy)")
    pipe = flagship_pipeline()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    b = len(QUESTIONS)
    pixels = torch.rand((b, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    layers = pipe.cfg.llm.num_hidden_layers
    expect = dict(NO_LAUNCHES, flash_attention=layers, chunk_attention=layers * (NEW_TOKENS - 1),
                  conv3x3_gn_swish=40, gn_affine=40)
    census = {}

    def run_once():
        return pipe.understand_discrete(pixels, list(QUESTIONS), None, max_new_tokens=NEW_TOKENS)
    _, dt, enqueued, counts = _timed_runs(
        "understand_discrete", run_once, expect, census=census,
        validate=_token_checker("understand_discrete", pipe.cfg.llm.vocab_size),
        work=(b * NEW_TOKENS, "tokens"))
    if profile:
        profile_run(run_once, dt)
        t0 = time.perf_counter()
        pipe.encode_pixels(pixels)
        torch.cuda.synchronize()
        print("  profile of the encoder alone (encode_pixels):")
        profile_run(lambda: pipe.encode_pixels(pixels), time.perf_counter() - t0)
    expect_census = {(hw, c, cout, gn): [n, n] for hw, c, cout, gn, n in ENCODER_CONVS}
    print("  warm run, kernel 3 launches by (H = W, C, Cout, GN): [conv, statistics]: "
          + ", ".join(f"{k}: {v}" for k, v in sorted(census.items())))
    check(census == expect_census, f"encoder conv launches {census} != {expect_census}")
    codes = pipe.encode_pixels(pixels)
    check(tuple(codes.shape) == (b, pipe.cfg.num_vq_tokens) and
          bool(((codes >= 0) & (codes < pipe.cfg.codebook_size)).all()), "encode_pixels codes")
    ids, _, _ = mmu_prompt_layout(pipe)
    print(f"  prefill [{b}, {ids.shape[1]}], cache {ids.shape[1] + NEW_TOKENS} slots, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    results["encoder_census"] = census
    results["understand_discrete"] = {"seconds": dt, "enqueue_s": enqueued,
                                      "tokens_per_s": b * NEW_TOKENS / dt}
    return counts


def run_score(results, profile=False):
    """Continuation scoring (the lmms-eval loglikelihood call): SigLIP +
    projector + one cache-free backbone forward, bf16, 8 images of 384 px x
    question x a continuation of 1-16 tokens."""
    import numpy as np
    print("phase: score path (SigLIP-SO400M + projector + Qwen2.5-1.5B, random init, bf16, "
          f"{len(QUESTIONS)} (image, question, continuation) requests)")
    pipe = flagship_pipeline(vision=True)
    b = len(QUESTIONS)
    pixels = _vqa_pixels(pipe)
    conts = score_conts(pipe)
    expect = dict(NO_LAUNCHES, flash_attention=pipe.vision_cfg.num_layers_used +
                  pipe.cfg.llm.num_hidden_layers)

    def run_once():
        return pipe.score_continuations(pixels, list(QUESTIONS), conts)

    def validate(out):
        check(len(out) == b and all(np.isfinite(lp) and lp <= 0 and isinstance(g, bool)
                                    for lp, g in out), f"score results {out}")
    out, dt, enqueued, counts = _timed_runs("score", run_once, expect, validate=validate,
                                            work=(b, "requests"))
    if profile:
        profile_run(run_once, dt)
    l_score, _ = score_layout(pipe)
    print(f"  forward [{b}, {l_score}], continuations of {[len(c) for c in conts]} tokens; "
          f"log-likelihoods {[round(lp, 3) for lp, _ in out]}")
    results["score"] = {"seconds": dt, "enqueue_s": enqueued, "requests_per_s": b / dt}
    return counts


def run_geneval(results, profile=False):
    """``evaluation.geneval.run_geneval`` over 2 metadata lines x 4 samples
    (mode mask, guidance 6, 50 steps, bf16) into a temporary directory; every
    PNG must decode back to ``pixels_to_uint8`` of its prompt's batch."""
    import dataclasses
    import os
    import tempfile
    import torch
    from unigen_tpu_torch.evaluation import geneval
    from unigen_tpu_torch.pipeline import pixels_to_uint8
    print("phase: geneval (run_geneval, 2 prompts x 4 samples, guidance 6, 50 steps, PNG writes)")
    pipe = dataclasses.replace(flagship_pipeline())    # a copy whose generate_images records
    metadata = [{"prompt": p} for p in PROMPTS[:2]]
    n_samples, layers = 4, pipe.cfg.llm.num_hidden_layers
    expect = dict(NO_LAUNCHES, flash_attention=2 * layers, chunk_attention=2 * 50 * layers,
                  conv3x3_gn_swish=2 * 44, gn_affine=2 * 40)
    batches = []
    real = pipe.generate_images

    def recorded(*a, **kw):
        batches.append(real(*a, **kw))
        return batches[-1]
    pipe.generate_images = recorded
    with tempfile.TemporaryDirectory() as tmp:
        def run_once():
            batches.clear()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            return geneval.run_geneval(pipe, metadata, os.path.join(tmp, "out"), gen,
                                       n_samples=n_samples)
        written, dt, enqueued, counts = _timed_runs("geneval", run_once, expect,
                                                    work=(len(metadata) * n_samples, "images"))
        if profile:
            profile_run(run_once, dt)
        check(len(written) == len(metadata) == len(batches), f"geneval wrote {written}")
        for d, md, pixels in zip(written, metadata, batches):
            want = pixels_to_uint8(pixels)
            check(geneval.load_metadata_jsonl(os.path.join(d, "metadata.jsonl")) == [md],
                  f"{d}: metadata")
            for i in range(n_samples):
                got = geneval.load_png(os.path.join(d, "samples", f"{i:05}.png"))
                check(got.shape == (256, 256, 3) and (got == want[i]).all(),
                      f"{d} sample {i}: the PNG does not decode to its batch's pixels")
        imgs = [im for pixels in batches for im in pixels_to_uint8(pixels)]
        t0 = time.perf_counter()
        for i, im in enumerate(imgs):
            geneval.save_png(im, os.path.join(tmp, f"{i}.png"))
        png_s = time.perf_counter() - t0
    rate = len(metadata) * n_samples / dt
    print(f"  {len(metadata) * n_samples} PNGs decode to their batches' pixels; {rate:.4f} "
          f"images/s with the PNG writes; the {len(imgs)} writes alone take {png_s:.3f} s")
    results["geneval"] = {"seconds": dt, "images_per_s": rate}
    return counts


def run_tiny_slice():
    """The tiny fp32 pipeline through the kernels on the card against the
    plain versions on the CPU: the codes of ``encode_pixels``, AR tokens
    under shared noise, ``understand_discrete``'s greedy tokens (agreement
    >= 0.99 each) and ``score_continuations`` (relative difference <= 1e-4)."""
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 encode, AR t2i, discrete understanding and scoring, kernels on the "
          "card vs plain versions on the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    gpu = cpu.to("cuda")
    b, res = len(QUESTIONS), cpu.vq_cfg.resolution
    rng = np.random.default_rng(6)
    px = rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32)

    def launched(fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, _read_counts()
    codes_gpu, c_enc = launched(lambda: gpu.encode_pixels(px))
    enc = (codes_gpu.cpu() == cpu.encode_pixels(px)).float().mean().item()
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    noise = rng.random((n, len(PROMPTS), cb), dtype=np.float32)
    kw = dict(guidance_scale=6.0, max_text_len=16, mode="ar", return_codes=True)
    ar_gpu, c_ar = launched(lambda: gpu.generate_images(
        list(PROMPTS), None, noise=torch.from_numpy(noise).cuda(), **kw))
    ar = (ar_gpu.cpu() == cpu.generate_images(list(PROMPTS), None,
                                              noise=torch.from_numpy(noise), **kw)
          ).float().mean().item()
    und_gpu, c_und = launched(lambda: gpu.understand_discrete(px, list(QUESTIONS), None,
                                                              max_new_tokens=32))
    und = (und_gpu.cpu() == cpu.understand_discrete(px, list(QUESTIONS), None,
                                                    max_new_tokens=32)).float().mean().item()
    img = rng.integers(0, 256, (b, cpu.vision_cfg.image_size, cpu.vision_cfg.image_size, 3),
                       dtype=np.uint8)
    conts = score_conts(cpu)
    sc_gpu, c_sc = launched(lambda: gpu.score_continuations(img, list(QUESTIONS), conts))
    sc_cpu = cpu.score_continuations(img, list(QUESTIONS), conts)
    rel = max(abs(g - c) / max(abs(c), 1e-30) for (g, _), (c, _) in zip(sc_gpu, sc_cpu))
    flags = np.mean([g == c for (_, g), (_, c) in zip(sc_gpu, sc_cpu)])
    print(f"  encode_pixels code agreement {enc:.4f}, AR token agreement {ar:.4f}, "
          f"understand_discrete token agreement {und:.4f} (each need >= 0.99); score "
          f"log-likelihoods max relative difference {rel:.3e} (need <= 1e-4), greedy flags "
          f"agree on {flags:.4f}")
    print(f"  launches: encode {c_enc}; AR {c_ar}; understand_discrete {c_und}; score {c_sc}")
    check(c_enc["conv3x3_gn_swish"] > 0 and c_enc["gn_affine"] > 0,
          f"tiny encode skipped kernel 3: {c_enc}")
    check(c_ar["flash_attention"] > 0 and c_ar["chunk_attention"] > 0,
          f"tiny AR skipped an attention kernel: {c_ar}")
    check(all(c_und[k] > 0 for k in ("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                                     "gn_affine")), f"tiny understand_discrete launches {c_und}")
    check(c_sc["flash_attention"] > 0 and c_sc["chunk_attention"] == 0,
          f"tiny score launches {c_sc}")
    check(enc >= 0.99 and ar >= 0.99 and und >= 0.99 and rel <= 1e-4,
          f"tiny slice agreement: encode {enc}, AR {ar}, understand_discrete {und}, score {rel}")


def run_tiny_understand():
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4
    print("phase: tiny fp32 W4A8 understand, kernels on the card vs plain versions on the "
          "CPU, greedy")
    import dataclasses
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True)
    cpu = dataclasses.replace(cpu, params=quantize_unigen_params_int4(cpu.params, cpu.cfg,
                                                                      group=32))
    gpu = cpu.to("cuda")
    size = cpu.vision_cfg.image_size
    pixels = np.random.default_rng(6).integers(0, 256, (len(QUESTIONS), size, size, 3),
                                               dtype=np.uint8)
    _reset_counts()
    toks_gpu = gpu.understand(pixels, list(QUESTIONS), None, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _read_counts()
    toks_cpu = cpu.understand(pixels, list(QUESTIONS), None, max_new_tokens=32)
    agree = (toks_gpu.cpu() == toks_cpu).float().mean().item()
    print(f"  token agreement {agree:.4f} (need >= 0.99), launches {counts}")
    check(all(counts[k] > 0 for k in ("flash_attention", "chunk_attention", "w4a8_matmul",
                                      "quantize_activations")),
          f"tiny understand skipped a kernel: {counts}")
    check(agree >= 0.99, f"tiny understand token agreement {agree}")


@contextlib.contextmanager
def decode_decisions(record, force=None):
    """While open, records each step's greedy decision of
    ``generation.decode`` ([B] tokens a step) into ``record``; with ``force``
    ([B, steps] tokens) every step continues from force's token instead of
    its own, so that two runs decide each step from the same history."""
    from unigen_tpu_torch.generation import decode as TD
    real = TD._sample_step

    def spy(generator, logits, temperature, top_k, inj=None):
        tok = real(generator, logits, temperature, top_k, inj)
        record.append(tok.cpu())
        return tok if force is None else force[:, len(record) - 1].to(tok.device)
    TD._sample_step = spy
    try:
        yield record
    finally:
        TD._sample_step = real


def run_tiny_int8():
    """The tiny fp32 pipeline with ``quantization="int8"``: understand with
    W8A8 alone and with the int8 KV cache (greedy), and t2i on the int8
    image head (shared noise), through the kernels on the card against the
    plain versions on the CPU. An fp32 difference in the last bits (sums in
    another order) can move a value across an int8 rounding boundary, and a
    greedy decode then follows the moved token for the rest of its row; so
    the int8-cache run is held per decision, each step decided from the
    CPU's history (the per-step measure of JAX's int8 gates), and its
    free-running agreement is printed beside it."""
    import dataclasses
    import numpy as np
    import torch
    from unigen_tpu_torch.launch import build_pipeline
    print("phase: tiny fp32 int8 (W8A8, int8 KV cache), kernels on the card vs plain versions on "
          "the CPU")
    cpu = build_pipeline("tiny", dtype=torch.float32, device="cpu", seed=3, vision=True,
                         quantization="int8", quantized_cache=True)
    gpu = cpu.to("cuda")
    size = cpu.vision_cfg.image_size
    pixels = np.random.default_rng(6).integers(0, 256, (len(QUESTIONS), size, size, 3),
                                               dtype=np.uint8)

    def understand(p):
        return p.understand(pixels, list(QUESTIONS), None, max_new_tokens=32).cpu()
    _reset_counts()
    toks_gpu = understand(gpu)
    torch.cuda.synchronize()
    u_counts = _read_counts()
    cpu_dec, gpu_dec = [], []
    with decode_decisions(cpu_dec):
        toks_cpu = understand(cpu)
    with decode_decisions(gpu_dec, force=toks_cpu):
        understand(gpu)
    per_decision = (torch.stack(gpu_dec, 1) == torch.stack(cpu_dec, 1)).float().mean().item()
    free = (toks_gpu == toks_cpu).float().mean().item()
    w8 = (understand(dataclasses.replace(gpu, quantized_cache=False)) ==
          understand(dataclasses.replace(cpu, quantized_cache=False))).float().mean().item()
    b, steps = len(PROMPTS), 8
    n, cb = cpu.cfg.num_vq_tokens, cpu.cfg.codebook_size
    rng = np.random.default_rng(5)
    u_sample = rng.random((steps, b, n, cb), dtype=np.float32)
    u_mask = rng.random((steps, b, n), dtype=np.float32)
    kw = dict(guidance_scale=6.0, timesteps=steps, max_text_len=16, return_codes=True)
    _reset_counts()
    codes_gpu = gpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample).cuda(), torch.from_numpy(u_mask).cuda()), **kw)
    torch.cuda.synchronize()
    t_counts = _read_counts()
    codes_cpu = cpu.generate_images(list(PROMPTS), None, noise=(
        torch.from_numpy(u_sample), torch.from_numpy(u_mask)), **kw)
    t_agree = (codes_gpu.cpu() == codes_cpu).float().mean().item()
    print(f"  understand, W8A8 + int8 KV cache: decisions from the CPU's histories agree on "
          f"{per_decision:.4f} (need >= 0.99); free-running token agreement {free:.4f}; "
          f"launches {u_counts}")
    print(f"  understand, W8A8 alone: token agreement {w8:.4f} (need >= 0.99)")
    print(f"  t2i (int8 image head) token agreement {t_agree:.4f} (need >= 0.99), launches "
          f"{t_counts}")
    check(all(u_counts[k] > 0 for k in ("flash_attention", "w8a8_epilogue",
                                        "quantize_activations")) and
          u_counts["chunk_attention"] == 0, f"tiny int8 understand launches {u_counts}")
    check(all(t_counts[k] > 0 for k in ("flash_attention", "chunk_attention", "w8a8_epilogue",
                                        "quantize_activations")),
          f"tiny int8 t2i skipped a kernel: {t_counts}")
    check(per_decision >= 0.99 and w8 >= 0.99 and t_agree >= 0.99,
          f"tiny int8 agreement: int8-cache decisions {per_decision}, W8A8 understand {w8}, "
          f"t2i {t_agree}")


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
    check(all(counts[k] > 0 for k in ("flash_attention", "chunk_attention", "conv3x3_gn_swish",
                                      "gn_affine")),
          f"tiny path skipped a kernel: {counts}")
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
    path_counts = {}
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
            path_counts["t2i"] = run_flagship(results, profile="profile" in phases)
        if "flagship_int8" in phases:
            path_counts["t2i_int8"] = run_flagship_int8(results, profile="profile" in phases)
        if "flagship_ar" in phases:
            path_counts["t2i_ar"] = run_flagship_ar(results, profile="profile" in phases)
        if "understand" in phases:
            path_counts["understand"] = run_understand(results, profile="profile" in phases)
        if "understand_int8" in phases:
            path_counts["understand_int8"] = run_understand_int8(results,
                                                                 profile="profile" in phases)
        if "understand_discrete" in phases:
            path_counts["understand_discrete"] = run_understand_discrete(
                results, profile="profile" in phases)
        if "score" in phases:
            path_counts["score"] = run_score(results, profile="profile" in phases)
        if "geneval" in phases:
            path_counts["geneval"] = run_geneval(results, profile="profile" in phases)
        if "tiny" in phases:
            run_tiny()
            run_tiny_understand()
            run_tiny_int8()
            run_tiny_slice()
        conv_batch_sums(results)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    replaces = {"chunk_attention": "unigen_tpu/ops/chunk_attention.py:70",
                "flash_attention": "unigen_tpu/ops/flash_attention.py:95",
                "conv3x3_gn_swish": "unigen_tpu/ops/fused_conv.py:239",
                # XLA in the JAX package (the pre-pass of the Pallas conv), not Pallas
                "gn_affine": "unigen_tpu/ops/fused_conv.py:172",
                "w4a8_matmul": "unigen_tpu/ops/int4.py:95",
                # an XLA fusion in the JAX package, not a Pallas kernel
                "quantize_activations": "unigen_tpu/ops/quantization.py:50",
                # the XLA fusion that ends dense_int8_prequant, not a Pallas kernel
                "w8a8_epilogue": "unigen_tpu/ops/quantization.py:62"}
    sources = {"chunk_attention": "unigen_tpu_torch/csrc/attention.cu",
               "flash_attention": "unigen_tpu_torch/csrc/attention.cu",
               "conv3x3_gn_swish": "unigen_tpu_torch/csrc/fused_conv.cu",
               "gn_affine": "unigen_tpu_torch/csrc/fused_conv.cu",
               "w4a8_matmul": "unigen_tpu_torch/csrc/int4.cu",
               "quantize_activations": "unigen_tpu_torch/csrc/int4.cu",
               "w8a8_epilogue": "unigen_tpu_torch/csrc/int8.cu"}
    kernels = []
    for name in replaces:
        # launches: the sum over the main paths driven in this run (warm runs)
        by_path = {path: c.get(name, 0) for path, c in path_counts.items()}
        row = {"name": name, "route": "cuda", "source": sources[name],
               "replaces": replaces[name],
               "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path}
        row.update(results.get(name) or {})
        kernels.append(row)
    if "flagship" in results:
        print(f"flagship: {results['flagship']['images_per_s']:.4f} images/s "
              f"({results['flagship']['seconds']:.3f} s for {len(PROMPTS)} images) on {card}")
    if "understand" in results:
        u = results["understand"]
        print(f"understand: W4A8 {u['w4a8']['tokens_per_s']:.2f} tokens/s "
              f"({u['w4a8']['seconds']:.3f} s), bf16 backbone {u['bf16']['tokens_per_s']:.2f} "
              f"tokens/s ({u['bf16']['seconds']:.3f} s), batch {len(QUESTIONS)} x "
              f"{NEW_TOKENS} tokens, on {card}")
    if "flagship_int8" in results:
        f8 = results["flagship_int8"]
        print(f"flagship_int8: {f8['images_per_s']:.4f} images/s ({f8['seconds']:.3f} s) on {card}")
    if "understand_int8" in results:
        u8 = results["understand_int8"]
        print(f"understand_int8 (int8+kv): {u8['tokens_per_s']:.2f} tokens/s "
              f"({u8['seconds']:.3f} s) on {card}")
    if "flagship_ar" in results:
        fa = results["flagship_ar"]
        print(f"flagship_ar: {fa['images_per_s']:.4f} images/s ({fa['seconds']:.3f} s for "
              f"{len(PROMPTS)} images) on {card}")
    if "understand_discrete" in results:
        ud = results["understand_discrete"]
        print(f"understand_discrete: {ud['tokens_per_s']:.2f} tokens/s ({ud['seconds']:.3f} s, "
              f"batch {len(QUESTIONS)} x {NEW_TOKENS} tokens) on {card}")
    if "score" in results:
        sc = results["score"]
        print(f"score: {sc['requests_per_s']:.3f} requests/s ({sc['seconds']:.3f} s for "
              f"{len(QUESTIONS)} requests) on {card}")
    if "geneval" in results:
        ge = results["geneval"]
        print(f"geneval: {ge['images_per_s']:.4f} images/s with the PNG writes "
              f"({ge['seconds']:.3f} s for 2 prompts x 4 samples) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
