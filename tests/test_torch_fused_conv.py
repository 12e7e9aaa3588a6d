"""The fused conv's plain versions against the JAX package, on the CPU, and
the CUDA wrappers' argument checks.

* ``gn_affine_plain`` agrees with JAX's ``_gn_affine`` within 1e-5 of the
  largest |A|, |B| on inputs with a large mean against their spread, at
  C < 32 (one channel a group) and with bf16 x, scale and bias: it is the
  reference the statistics kernel is held to on the card;
* ``conv3x3_gn_swish_plain`` agrees with JAX's ``conv3x3_gn_swish`` (Pallas
  in interpret mode) at the JAX fused-conv test's tolerance for each kind of
  decoder call: C = Cout with GroupNorm, C > Cout with GroupNorm, the
  upsample conv without it, and a ragged H, W;
* the CUDA path's argument checks raise on a wrong type, shape or device
  before anything is built (tensors on the ``meta`` device, which is not the
  CPU and needs no card);
* ``_cuda.SIGNATURES`` names each ``extern "C"`` entry point of the CUDA
  sources with its number of arguments.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import fused_conv as JFC
from unigen_tpu_torch.ops import _cuda
from unigen_tpu_torch.ops import fused_conv as TFC


def _gn_case(name):
    """(x [B, H, W, C], scale, bias, dtype) for a statistics case."""
    rng = np.random.default_rng(40)
    shape, shift, dtype = {"large_mean": ((2, 16, 24, 64), 100.0, "float32"),
                           "large_mean_bf16": ((2, 16, 24, 64), 100.0, "bfloat16"),
                           "c16": ((2, 9, 13, 16), 0.5, "float32"),
                           "c12": ((1, 7, 11, 12), -3.0, "float32"),
                           "bf16": ((2, 8, 8, 96), 0.5, "bfloat16")}[name]
    c = shape[-1]
    x = (shift + rng.normal(size=shape)).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    return x, scale, bias, dtype


@pytest.mark.parametrize("name", ["large_mean", "large_mean_bf16", "c16", "c12", "bf16"])
def test_gn_affine_plain_matches_jax(name):
    x, scale, bias, dtype = _gn_case(name)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    ref = np.asarray(JFC._gn_affine(jp, jnp.asarray(x, jdt), 32, 1e-6))
    tp = {"scale": torch.from_numpy(scale).to(tdt), "bias": torch.from_numpy(bias).to(tdt)}
    got = TFC.gn_affine_plain(tp, torch.from_numpy(x).to(tdt), 32, 1e-6)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 2, x.shape[-1])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gn_affine_takes_the_plain_version_on_cpu_without_counting():
    x, scale, bias, _ = _gn_case("c16")
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    before = TFC.gn_affine.launches
    got = TFC.gn_affine(p, torch.from_numpy(x))
    assert torch.equal(got, TFC.gn_affine_plain(p, torch.from_numpy(x)))
    assert TFC.gn_affine.launches == before


def _conv_inputs(h, w, c, cout, gn, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32) * 2 + 0.5
    conv_p = {"kernel": (rng.normal(size=(3, 3, c, cout)) * (9 * c) ** -0.5).astype(np.float32),
              "bias": (rng.normal(size=(cout,)) * 0.1).astype(np.float32)}
    gn_p = ({"scale": (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32),
             "bias": (0.1 * rng.normal(size=(c,))).astype(np.float32)} if gn else None)
    return x, conv_p, gn_p


# each kind of decoder call at a tiny size: (H, W, C, Cout, GroupNorm)
CONV_CASES = {"c_eq_cout": (8, 8, 32, 32, True), "c_gt_cout": (8, 16, 64, 32, True),
              "upsample": (16, 16, 32, 32, False), "ragged": (7, 11, 48, 16, True),
              "ragged_upsample": (9, 13, 16, 16, False)}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_plain_matches_jax_kernel(name):
    h, w, c, cout, gn = CONV_CASES[name]
    x, conv_p, gn_p = _conv_inputs(h, w, c, cout, gn, 41)
    jt = (lambda p: None if p is None else {k: jnp.asarray(v) for k, v in p.items()})
    tt = (lambda p: None if p is None else {k: torch.from_numpy(v) for k, v in p.items()})
    ref = np.asarray(JFC.conv3x3_gn_swish(jt(conv_p), jt(gn_p), jnp.asarray(x), 16,
                                          interpret=True))
    got = TFC.conv3x3_gn_swish_plain(tt(conv_p), tt(gn_p), torch.from_numpy(x), 16)
    assert got.shape == (2, h, w, cout)
    # the JAX fused-conv test's tolerance (tests/test_fused_conv.py): fp32 sums
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def _meta_conv(**over):
    """A GN conv's arguments on the meta device (x [2, 8, 8, 64] bf16 -> 32)."""
    m = torch.device("meta")
    args = dict(x=torch.empty((2, 8, 8, 64), dtype=torch.bfloat16, device=m),
                kernel=torch.empty((3, 3, 64, 32), dtype=torch.bfloat16, device=m),
                bias=torch.empty((32,), dtype=torch.bfloat16, device=m),
                scale=torch.empty((64,), dtype=torch.bfloat16, device=m),
                shift=torch.empty((64,), dtype=torch.bfloat16, device=m), groups=32)
    args.update(over)
    return args


def _e(shape, dtype=torch.bfloat16, device="meta"):
    return torch.empty(shape, dtype=dtype, device=device)


CONV_CHECKS = [
    ("x float16", dict(x=_e((2, 8, 8, 64), torch.float16)), TypeError),
    ("x three dims", dict(x=_e((8, 8, 64))), ValueError),
    ("kernel channels", dict(kernel=_e((3, 3, 48, 32))), ValueError),
    ("kernel 1x1", dict(kernel=_e((1, 1, 64, 32))), ValueError),
    ("bias width", dict(bias=_e((31,))), ValueError),
    ("kernel device", dict(kernel=_e((3, 3, 64, 32), device="cpu")), ValueError),
    ("bias device", dict(bias=_e((32,), device="cpu")), ValueError),
    ("scale width", dict(scale=_e((63,))), ValueError),
    ("scale float16", dict(scale=_e((64,), torch.float16), shift=_e((64,), torch.float16)),
     TypeError),
    ("scale and bias types", dict(scale=_e((64,), torch.float32)), TypeError),
    ("scale device", dict(scale=_e((64,), device="cpu")), ValueError),
    ("groups not dividing C", dict(groups=24), ValueError),
    ("too many channels", dict(x=_e((1, 4, 4, 4096)), kernel=_e((3, 3, 4096, 32)),
                               scale=_e((4096,)), shift=_e((4096,)), groups=4096), ValueError),
]


@pytest.mark.parametrize("name,over,exc", CONV_CHECKS, ids=[c[0] for c in CONV_CHECKS])
def test_conv_argument_checks_raise(name, over, exc):
    a = _meta_conv(**over)
    with pytest.raises(exc):
        TFC.conv3x3_gn_swish({"kernel": a["kernel"], "bias": a["bias"]},
                             {"scale": a["scale"], "bias": a["shift"]}, a["x"], a["groups"])


GN_CHECKS = [c for c in CONV_CHECKS if c[1].keys() <= {"x", "scale", "shift", "groups"}]


@pytest.mark.parametrize("name,over,exc", GN_CHECKS, ids=[c[0] for c in GN_CHECKS])
def test_gn_affine_argument_checks_raise(name, over, exc):
    a = _meta_conv(**over)
    with pytest.raises(exc):
        TFC.gn_affine({"scale": a["scale"], "bias": a["shift"]}, a["x"], a["groups"])


def test_upsample_conv_checks_need_no_groupnorm():
    a = _meta_conv(x=_e((2, 8, 8, 64), torch.int32))
    with pytest.raises(TypeError):
        TFC.conv3x3_gn_swish({"kernel": a["kernel"], "bias": a["bias"]}, None, a["x"])


@pytest.mark.parametrize("b,hw,c", [(4, 256 * 256, 128), (4, 16 * 16, 512), (1, 19 * 37, 12),
                                    (4, 32 * 32, 256), (64, 1, 8), (1, 3, 2048)])
def test_gn_splits_rule(b, hw, c):
    """At least one pixel a range, at most three blocks an SM over the batch,
    and about 16 loads a thread unless one of those caps binds."""
    n = TFC.gn_splits(b, hw, c)
    assert 1 <= n <= hw
    assert b * n <= 3 * 132 or n == 1
    per_block = -(-hw * -(-c // 8) // n)
    assert per_block <= 256 * 16 or n in (hw, max(1, 3 * 132 // b))


def _extern_c(name):
    src = (_cuda.CSRC / f"{name}.cu").read_text()
    found = {}
    for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[fn] = len([a for a in args.split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", _cuda.SOURCES)
def test_signatures_match_the_cuda_sources(name):
    assert _extern_c(name) == {fn: len(a) for fn, a in _cuda.SIGNATURES[name].items()}
