"""The fused W4A8 layer's plain versions against the JAX package, on the CPU,
and the wrappers' routing and argument checks.

* ``quantize_activations_plain`` is bit-identical to JAX's
  ``quantize_activations`` on an all-zero row, exact .5 ties, values at
  +-127 times the scale, K 1536 and an odd K, fp32 and bf16 input: it is the
  reference the CUDA kernel is held to bit for bit on the card;
* ``dense_int4_prequant_plain`` agrees with JAX's ``dense_int4_prequant``
  (Pallas in interpret mode) with fp32 and bf16 bias and output and an n that
  is no multiple of 512. fp32 output: within 1e-6 of the largest magnitude,
  as ``w4a8_matmul_plain`` is (XLA:CPU rounds the fp32 scale fold otherwise,
  tests/test_torch_int4.py); bf16 output: that difference can carry a value
  across a bf16 rounding boundary, so one bf16 ulp (2^-8 relative) more;
* packing the transposed view of a port weight gives contiguous leaves;
* a CPU tensor takes the plain version and counts no launch;
* the CUDA path's argument checks raise on a wrong type, shape or device
  before anything is built (checked with tensors on the ``meta`` device,
  which is not the CPU and needs no card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import int4 as J4
from unigen_tpu.ops.quantization import quantize_activations as j_quantize
from unigen_tpu_torch.ops import int4 as T4
from unigen_tpu_torch.ops.quantization import quantize_activations, quantize_activations_plain


def _rows(name):
    rng = np.random.default_rng(30)
    if name == "zero_row_and_ties":
        # scale 1 (max 127) and scale 2 (max 254): every other value an exact .5 tie
        return np.array([[0.0] * 8,
                         [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0],
                         [254.0, 5.0, 7.0, -5.0, -1.0, 1.0, 3.0, 9.0]], np.float32)
    if name == "at_127_scale":
        s = rng.random(4).astype(np.float32) * 0.1 + 1e-3
        x = np.outer(s, np.array([127.0, -127.0, 126.5, -63.5, 0.0, 1.0], np.float32))
        return x.astype(np.float32)
    if name == "k1536":
        return rng.normal(size=(4, 1536)).astype(np.float32) * 3
    if name == "odd_k":
        return rng.normal(size=(3, 5, 999)).astype(np.float32) * 3
    if name == "tiny_values":                      # below the 1e-8 scale floor
        return (rng.normal(size=(2, 64)) * 1e-9).astype(np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["zero_row_and_ties", "at_127_scale", "k1536", "odd_k",
                                  "tiny_values"])
def test_quantize_plain_bit_identical_to_jax(name, dtype):
    x = torch.from_numpy(_rows(name)).to(getattr(torch, dtype))
    jx, js = j_quantize(jnp.asarray(x.float().numpy(), dtype=getattr(jnp, dtype)))
    tx, ts = quantize_activations_plain(x)
    assert tx.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (*x.shape[:-1], 1)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _layer(t, k, n, group, bias_dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * k ** -0.5
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32) * 0.1).to(bias_dtype)
    x = rng.normal(size=(t, k)).astype(np.float32)
    return w, bias, x


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,k,n,group", [(5, 256, 700, 64), (3, 128, 96, 32)])
def test_dense_plain_matches_jax(t, k, n, group, bias_dtype, out_dtype):
    w, bias, x = _layer(t, k, n, group, getattr(torch, bias_dtype), 31)
    jp = J4.quantize_dense_int4({"kernel": jnp.asarray(w),
                                 "bias": jnp.asarray(bias.float().numpy(),
                                                     dtype=getattr(jnp, bias_dtype))}, group)
    jx8, jscale = j_quantize(jnp.asarray(x))
    want = np.asarray(J4.dense_int4_prequant(jp, jx8, jscale, getattr(jnp, out_dtype)),
                      dtype=np.float32)
    tp = T4.quantize_dense_int4({"kernel": torch.from_numpy(w), "bias": bias}, group)
    assert tp["bias"].dtype == bias.dtype            # the bias is kept in its stored type
    x8, scale = quantize_activations_plain(torch.from_numpy(x))
    got = T4.dense_int4_prequant_plain(tp, x8, scale, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (t, n)
    rtol = 2 ** -8 if out_dtype == "bfloat16" else 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 * np.abs(want).max(),
                               rtol=rtol)


@pytest.mark.parametrize("n", [512, 1536, 700])
def test_packing_a_transposed_weight_is_contiguous(n):
    """The port stores weights [N, K] and packs their transposed view; the
    packed leaves must come out contiguous (the kernel wrapper would copy them
    at every launch otherwise) and hold the same bytes as JAX's packing."""
    w = np.random.default_rng(33).normal(size=(n, 128)).astype(np.float32)
    d = T4.quantize_dense_int4({"kernel": torch.from_numpy(w).t()}, 64)
    assert d[T4.KEY].is_contiguous() and d["scale4"].is_contiguous()
    jp, js = J4.pack_int4(jnp.asarray(w.T), 64)
    np.testing.assert_array_equal(d[T4.KEY].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(d["scale4"].numpy(), np.asarray(js))


def test_cpu_tensors_take_the_plain_versions():
    w, bias, x = _layer(6, 128, 96, 32, torch.bfloat16, 32)
    p = T4.quantize_dense_int4({"kernel": torch.from_numpy(w), "bias": bias}, 32)
    xt = torch.from_numpy(x).reshape(2, 3, 128).to(torch.bfloat16)
    q0, m0 = quantize_activations.launches, T4.w4a8_matmul.launches
    x8, scale = quantize_activations(xt)
    px8, pscale = quantize_activations_plain(xt)
    assert torch.equal(x8, px8) and torch.equal(scale, pscale)
    y = T4.dense_int4_prequant(p, x8, scale, torch.bfloat16)
    assert y.shape == (2, 3, 96)
    assert torch.equal(y, T4.dense_int4_prequant_plain(p, x8, scale, torch.bfloat16))
    assert torch.equal(T4.dense_int4(p, xt), y)
    assert (quantize_activations.launches, T4.w4a8_matmul.launches) == (q0, m0)


def _meta_case(**over):
    """A dense layer's arguments on the meta device (T 4, K 64, N 512, n 96,
    group 32), with some replaced."""
    m = torch.device("meta")
    args = dict(x8=torch.empty((4, 64), dtype=torch.int8, device=m),
                packed=torch.empty((32, 512), dtype=torch.int8, device=m),
                scale4=torch.empty((2, 512), dtype=torch.float32, device=m),
                act=torch.empty((4, 1), dtype=torch.float32, device=m),
                bias=torch.empty((96,), dtype=torch.bfloat16, device=m),
                out_dtype=torch.bfloat16)
    args.update(over)
    return args


@pytest.mark.parametrize("name,over,exc", [
    ("x not int8", dict(x8=torch.empty((4, 64), dtype=torch.float32, device="meta")), TypeError),
    ("packed rows", dict(packed=torch.empty((31, 512), dtype=torch.int8, device="meta")),
     ValueError),
    ("scale4 columns", dict(scale4=torch.empty((2, 500), dtype=torch.float32, device="meta")),
     ValueError),
    ("K not a multiple of the group", dict(scale4=torch.empty((3, 512), dtype=torch.float32,
                                                              device="meta")), ValueError),
    ("act_scale rows", dict(act=torch.empty((5, 1), dtype=torch.float32, device="meta")),
     ValueError),
    ("act_scale type", dict(act=torch.empty((4, 1), dtype=torch.float64, device="meta")),
     TypeError),
    ("bias wider than N", dict(bias=torch.empty((513,), dtype=torch.float32, device="meta")),
     ValueError),
    ("bias type", dict(bias=torch.empty((96,), dtype=torch.float16, device="meta")), TypeError),
    ("out type", dict(out_dtype=torch.float16), TypeError),
    ("bias device", dict(bias=torch.empty((96,), dtype=torch.float32)), ValueError),
    ("packed device", dict(packed=torch.empty((32, 512), dtype=torch.int8)), ValueError),
])
def test_dense_argument_checks_raise(name, over, exc):
    a = _meta_case(**over)
    p = {T4.KEY: a["packed"], "scale4": a["scale4"], "bias": a["bias"]}
    with pytest.raises(exc):
        T4.dense_int4_prequant(p, a["x8"], a["act"], a["out_dtype"])


@pytest.mark.parametrize("x,exc", [
    (torch.empty((4, 64), dtype=torch.float16, device="meta"), TypeError),
    (torch.empty((4, 0), dtype=torch.float32, device="meta"), ValueError),
    (torch.empty((0, 64), dtype=torch.bfloat16, device="meta"), ValueError),
])
def test_quantize_argument_checks_raise(x, exc):
    with pytest.raises(exc):
        quantize_activations(x)
