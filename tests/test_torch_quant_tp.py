"""The pieces of a quantized layer under tensor parallelism, on the CPU.

A row-parallel layer's rank quantizes its slice of each row with the row's
absmax over all slices (``quantize_activations(x, amax)``): the int8 values
and scales are JAX's quantization of the whole row. A row-parallel W4A8
layer ends in the W8A8 epilogue on kernel 4's summed fp32 partials with no
weight scale: kernel 4's own epilogue. A W4A8 node cut inside a group is
repacked at a smaller group (``int4.regroup``, the same int4 values) and a
column slice re-padded (``int4.column_slice``), both against JAX's packing
of the same float weights. The products of one rank (``dense_int8_row``,
``dense_int4_row`` with identity reductions) are the whole layer's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import int4 as J4
from unigen_tpu.ops.quantization import quantize_activations as j_quantize_activations
from unigen_tpu_torch.ops import int4 as T4
from unigen_tpu_torch.ops import quantization as TQZ


def _x(shape, seed, dtype=torch.float32):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape) * 3,
                           dtype=torch.float32).to(dtype)


def _w4(k, n, group, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * k ** -0.5
    bias = rng.normal(size=(n,)).astype(np.float32) * 0.1
    return w, bias, T4.quantize_dense_int4({"kernel": torch.from_numpy(w),
                                            "bias": torch.from_numpy(bias)}, group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_quantized_with_the_global_absmax_is_jaxs_whole_row(dtype):
    x = _x((5, 96), 1, dtype)
    x[2] = 0.0                                    # an all-zero row: the 1e-8 floor
    want_q, want_s = (np.asarray(a) for a in j_quantize_activations(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                              else jnp.float32)))
    halves = x.split(48, dim=-1)
    amax = torch.maximum(*(TQZ.row_absmax_plain(h) for h in halves))
    assert torch.equal(amax, TQZ.row_absmax_plain(x))
    for i, h in enumerate(halves):
        q, s = TQZ.quantize_activations(h, amax)
        np.testing.assert_array_equal(q.numpy(), want_q[:, 48 * i:48 * (i + 1)])
        np.testing.assert_array_equal(s.numpy(), want_s)
    q, s = TQZ.quantize_activations(x)
    assert torch.equal(TQZ.quantize_activations(x, TQZ.row_absmax(x))[0], q)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fp32_epilogue_is_kernel4s_epilogue(out_dtype):
    """``w8a8_epilogue`` on kernel 4's fp32 product, no weight scale, equals
    ``dense_int4_prequant`` (product and epilogue together) bit for bit."""
    _, _, p = _w4(128, 100, 32)
    x8, act = TQZ.quantize_activations(_x((7, 128), 2))
    part = T4.w4a8_matmul(x8, p["kernel_int4"], p["scale4"], group=32)
    got = TQZ.w8a8_epilogue(part, act.reshape(-1), None, p["bias"], out_dtype)
    assert torch.equal(got, T4.dense_int4_prequant(p, x8, act, out_dtype))


@pytest.mark.parametrize("group,new_group", [(64, 32), (256, 128), (32, 2)])
def test_regroup_keeps_values_and_round_trips(group, new_group):
    w, bias, p = _w4(512, 60, group)
    q = T4.regroup(p, group, new_group)
    assert q["scale4"].shape == (512 // new_group, 512)
    assert torch.equal(T4.int4_values(q["kernel_int4"], new_group),
                       T4.int4_values(p["kernel_int4"], group))
    back = T4.regroup(q, new_group, group)
    for key in ("kernel_int4", "scale4", "bias"):
        assert torch.equal(back[key], p[key]), key
    x8, _ = TQZ.quantize_activations(_x((3, 512), 3))
    a = T4.w4a8_matmul(x8, p["kernel_int4"], p["scale4"], group=group)
    b = T4.w4a8_matmul(x8, q["kernel_int4"], q["scale4"], group=new_group)
    assert ((a - b).abs().max() / a.abs().max()).item() < 1e-6


@pytest.mark.parametrize("a,b", [(0, 30), (30, 60)])
def test_column_slice_is_jaxs_packing_of_the_columns(a, b):
    w, bias, p = _w4(128, 60, 64)
    got = T4.column_slice(p, a, b)
    want = J4.quantize_dense_int4({"kernel": jnp.asarray(w[:, a:b]),
                                   "bias": jnp.asarray(bias[a:b])}, 64)
    for key in ("kernel_int4", "scale4", "bias"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("kind", ["w8a8", "w4a8"])
def test_one_rank_row_product_is_the_whole_layer(kind):
    """With identity reductions (one rank) the row-parallel products are the
    layers' own: W8A8 bit for bit, W4A8 too (one rank folds every group)."""
    x = _x((2, 3, 128), 4)
    ident = (lambda t: t)
    if kind == "w8a8":
        w = torch.from_numpy(np.random.default_rng(5).normal(size=(128, 40)).astype(np.float32))
        p = TQZ.quantize_dense({"kernel": w, "bias": torch.ones(40)})
        assert torch.equal(TQZ.dense_int8_row(p, x, ident, ident), TQZ.dense_int8(p, x))
    else:
        _, _, p = _w4(128, 40, 32)
        assert torch.equal(T4.dense_int4_row(p, x, ident, ident), T4.dense_int4(p, x))
