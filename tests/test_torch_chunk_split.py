"""The split-over-keys route of the port's chunk attention, on the CPU.

``chunk_attention_split_plain`` is the arithmetic of the CUDA kernel's split
route (per key range the max, the sum and the unnormalised output; then the
weighted combine) in plain torch. It is held here against the unsplit plain
version and against the JAX package's Pallas kernel in interpret mode, fp32,
inputs from numpy seeds; the kernel itself is held against the plain version
on the card (test_torch_kernels.py, chip_smoke.py). Tolerances: 2e-5 as in
tests/test_chunk_attention.py (fp32, only the order of the sums differs);
2^-7 of the output scale in bf16 (P is rounded to bf16 relative to another
maximum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops.chunk_attention import chunk_attention as j_chunk
from unigen_tpu_torch.ops import chunk_attention as CA
from unigen_tpu_torch.ops.chunk_attention import (chunk_attention_plain,
                                                  chunk_attention_split_plain, keys_per_split,
                                                  kv_splits)


def _case(b, lq, s, h, kvh, dh, seed, keep=0.7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, dh)).astype(np.float32)
    kvalid = rng.random((b, s)) < keep
    kvalid[:, -1] = True                                  # the newest slot is always visible
    return q, k, v, kvalid


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("nsplit", [1, 2, 7, 15])
def test_split_matches_unsplit_ragged(nsplit):
    """S = 43 in ranges of 43, 22, 7 and 3 keys: the last range of the 7- and
    15-way splits holds one key."""
    q, k, v, kvalid = _t(*_case(2, 1, 43, 6, 2, 16, 0))
    per = keys_per_split(43, nsplit, granule=1)
    assert per == {1: 43, 2: 22, 7: 7, 15: 3}[nsplit]
    got = chunk_attention_split_plain(q, k, v, kvalid, nsplit, granule=1)
    ref = chunk_attention_plain(q, k, v, kvalid)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nsplit,lq", [(2, 1), (4, 2), (4, 1)])
def test_split_default_granule(nsplit, lq):
    """Ranges in multiples of 64 keys, as the kernel cuts them: S = 200 gives
    128 + 72 and 64 + 64 + 64 + 8."""
    q, k, v, kvalid = _t(*_case(2, lq, 200, 4, 2, 8, 1))
    assert keys_per_split(200, nsplit) == {2: 128, 4: 64}[nsplit]
    got = chunk_attention_split_plain(q, k, v, kvalid, nsplit)
    ref = chunk_attention_plain(q, k, v, kvalid)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nsplit,dead", [(2, 0), (7, 3), (7, 6), (15, 14)])
def test_split_with_a_fully_masked_range(nsplit, dead):
    """A range with no visible key has m = -1e30 and weight exp(-1e30 - M) = 0
    beside any range with a visible key (the last range is one key wide)."""
    q, k, v, kvalid = _case(2, 1, 43, 6, 2, 16, 2)
    per = keys_per_split(43, nsplit, granule=1)
    kvalid[:, dead * per:(dead + 1) * per] = False
    kvalid[:, 0 if dead else per] = True                    # some other range stays visible
    q, k, v, kvalid = _t(q, k, v, kvalid)
    got = chunk_attention_split_plain(q, k, v, kvalid, nsplit, granule=1)
    ref = chunk_attention_plain(q, k, v, kvalid)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    # the masked range's keys and values are inert
    k2, v2 = k.clone(), v.clone()
    k2[:, dead * per:(dead + 1) * per] = 50.0
    v2[:, dead * per:(dead + 1) * per] = -50.0
    moved = chunk_attention_split_plain(q, k2, v2, kvalid, nsplit, granule=1)
    np.testing.assert_allclose(moved.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("nsplit", [1, 2, 7, 15])
def test_split_with_a_fully_masked_row(nsplit):
    """A batch row with no visible key gets equal weights over all S keys (the
    mean of V), finite, as the unsplit softmax over equal logits gives."""
    q, k, v, kvalid = _case(2, 1, 43, 6, 2, 16, 3)
    kvalid[0] = False
    q, k, v, kvalid = _t(q, k, v, kvalid)
    got = chunk_attention_split_plain(q, k, v, kvalid, nsplit, granule=1)
    ref = chunk_attention_plain(q, k, v, kvalid)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    mean_v = v[0].mean(0).repeat_interleave(3, dim=0)         # [H, Dh]: kv head h // 3
    np.testing.assert_allclose(got[0, 0].numpy(), mean_v.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nsplit", [2, 7])
@pytest.mark.parametrize("shape", [(2, 1, 23, 4, 2, 16), (3, 2, 40, 6, 1, 8)])
def test_split_matches_jax_kernel(shape, nsplit):
    """Against the Pallas kernel as tests/test_chunk_attention.py runs it on
    the CPU (interpret mode), at that test's tolerance."""
    b, lq, s, h, kvh, dh = shape
    q, k, v, kvalid = _case(b, lq, s, h, kvh, dh, 4)
    got = chunk_attention_split_plain(*_t(q, k, v, kvalid), nsplit, granule=1).numpy()
    ref = np.asarray(j_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvalid)))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nsplit", [2, 8])
def test_split_bf16(nsplit):
    q, k, v, kvalid = _t(*_case(2, 1, 300, 6, 2, 32, 5))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = chunk_attention_split_plain(q, k, v, kvalid, nsplit).float()
    ref = chunk_attention_plain(q, k, v, kvalid).float()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2 ** -7 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("s,nsplit,granule,per,held", [
    (915, 8, 64, 128, 8), (915, 15, 64, 64, 15), (915, 7, 64, 192, 5), (98, 2, 64, 64, 2),
    (1, 8, 64, 64, 1), (43, 7, 1, 7, 7), (64, 1, 64, 64, 1)])
def test_keys_per_split(s, nsplit, granule, per, held):
    """Ranges are multiples of the granule, and no more than nsplit hold a key."""
    assert keys_per_split(s, nsplit, granule) == per
    assert -(-s // per) == held <= nsplit


@pytest.mark.parametrize("shape,expect", [
    ((8, 1, 915, 12, 2), 8),        # the understand decode step: 8 x 2 x 8 = 128 blocks
    ((8, 258, 406, 12, 2), 1),      # the t2i step: 1548 rows, unsplit
    ((8, 3, 915, 12, 2), 1),        # 18 rows > 16
    ((8, 2, 915, 12, 2), 8),        # 12 rows
    ((8, 1, 63, 12, 2), 1),         # fewer than 64 keys
    ((8, 1, 64, 12, 2), 1),
    ((3, 1, 98, 12, 2), 2),         # cannot reach the target: 64-key ranges
    ((1, 1, 4096, 12, 2), 64),
    ((64, 1, 915, 12, 2), 1),       # 128 blocks without a split
    ((16, 1, 915, 12, 2), 4),
])
def test_kv_splits_rule(shape, expect):
    b, lq, s, h, kvh = shape
    n = kv_splits(b, lq, s, h, kvh)
    assert n == expect
    if n > 1:
        per = keys_per_split(s, n)
        assert lq * (h // kvh) <= CA.SPLIT_ROWS
        assert per >= CA.SPLIT_GRANULE and per % CA.SPLIT_GRANULE == 0
        assert -(-s // per) == n                 # every range holds a key
        # the target number of blocks, unless 64-key ranges cannot give it
        assert b * kvh * n >= 128 or per == CA.SPLIT_GRANULE


def test_decode_shape_fills_the_card():
    assert 8 * 2 * kv_splits(8, 1, 915, 12, 2) >= 128


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, kvalid = _t(*_case(2, 1, 130, 4, 2, 8, 6))
    before = CA.chunk_attention.launches
    got = CA.chunk_attention(q, k, v, kvalid)
    assert CA.chunk_attention.launches == before
    assert torch.equal(got, chunk_attention_plain(q, k, v, kvalid))
