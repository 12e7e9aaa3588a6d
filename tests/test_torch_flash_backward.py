"""Kernel 2's backward, as its plain version spells it, against JAX on the CPU.

On the card the backward kernel (``csrc/attention.cu``) recomputes the
attention weights from the row log-sum-exp that the forward writes, and sums
a pad row's uniform weights apart: that weight (1/L) cannot come from the
pad row's log-sum-exp, which is finfo(float32).min. Its plain version,
``flash_attention_backward_plain``, writes those formulas out in PyTorch, and
``flash_attention_lse_plain`` gives the log-sum-exp. Here both are held, in
fp32 within 1e-5, to ``jax.vjp`` through JAX's ``flash_attention`` (its
Pallas kernel in interpret mode, its ``custom_vjp``), to
``jax.nn.logsumexp`` of JAX's masked logits, and to the autograd of the
port's ``flash_attention_plain``: the five masks of the flash gradient test
in tests/test_torch_training.py at G = 1 and 2, a mask whose pad rows see pad
keys and keys of another segment, and a batch row that is all pads. The
kernel itself is held to these gradients on the card
(tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import masks as JM
from unigen_tpu.ops.flash_attention import flash_attention as j_flash
from unigen_tpu.ops.flash_attention import pack_meta as j_pack
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops.flash_attention import (flash_attention_backward,
                                                  flash_attention_backward_plain,
                                                  flash_attention_lse_plain,
                                                  flash_attention_plain)

B, L, DH = 2, 16, 8
CASES = ["causal", "t2i", "mmu", "gqa", "segments", "pad_foreign", "all_pad_row"]


def _meta(case):
    """(pad, bidir_q, bidir_k, seg) [B, L] of one case."""
    z = np.zeros((B, L), bool)
    pos = np.arange(L)[None].repeat(B, 0)
    seg = (pos >= L // 2).astype(np.int32)
    if case == "causal":
        return z, z, z, None
    if case == "t2i":                       # left pads, a bidirectional image block
        pad = pos < np.array([[0], [3]])
        return pad, (pos >= 6) & (pos < 12) & ~pad, z, None
    if case == "mmu":                       # a visible prefix, right pads
        pad = pos >= np.array([[L], [L - 4]])
        return pad, z, (pos <= 5) & ~pad, None
    if case == "gqa":
        return pos < np.array([[2], [0]]), z, z, None
    if case == "segments":                  # two packed segments
        return z, (pos >= 2) & (pos < 6), z, seg
    if case == "pad_foreign":               # each segment ends in pads
        pad = ((pos >= 6) & (pos < 8)) | (pos >= np.array([[L - 3], [L - 1]]))
        return pad, (pos == 2) & ~pad, (pos == 9) & ~pad, seg
    pad = pos >= np.array([[L - 2], [0]])   # all_pad_row: batch row 1 is all pads
    return pad, z, (pos == 1) & ~pad, None


def _inputs(case, h, kvh):
    rng = np.random.default_rng(CASES.index(case) * 10 + h)
    q, k, v = (rng.normal(size=(B, L, n, DH)).astype(np.float32) for n in (h, kvh, kvh))
    g = rng.normal(size=(B, L, h, DH)).astype(np.float32)
    pad, bq, bk, seg = _meta(case)
    jmeta = JM.AttnMeta(pad=jnp.asarray(pad), bidir_q=jnp.asarray(bq), bidir_k=jnp.asarray(bk),
                        seg=None if seg is None else jnp.asarray(seg))
    tbits = TM.pack_meta(TM.AttnMeta(pad=torch.as_tensor(pad), bidir_q=torch.as_tensor(bq),
                                     bidir_k=torch.as_tensor(bk),
                                     seg=None if seg is None else torch.as_tensor(seg)))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(j_pack(jmeta)))
    return q, k, v, g, jmeta, tbits


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("h,kvh", [(2, 2), (4, 2)])
def test_flash_backward_plain_matches_jax(case, h, kvh):
    """lse against ``jax.nn.logsumexp`` of JAX's masked logits (a pad row's
    is finfo.min in both); dq, dk, dv against ``jax.vjp`` through JAX's
    kernel and against the port's plain autograd."""
    q, k, v, g, jmeta, tbits = _inputs(case, h, kvh)
    jbits = j_pack(jmeta)
    j_out, vjp = jax.vjp(lambda *a: j_flash(*a, jbits, None, 8, True), *map(jnp.asarray, (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    logits = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, L, kvh, h // kvh, DH), k) * DH ** -0.5
    logits = jnp.where(jmeta.visibility()[:, :, None], logits, jnp.finfo(jnp.float32).min)
    j_lse = jax.nn.logsumexp(logits, axis=-1).reshape(B, h, L)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_lse_plain(tq, tk, tv, tbits)
    assert lse.dtype == torch.float32 and lse.shape == (B, h, L)
    _close(lse.numpy(), j_lse)
    _close(out.numpy(), j_out)
    pad_rows = TM.unpack_meta(tbits).pad[:, None].expand(B, h, L)
    assert (lse[pad_rows] == torch.finfo(torch.float32).min).all()
    got = flash_attention_backward_plain(tq, tk, tv, tbits, lse, tg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, tbits), leaves, tg)
    for a, j, w in zip(got, j_grads, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        _close(a.numpy(), j)
        _close(a.numpy(), w.numpy())


def test_flash_backward_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the backward's wrapper is its plain version and counts
    no launch; dk and dv come back in k's and v's dtypes."""
    q, k, v, g, _, tbits = _inputs("pad_foreign", 4, 2)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    lse = flash_attention_lse_plain(tq, tk, tv, tbits)[1]
    before = flash_attention_backward.launches
    got = flash_attention_backward(tq, tk, tv, tbits, lse, tg)
    assert flash_attention_backward.launches == before
    for a, w in zip(got, flash_attention_backward_plain(tq, tk, tv, tbits, lse, tg)):
        assert torch.equal(a, w)
    dk = flash_attention_backward(tq, tk.double(), tv.double(), tbits, lse, tg)[1]
    assert dk.dtype == torch.float64
