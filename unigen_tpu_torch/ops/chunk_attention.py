"""Attention of the MaskGIT chunk step against the prefix KV cache.

Port of ``unigen_tpu/ops/chunk_attention.py::chunk_attention``. Every query
of batch row b sees exactly the keys with ``kvalid[b]`` set, so the mask is a
[B, S] vector, not an [Lq, S] matrix. On a CUDA tensor the wrapper launches
the hand-written kernel ``csrc/attention.cu`` (``chunk_attention_launch``);
on a CPU tensor it runs ``chunk_attention_plain``, which repeats the TPU
kernel's arithmetic and is the kernel's reference on the card.

The kernel has two routes, and ``kv_splits``, a pure function of the shapes,
picks one. With many rows (the t2i step) a block walks all S keys of its 64
rows. With at most 16 rows (``Lq * H / KVH``: the decode step of
``understand``) the keys are split over blocks, each block writes an
unnormalised fp32 partial to scratch, and a second kernel, queued by the same
call, combines them; ``chunk_attention_split_plain`` is that arithmetic in
plain torch. Both float32 and bfloat16 split, by the same rule.
"""
from __future__ import annotations

import torch

from . import _cuda

SPLIT_ROWS = 16        # the split kernel holds Lq * H / KVH rows in one m16 tile
SPLIT_GRANULE = 64     # a split's keys come in multiples of this (csrc: kSplitGranule)
# The split aims at this many blocks: about one per SM of the H100's 132. At
# the decode step (B 8, KVH 2, S 915) 128 gives 8 splits of 128 keys; 132 or
# more would give 15 splits of 64.
_SPLIT_TARGET_BLOCKS = 128


def _logits(q: torch.Tensor, k: torch.Tensor, kvalid: torch.Tensor) -> torch.Tensor:
    """fp32 logits [B, KVH, G, Lq, S] plus the 0 / -1e30 bias."""
    b, lq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, lq, kvh, h // kvh, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.to(q.dtype).float()) * dh ** -0.5
    bias = torch.where(kvalid, 0.0, -1e30).to(torch.float32)
    return logits + bias[:, None, None, None, :]


def chunk_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kvalid: torch.Tensor) -> torch.Tensor:
    """fp32 logits plus a 0 / -1e30 bias, max-shifted fp32 softmax, P cast
    to q.dtype, P.V accumulated in fp32. q: [B, Lq, H, Dh]; k, v:
    [B, S, KVH, Dh]; kvalid: [B, S] bool. Returns [B, Lq, H, Dh] in q.dtype."""
    b, lq, h, dh = q.shape
    logits = _logits(q, k, kvalid)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), v.to(q.dtype).float())
    return out.reshape(b, lq, h, dh).to(q.dtype)


def keys_per_split(s: int, nsplit: int, granule: int = SPLIT_GRANULE) -> int:
    """Keys of one split when ``s`` keys go to at most ``nsplit`` splits in
    multiples of ``granule``; ``ceil(s / keys)`` splits then hold a key."""
    return granule * -(-s // (granule * nsplit))


def chunk_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                kvalid: torch.Tensor, nsplit: int,
                                granule: int = SPLIT_GRANULE) -> torch.Tensor:
    """The split route's arithmetic: per key range i the max m_i, the sum
    l_i of exp(logit - m_i) and the unnormalised o_i = P_i . V_i (P_i cast to
    q.dtype); then ``sum_i w_i o_i / sum_i w_i l_i`` with
    ``w_i = exp(m_i - max_i m_i)``, rounded once. The finite -1e30 bias keeps
    every m_i finite: a fully masked range gets weight 0 beside a visible one,
    and a row with no visible key gets equal weights over all S keys."""
    b, lq, h, dh = q.shape
    s = k.shape[1]
    logits = _logits(q, k, kvalid)
    vf = v.to(q.dtype).float()
    per = keys_per_split(s, nsplit, granule)
    ms, ls, os_ = [], [], []
    for k0 in range(0, s, per):
        x = logits[..., k0:k0 + per]
        m = x.amax(dim=-1, keepdim=True)
        p = torch.exp(x - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        os_.append(torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vf[:, k0:k0 + per]))
    m_all = torch.stack(ms)                                    # [n, B, KVH, G, Lq, 1]
    w = torch.exp(m_all - m_all.amax(dim=0, keepdim=True))
    out = (w * torch.stack(os_)).sum(0) / (w * torch.stack(ls)).sum(0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, dh).to(q.dtype)


def kv_splits(b: int, lq: int, s: int, h: int, kvh: int) -> int:
    """How many key ranges ``chunk_attention`` splits S into at these shapes;
    1 is the unsplit route. The split needs ``lq * h / kvh <= SPLIT_ROWS``
    and serves a grid that ``b * kvh`` alone leaves short of the target; it
    takes the longest ranges (multiples of ``SPLIT_GRANULE`` keys, so at
    least that many) that still give ``_SPLIT_TARGET_BLOCKS`` blocks, or the
    shortest where none does."""
    if lq * (h // kvh) > SPLIT_ROWS or b * kvh >= _SPLIT_TARGET_BLOCKS:
        return 1
    for per in range(s // SPLIT_GRANULE * SPLIT_GRANULE, 0, -SPLIT_GRANULE):
        n = -(-s // per)
        if b * kvh * n >= _SPLIT_TARGET_BLOCKS or per == SPLIT_GRANULE:
            return n
    return 1


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvalid: torch.Tensor,
            nsplit: int) -> torch.Tensor:
    """Launch ``csrc/attention.cu`` on checked, contiguous CUDA inputs of one
    type: unsplit for ``nsplit <= 1``, else split over at most ``nsplit`` key
    ranges (one call queues the partials' kernel and the combine)."""
    b, lq, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    scratch = None
    if nsplit > 1:
        if lq * (h // kvh) > SPLIT_ROWS:
            raise ValueError(f"the split route holds {SPLIT_ROWS} rows, got {lq * (h // kvh)}")
        scratch = torch.empty((b * kvh * nsplit * SPLIT_ROWS * (dh + 2),), dtype=torch.float32,
                              device=q.device)
    rc = _cuda.library("attention").chunk_attention_launch(
        _cuda.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kvalid.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, lq, s, h, kvh, dh, nsplit, dh ** -0.5, _cuda.stream_of(q))
    _cuda.check(rc, "chunk_attention_launch")
    return out


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kvalid: torch.Tensor) -> torch.Tensor:
    """q: [B, Lq, H, Dh]; k, v: [B, S, KVH, Dh]; kvalid: [B, S] bool.
    Returns [B, Lq, H, Dh] in q.dtype."""
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k, v, kvalid)
    b, lq, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kvh, dh) or v.shape != k.shape or kvalid.shape != (b, s):
        raise ValueError(f"chunk_attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} kvalid {tuple(kvalid.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if kvalid.dtype != torch.bool:
        raise TypeError(f"kvalid must be bool, got {kvalid.dtype}")
    for t in (k, v, kvalid):
        if t.device != q.device:
            raise ValueError(f"chunk_attention inputs on {q.device} and {t.device}")
    out = _launch(q.contiguous(), k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous(),
                  kvalid.contiguous(), kv_splits(b, lq, s, h, kvh))
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0
