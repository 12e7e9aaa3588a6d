"""Int8 quantization of the dense layers: W8A8 and the per-token activations.

Port of ``unigen_tpu/ops/quantization.py``, with the JAX package's scheme:

* weights: per-output-channel symmetric int8, ``w ~ w_int8 * scale[out]``,
  ``max|w| / 127`` floored at 1e-8, rounded half to even, clipped to +-127;
* activations: dynamic per-token symmetric int8 at each layer input; layers
  that share an input (q/k/v; gate/up) quantize it once;
* the product accumulates exactly in int32 and is dequantized as
  ``float(acc) * act_scale[token] * scale[out] (+ bias)``, left to right in
  fp32, then cast.

A W8A8 leaf is ``{'kernel_int8': [Npad, K] int8, 'scale': [N] fp32,
'bias'?: [N]}``: the weight is stored once, in PyTorch's [out, in] order,
which ``torch._int_mm(x, w.t())`` reads on the card without a copy, with its
rows padded with zeros to a multiple of 8 (cuBLAS's int8 product takes no
other N); ``scale`` holds the real N. JAX's leaf is the transpose of the
first N rows. ``quantize_qwen2_params``, ``quantize_siglip_params``,
``quantize_lm_head`` and ``quantize_unigen_params`` turn the port's float
parameters into such leaves, as their JAX namesakes do.

Devices. The product is ``torch._int_mm``, as the JAX package leaves it to
XLA: exact in int32 on both devices. On the card it takes only more than 16
rows and K % 8 == 0, so a product of at most 16 rows (a decode step) runs on
its rows padded with zeros to 32 and keeps the first ones (exact in
integers). The epilogue (``w8a8_epilogue``) and the per-token quantization
(``quantize_activations``) launch hand-written kernels (``csrc/int8.cu``,
``csrc/int4.cu``) on a CUDA tensor and run their plain versions on a CPU
tensor; the plain versions are also the kernels' references on the card, bit
for bit. Divisors are tensors on the input's device: on CUDA, torch divides
by a Python scalar as a multiplication by its reciprocal, which is not IEEE
division.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

KEY = "kernel_int8"
_N_MULTIPLE = 8          # cuBLAS's int8 product on the card: N % 8 == 0, K % 8 == 0
_MIN_ROWS = 17           # ... and more than 16 rows
_PAD_ROWS = 32


def _div127(device) -> torch.Tensor:
    return torch.full((), 127.0, device=device)


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row's ``max(|x|)`` over the last dimension, [..., 1] fp32."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_activations_plain(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (x_int8, act_scale [..., 1] fp32).

    fp32 math, ``max(|x|) / 127`` floored at 1e-8, round half to even (as
    ``jnp.round``), clipped to +-127: bit-identical to the JAX function.
    ``amax`` [..., 1] fp32, when given, stands for each row's ``max(|x|)``
    (a row-parallel layer's global absmax over its ranks' slices).
    """
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    act_scale = torch.clamp(amax / _div127(x.device), min=1e-8)
    x_int8 = torch.clamp(torch.round(xf / act_scale), -127, 127).to(torch.int8)
    return x_int8, act_scale


def _quantize_launch(x: torch.Tensor, amax: Optional[torch.Tensor], absmax_only: bool):
    """One launch of ``csrc/int4.cu``'s quantization kernel (counted on
    ``quantize_activations.launches``): the absmax pass, or the quantization
    with its own or a given absmax."""
    code = _cuda.dtype_code(x.dtype)
    k = x.shape[-1] if x.dim() else 0
    if k < 1 or x.numel() == 0:
        raise ValueError(f"quantize_activations takes [..., K] with K >= 1, got {tuple(x.shape)}")
    x = x.contiguous()
    rows = (*x.shape[:-1], 1)
    if amax is not None and (tuple(amax.shape) != rows or amax.dtype != torch.float32
                             or amax.device != x.device):
        raise ValueError(f"amax must be {rows} float32 on {x.device}, got {tuple(amax.shape)} "
                         f"{amax.dtype} on {amax.device}")
    if absmax_only:
        x_int8 = act_scale = None
        amax = torch.empty(rows, dtype=torch.float32, device=x.device)
    else:
        x_int8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        act_scale = torch.empty(rows, dtype=torch.float32, device=x.device)
        amax = None if amax is None else amax.contiguous()
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _cuda.library("int4").quantize_activations_launch(
        code, x.data_ptr(), ptr(x_int8), ptr(act_scale), ptr(amax), x.numel() // k, k,
        _cuda.stream_of(x))
    _cuda.check(rc, "quantize_activations_launch")
    quantize_activations.launches += 1
    return amax if absmax_only else (x_int8, act_scale)


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """``row_absmax_plain`` on a CUDA tensor: the quantization kernel's
    absmax pass (one launch, counted on ``quantize_activations.launches``)."""
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    return _quantize_launch(x, None, True)


def quantize_activations(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of x [..., K] (fp32 or bf16): (x_int8 [..., K],
    act_scale [..., 1] fp32), bit-identical to ``quantize_activations_plain``
    (``amax`` as there)."""
    if x.device.type == "cpu":
        return quantize_activations_plain(x, amax)
    return _quantize_launch(x, amax, False)


quantize_activations.launches = 0


def quantize_global(x: torch.Tensor, reduce_max: Callable[[torch.Tensor], torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-token quantization of a row-parallel layer's input slice x
    [..., K / m] with each row's absmax over all m slices: ``reduce_max``
    takes the MAX of this rank's row absmax over the model ranks. The int8
    values and scales are then exactly those of the whole row's
    quantization: two launches of the quantization kernel and the MAX."""
    return quantize_activations(x, reduce_max(row_absmax(x)))


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------

def int8_leaf(w_int8: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A W8A8 leaf from int8 weights [N, K] and their scales [N]: the rows
    padded with zeros to a multiple of 8, contiguous, whatever w_int8's strides."""
    n, k = w_int8.shape
    npad = -(-n // _N_MULTIPLE) * _N_MULTIPLE
    if npad != n:
        w_int8 = torch.cat([w_int8, w_int8.new_zeros((npad - n, k))])
    out = {KEY: w_int8.contiguous(), "scale": scale}
    if bias is not None:
        out["bias"] = bias
    return out


def quantize_dense(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{'kernel': [K, N], 'bias'?} -> {'kernel_int8': [Npad, K], 'scale': [N]
    fp32, 'bias'?}; the quantized values and scales are bit-identical to JAX's."""
    w = p["kernel"].t().float()                                        # [N, K]
    scale = torch.clamp(w.abs().amax(dim=1) / _div127(w.device), min=1e-8)
    w_int8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return int8_leaf(w_int8, scale, p.get("bias"))


def is_quantized(p) -> bool:
    return isinstance(p, dict) and KEY in p


def int8_matmul(x_int8: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [Npad, K] int8 -> [M, Npad] int32, exact (``torch._int_mm``).
    On the card a product of at most 16 rows runs on its rows padded with
    zeros to 32 and returns a view of the first M; calls there are counted on
    ``int8_matmul.launches``."""
    if x_int8.device.type == "cpu":
        return torch._int_mm(x_int8, w.t())
    m, k = x_int8.shape
    if k % _N_MULTIPLE or w.shape[0] % _N_MULTIPLE or w.shape[1] != k:
        raise ValueError(f"int8_matmul on the card takes K and Npad multiples of 8: x "
                         f"{tuple(x_int8.shape)}, w {tuple(w.shape)}")
    int8_matmul.launches += 1
    if m < _MIN_ROWS:
        return torch._int_mm(F.pad(x_int8, (0, 0, 0, _PAD_ROWS - m)), w.t())[:m]
    return torch._int_mm(x_int8, w.t())


int8_matmul.launches = 0


def w8a8_epilogue_plain(acc: torch.Tensor, act_scale: torch.Tensor,
                        scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                        out_dtype) -> torch.Tensor:
    """[M, >= n] int32 -> [M, n] in ``out_dtype``: JAX's
    ``float(acc) * act_scale * scale (+ bias.float())``, left to right, over
    the first n = len(scale) columns. An fp32 ``acc`` with ``scale`` None
    (the row-parallel W4A8 layer's summed partials, n = len(bias)) gets
    kernel 4's epilogue ``acc * act_scale + bias.float()``."""
    n = (scale if scale is not None else bias).shape[0]
    y = acc[:, :n].float() * act_scale.reshape(-1, 1)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def w8a8_epilogue(acc: torch.Tensor, act_scale: torch.Tensor, scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """``w8a8_epilogue_plain`` in one launch of ``csrc/int8.cu`` on a CUDA
    tensor (counted on ``w8a8_epilogue.launches``). acc (int32 with a
    ``scale``, fp32 without) may be a row slice of a wider product (row
    stride >= n); the bias is read in its stored type."""
    if acc.device.type == "cpu":
        return w8a8_epilogue_plain(acc, act_scale, scale, bias, out_dtype)
    acc_code = {torch.int32: 0, torch.float32: 1}.get(acc.dtype)
    if acc.dim() != 2 or acc_code is None or acc.stride(1) != 1 or (acc_code == 0) != (
            scale is not None) or (scale is None and bias is None):
        raise ValueError(f"w8a8_epilogue takes a row-major int32 [M, N] product and its scale, "
                         f"or an fp32 one and a bias, got {tuple(acc.shape)} {acc.dtype} "
                         f"strides {acc.stride()}, scale {scale is not None}")
    m, n = acc.shape[0], (scale if scale is not None else bias).shape[0]
    if ((scale is not None and scale.dim() != 1) or not 1 <= n <= acc.shape[1]
            or act_scale.numel() != m or (bias is not None and tuple(bias.shape) != (n,))):
        raise ValueError(f"w8a8_epilogue: scale {None if scale is None else tuple(scale.shape)} "
                         f"for {acc.shape[1]} columns, act_scale {tuple(act_scale.shape)} for "
                         f"{m} rows, bias {None if bias is None else tuple(bias.shape)}")
    if (scale is not None and scale.dtype != torch.float32) or act_scale.dtype != torch.float32:
        raise TypeError(f"w8a8_epilogue: scales must be float32, got "
                        f"{None if scale is None else scale.dtype}, {act_scale.dtype}")
    for a in (act_scale, scale, bias):
        if a is not None and a.device != acc.device:
            raise ValueError(f"w8a8_epilogue inputs on {acc.device} and {a.device}")
    out_code = _cuda.dtype_code(out_dtype)
    bias_code = 0 if bias is None else _cuda.dtype_code(bias.dtype)
    act_scale = act_scale.contiguous()
    scale = None if scale is None else scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    rc = _cuda.library("int8").w8a8_epilogue_launch(
        acc.data_ptr(), acc_code, act_scale.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), bias_code, out.data_ptr(), out_code,
        m, n, acc.stride(0), _cuda.stream_of(acc))
    _cuda.check(rc, "w8a8_epilogue_launch")
    w8a8_epilogue.launches += 1
    return out


w8a8_epilogue.launches = 0


def _dense_prequant(epilogue: Callable, p: Dict[str, torch.Tensor], x_int8: torch.Tensor,
                    act_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    lead, k = x_int8.shape[:-1], x_int8.shape[-1]
    acc = int8_matmul(x_int8.reshape(-1, k), p[KEY])
    y = epilogue(acc, act_scale.reshape(-1), p["scale"], p.get("bias"), out_dtype)
    return y.reshape(*lead, y.shape[-1])


def dense_int8_prequant_plain(p: Dict[str, torch.Tensor], x_int8: torch.Tensor,
                              act_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """W8A8 matmul over pre-quantized activations, the epilogue in plain torch."""
    return _dense_prequant(w8a8_epilogue_plain, p, x_int8, act_scale, out_dtype)


def dense_int8_prequant(p: Dict[str, torch.Tensor], x_int8: torch.Tensor,
                        act_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """W8A8 matmul over pre-quantized activations (shared-input layers):
    ``torch._int_mm``, then the epilogue kernel on a CUDA tensor."""
    return _dense_prequant(w8a8_epilogue, p, x_int8, act_scale, out_dtype)


def dense_int8(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """W8A8 matmul with dynamic per-token activation scales; returns x.dtype."""
    x_int8, act_scale = quantize_activations(x)
    return dense_int8_prequant(p, x_int8, act_scale, x.dtype)


def dense_int8_row(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   reduce_max: Callable[[torch.Tensor], torch.Tensor],
                   reduce_sum: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A row-parallel W8A8 layer on this rank's input slice x [..., K / m]
    and weight columns ``kernel_int8 [Npad, K / m]`` (``scale`` and ``bias``
    whole): the slice quantized with the rows' global absmax
    (``quantize_global``), the local int32 product summed over the model
    ranks by ``reduce_sum`` (exact), then the epilogue once. The result is
    the whole layer's ``dense_int8``, bit for bit."""
    x_int8, act_scale = quantize_global(x, reduce_max)
    lead, k = x_int8.shape[:-1], x_int8.shape[-1]
    acc = reduce_sum(int8_matmul(x_int8.reshape(-1, k), p[KEY]))
    y = w8a8_epilogue(acc, act_scale.reshape(-1), p["scale"], p.get("bias"), x.dtype)
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def quantize_layers(layers: Iterable[Dict], names: Tuple[str, ...],
                    quantize: Callable[[Dict], Dict]) -> List[Dict]:
    """Each layer's ``<name>_w [N, K]`` (and ``<name>_b``) in the port's layout
    becomes ``<name>: quantize({'kernel': [K, N], 'bias'?})``; the other leaves stay."""
    dense_leaves = {f"{n}_{s}" for n in names for s in ("w", "b")}
    out = []
    for lp in layers:
        q = {k: v for k, v in lp.items() if k not in dense_leaves}
        for name in names:
            dense = {"kernel": lp[f"{name}_w"].t()}
            if f"{name}_b" in lp:
                dense["bias"] = lp[f"{name}_b"]
            q[name] = quantize(dense)
        out.append(q)
    return out


QWEN2_PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")
SIGLIP_PROJECTIONS = ("q", "k", "v", "o", "fc1", "fc2")


def quantize_qwen2_params(params: Dict) -> Dict:
    """W8A8 for every transformer dense layer of the port's Qwen2 params;
    norms and embeddings stay."""
    return dict(params, layers=quantize_layers(params["layers"], QWEN2_PROJECTIONS,
                                               quantize_dense))


def quantize_siglip_params(params: Dict) -> Dict:
    """W8A8 for the SigLIP tower's dense layers (q/k/v/o, fc1/fc2); the patch
    embedding, position embeddings and layer norms stay in their float type."""
    return dict(params, layers=quantize_layers(params["layers"], SIGLIP_PROJECTIONS,
                                               quantize_dense))


def quantize_lm_head(llm_params: Dict, llm_cfg) -> Dict:
    """An int8 copy of the (tied) text head as ``lm_head_q``, which
    ``models.qwen2.logits`` then uses."""
    from ..models import qwen2
    return dict(llm_params, lm_head_q=quantize_dense(
        {"kernel": qwen2.lm_head(llm_params, llm_cfg)[0].t()}))


def quantize_unigen_params(params: Dict, cfg=None, lm_head: bool = False) -> Dict:
    """The backbone to W8A8 (projectors stay in their float type). With
    ``cfg``, also ``img_head_q``: the image head (the gen projector's, or the
    codebook rows of the tied head) in int8, which the t2i sampler's head
    then uses; with ``lm_head=True`` (needs ``cfg``) the text head too."""
    out = dict(params)
    out["llm"] = quantize_qwen2_params(params["llm"])
    if lm_head and cfg is not None:
        out["llm"] = quantize_lm_head(out["llm"], cfg.llm)
    if cfg is not None:
        if cfg.use_gen_projector:
            head_w = params["img_head"]                                 # [CB, D]
        else:
            from ..models import qwen2
            w = qwen2.lm_head(params["llm"], cfg.llm)[0]
            head_w = w[cfg.text_vocab_len:cfg.text_vocab_len + cfg.codebook_size]
        out["img_head_q"] = quantize_dense({"kernel": head_w.t()})
    return out
