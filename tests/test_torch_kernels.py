"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on the GPU machine (which has no JAX) it runs without the JAX
conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda

chip_smoke.py makes the same comparisons at the main path's shapes. Chunk
attention is held to its plain version on both of its routes (one block
walking all keys; the keys split over blocks and combined). The W4A8 kernel
sums each group exactly in int32 and folds the scales in fp32 without fused
multiply-adds, in group order, as its plain version does: the product alone
is held to 1e-5 of the output's largest magnitude (expected exact); the
fused dense layer (product, ``* act_scale + bias``, cast) and the per-token
quantization must equal their plain versions bit for bit, on every route
(split over groups, unsplit, the prefill body). fp32
tolerances: the order of the sums differs, TF32 is off. bf16 tolerances are
relative to the largest output m: the plain attention rounds P to bf16 before
P.V (2^-7 m), the plain conv rounds before its bias (2^-6 m). The GroupNorm
statistics kernel is held to 1e-5 of the largest |A|, |B| of its plain
version, on inputs with a mean of 100 against a spread of 1 too. The W8A8
epilogue kernel must equal its plain version bit for bit (ragged rows and
columns, a row slice of a wider product, bf16 and fp32 out, with and without
a bias), ``torch._int_mm`` on rows padded to 32 must give the exact product,
and the W8A8 weight layout must make the product launch no copy.
"""
import numpy as np
import pytest
import torch

from unigen_tpu_torch.ops import chunk_attention as CA
from unigen_tpu_torch.ops import fused_conv as FC
from unigen_tpu_torch.ops import masks as M
from unigen_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
from unigen_tpu_torch.ops.flash_attention import (KERNEL_HEAD_DIMS, flash_attention,
                                                  flash_attention_plain)
from unigen_tpu_torch.ops import int4 as I4
from unigen_tpu_torch.ops.int4 import pack_int4, w4a8_matmul, w4a8_matmul_plain
from unigen_tpu_torch.ops.quantization import quantize_activations, quantize_activations_plain

TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rtol):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= rtol * max(1.0, ref.abs().max().item()), err


def _qkv(b, lq, s, h, kvh, dh, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
                 for shape in ((b, lq, h, dh), (b, s, kvh, dh), (b, s, kvh, dh)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 98, 12, 2, 128), (2, 16, 40, 4, 2, 16),
                                   (1, 5, 33, 6, 3, 64)])
def test_chunk_kernel_matches_plain(cuda, dtype, shape):
    b, lq, s, h, kvh, dh = shape
    q, k, v = _qkv(b, lq, s, h, kvh, dh, 10, cuda, dtype)
    kvalid = torch.rand((b, s), generator=torch.Generator().manual_seed(1)) > 0.3
    kvalid[:, -lq:] = True
    kvalid = kvalid.to(cuda)
    _close(chunk_attention(q, k, v, kvalid), chunk_attention_plain(q, k, v, kvalid), TOL[dtype])


def _decode_case(name, device, dtype):
    """(q, k, v, kvalid) of a one-token step against a cache, 12 / 2 heads of 128."""
    b, s = {"decode": (8, 915), "masked_split": (8, 915), "masked_row": (8, 915),
            "ragged_98": (3, 98), "ragged_66": (3, 66), "one_key": (2, 1)}[name]
    q, k, v = _qkv(b, 1, s, 12, 2, 128, 18, device, dtype)
    kvalid = torch.rand((b, s), generator=torch.Generator().manual_seed(2)) > 0.3
    kvalid[:, -1] = True
    if name == "masked_split":
        kvalid[:, 128:256] = False               # the second of 8 ranges of 128 keys
    if name == "masked_row":
        kvalid[0] = False
    return q, k, v, kvalid.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["decode", "masked_split", "masked_row", "ragged_98",
                                  "ragged_66", "one_key"])
def test_chunk_split_and_unsplit_routes_match_plain(cuda, dtype, name):
    """Both routes of the kernel at few rows: unsplit (1), and split over the
    keys as the rule has it and at 8 and 15 ranges."""
    q, k, v, kvalid = _decode_case(name, cuda, dtype)
    ref = CA.chunk_attention_plain(q, k, v, kvalid)
    rule = CA.kv_splits(q.shape[0], 1, k.shape[1], 12, 2)
    assert (rule > 1) == (k.shape[1] > 64)
    for nsplit in sorted({1, 8, 15, rule}):
        _close(CA._launch(q, k, v, kvalid, nsplit), ref, TOL[dtype])
    assert torch.equal(chunk_attention(q, k, v, kvalid), CA._launch(q, k, v, kvalid, rule))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_split_route_two_positions(cuda, dtype):
    """Lq = 2 with 6 heads a group: 12 rows of the split kernel's 16."""
    q, k, v = _qkv(2, 2, 300, 12, 2, 64, 19, cuda, dtype)
    kvalid = torch.arange(300, device=cuda)[None].expand(2, 300) >= 17
    assert CA.kv_splits(2, 2, 300, 12, 2) > 1
    _close(chunk_attention(q, k, v, kvalid), CA.chunk_attention_plain(q, k, v, kvalid),
           TOL[dtype])


@pytest.mark.cuda
def test_split_route_refuses_more_rows_than_it_holds(cuda):
    q, k, v = _qkv(1, 3, 200, 12, 2, 64, 20, cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        CA._launch(q, k, v, torch.ones((1, 200), dtype=torch.bool, device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode", "ragged_66", "one_key"])
def test_chunk_counts_one_launch_on_either_route(cuda, name):
    q, k, v, kvalid = _decode_case(name, cuda, torch.bfloat16)
    before = chunk_attention.launches
    chunk_attention(q, k, v, kvalid)
    assert chunk_attention.launches == before + 1


def _meta(name, b, l, device):
    pos = torch.arange(l, device=device)[None].expand(b, l)
    pad = pos < (torch.arange(b, device=device)[:, None] * 3)
    z = torch.zeros_like(pad)
    if name == "causal_pad":
        return M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)
    if name == "all_pad_row":
        pad = pad.clone()
        pad[0] = True
        return M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)
    if name == "omni_segments":
        return M.AttnMeta(pad=pad, bidir_q=(pos % 4 == 1) & ~pad, bidir_k=(pos % 9 == 2) & ~pad,
                          seg=(pos >= l // 2).to(torch.int32))
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["causal_pad", "all_pad_row", "omni_segments"])
def test_flash_kernel_matches_plain(cuda, dtype, name):
    b, l = 3, 45
    q, k, v = _qkv(b, l, l, 12, 2, 128, 12, cuda, dtype)
    bits = M.pack_meta(_meta(name, b, l, cuda))
    _close(flash_attention(q, k, v, bits), flash_attention_plain(q, k, v, bits), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", KERNEL_HEAD_DIMS)
def test_attention_kernels_launch_at_every_head_dim(cuda, dtype, dh):
    """Every head dim the wrapper may pad to is one the kernel was built for."""
    q, k, v = _qkv(2, 19, 19, 4, 2, dh, 17, cuda, dtype)
    bits = M.pack_meta(_meta("causal_pad", 2, 19, cuda))
    _close(flash_attention(q, k, v, bits), flash_attention_plain(q, k, v, bits), TOL[dtype])
    kvalid = torch.arange(19, device=cuda)[None].expand(2, 19) >= 3
    _close(chunk_attention(q, k, v, kvalid), chunk_attention_plain(q, k, v, kvalid), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
def test_fused_conv_kernel_matches_plain(cuda, gn, dtype, rtol):
    rng = np.random.default_rng(13)
    c, cout = 64, 80

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)
    x = t(rng.normal(size=(2, 19, 37, c)))
    conv_p = {"kernel": t(rng.normal(size=(3, 3, c, cout)) * 0.05),
              "bias": t(rng.normal(size=(cout,)) * 0.1)}
    gn_p = {"scale": t(1 + 0.3 * rng.normal(size=(c,))),
            "bias": t(0.1 * rng.normal(size=(c,)))} if gn else None
    _close(FC.conv3x3_gn_swish(conv_p, gn_p, x), FC.conv3x3_gn_swish_plain(conv_p, gn_p, x), rtol)


def _conv_case(b, h, w, c, cout, gn, dtype, device, seed=13, shift=0.5, p_dtype=None):
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)
    x = t(rng.normal(size=(b, h, w, c)) + shift)
    conv_p = {"kernel": t(rng.normal(size=(3, 3, c, cout)) * (9 * c) ** -0.5),
              "bias": t(rng.normal(size=(cout,)) * 0.1)}
    gn_p = {"scale": t(1 + 0.3 * rng.normal(size=(c,)), p_dtype or dtype),
            "bias": t(0.1 * rng.normal(size=(c,)), p_dtype or dtype)} if gn else None
    return x, conv_p, gn_p


# every kernel-3 call of the MAGViTv2 decoder: (H = W, C, Cout, GroupNorm)
DECODER_CONVS = [(16, 512, 512, True), (32, 512, 512, False), (32, 512, 256, True),
                 (32, 256, 256, True), (64, 256, 256, False), (64, 256, 256, True),
                 (128, 256, 256, False), (128, 256, 128, True), (128, 128, 128, True),
                 (256, 128, 128, False), (256, 128, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,cout,gn", DECODER_CONVS)
def test_fused_conv_kernel_at_decoder_shapes(cuda, hw, c, cout, gn):
    x, conv_p, gn_p = _conv_case(1, hw, hw, c, cout, gn, torch.bfloat16, cuda)
    _close(FC.conv3x3_gn_swish(conv_p, gn_p, x), FC.conv3x3_gn_swish_plain(conv_p, gn_p, x),
           2 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("c,cout", [(96, 80), (16, 24), (24, 40), (64, 136), (12, 20)])
def test_fused_conv_kernel_ragged(cuda, c, cout, gn, dtype, rtol):
    """19 x 37 pixels (ragged tiles), C != Cout, one channel chunk (16), a last
    chunk of 8 channels whose other 8 the 16-byte copies zero-fill (24), more
    than one output block (136), and C % 8 != 0 (the plain-load staging)."""
    x, conv_p, gn_p = _conv_case(2, 19, 37, c, cout, gn, dtype, cuda, seed=c + cout)
    _close(FC.conv3x3_gn_swish(conv_p, gn_p, x), FC.conv3x3_gn_swish_plain(conv_p, gn_p, x), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
def test_fused_conv_kernel_unaligned_input(cuda, gn):
    """x that starts 2 bytes past a 16-byte boundary takes the plain loads."""
    x, conv_p, gn_p = _conv_case(2, 19, 37, 64, 64, gn, torch.bfloat16, cuda, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    _close(FC.conv3x3_gn_swish(conv_p, gn_p, xu), FC.conv3x3_gn_swish_plain(conv_p, gn_p, x),
           2 ** -6)


# (B, H, W, C, x dtype, mean of x, scale/bias dtype)
GN_CASES = {"large_mean_bf16": (1, 256, 256, 128, torch.bfloat16, 100.0, None),
            "large_mean_fp32": (1, 256, 256, 128, torch.float32, 100.0, None),
            "c16_large_mean": (2, 19, 37, 16, torch.bfloat16, 100.0, None),
            "c12_bf16_params": (2, 19, 37, 12, torch.float32, -3.0, torch.bfloat16),
            "c512": (4, 16, 16, 512, torch.bfloat16, 0.5, None),
            "few_pixels_fp32_params": (3, 5, 7, 96, torch.bfloat16, 0.5, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GN_CASES))
def test_gn_affine_kernel_matches_plain(cuda, name):
    b, h, w, c, dtype, shift, p_dtype = GN_CASES[name]
    x, _, gn_p = _conv_case(b, h, w, c, 8, True, dtype, cuda, seed=23, shift=shift,
                            p_dtype=p_dtype)
    got, ref = FC.gn_affine(gn_p, x), FC.gn_affine_plain(gn_p, x)
    assert got.shape == (b, 2, c) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
def test_fused_conv_counts_one_launch_each(cuda, gn):
    x, conv_p, gn_p = _conv_case(1, 9, 9, 32, 32, gn, torch.bfloat16, cuda)
    before = (FC.conv3x3_gn_swish.launches, FC.gn_affine.launches)
    FC.conv3x3_gn_swish(conv_p, gn_p, x)
    cpu = (lambda p: None if p is None else {k: v.cpu() for k, v in p.items()})
    FC.conv3x3_gn_swish(cpu(conv_p), cpu(gn_p), x.cpu())
    assert (FC.conv3x3_gn_swish.launches, FC.gn_affine.launches) == (before[0] + 1,
                                                                      before[1] + int(gn))


@pytest.mark.cuda
def test_wrappers_count_launches_only_on_the_card(cuda):
    q, k, v = _qkv(1, 4, 8, 4, 2, 16, 14, cuda, torch.float32)
    before = chunk_attention.launches
    chunk_attention(q, k, v, torch.ones((1, 8), dtype=torch.bool, device=cuda))
    chunk_attention(q.cpu(), k.cpu(), v.cpu(), torch.ones((1, 8), dtype=torch.bool))
    assert chunk_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [8, 72])
def test_flash_kernel_padded_siglip_head_dim(cuda, dtype, dh):
    """SigLIP's bidirectional attention: head dim zero-padded to 16 / 80."""
    from unigen_tpu_torch.models.siglip import _bidir_attention
    q, k, v = _qkv(2, 41, 41, 4, 4, dh, 15, cuda, dtype)
    got = _bidir_attention(q, k, v, dh ** -0.5)
    ref = _bidir_attention(q.cpu().float(), k.cpu().float(), v.cpu().float(), dh ** -0.5)
    _close(got, ref.to(cuda), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,n,group", [(8, 1536, 8960, 256), (5, 128, 96, 32),
                                         (37, 512, 1000, 64), (70, 256, 512, 16),
                                         (3, 96, 40, 6)])
def test_w4a8_kernel_matches_plain(cuda, t, k, n, group):
    rng = np.random.default_rng(16)
    packed, scale = pack_int4(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)), group)
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(t, k)).astype(np.int8))
    packed, scale, x8 = packed.to(cuda), scale.to(cuda), x8.to(cuda)
    ref = w4a8_matmul_plain(x8, packed, scale, group=group)
    for cols in (packed.shape[1], n):        # padded width, and an unaligned column slice
        got = w4a8_matmul(x8, packed[:, :cols], scale[:, :cols], group=group)
        _close(got, ref[:, :cols], 1e-5)


@pytest.mark.cuda
def test_w4a8_counts_launches_only_on_the_card(cuda):
    packed, scale = pack_int4(torch.ones((64, 8)), 32)
    x8 = torch.ones((2, 64), dtype=torch.int8)
    before = w4a8_matmul.launches
    w4a8_matmul(x8.to(cuda), packed.to(cuda), scale.to(cuda), group=32)
    w4a8_matmul(x8, packed, scale, group=32)
    assert w4a8_matmul.launches == before + 1


def _activations(t, k, seed, device, dtype):
    """Normal * 3 rows with, where there are rows for them, an all-zero row
    and a row whose scale is 1 (max 127) holding exact .5 ties and +-127."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, k)).astype(np.float32) * 3
    if t > 2:
        x[1] = 0.0
        ties = np.array([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0], np.float32)
        x[2] = np.resize(ties, k)
    return torch.from_numpy(x).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1536, 8960, 999])
@pytest.mark.parametrize("t", [1, 8, 6296])
def test_quantize_kernel_equals_plain(cuda, t, k, dtype):
    x = _activations(t, k, 17, cuda, dtype)
    got, ref = quantize_activations(x), quantize_activations_plain(x)
    assert got[0].shape == (t, k) and got[1].shape == (t, 1)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_quantize_kernel_counts_one_launch_and_keeps_lead_dims(cuda):
    x = _activations(6, 40, 18, cuda, torch.bfloat16).reshape(2, 3, 40)
    before = quantize_activations.launches
    x8, s = quantize_activations(x)
    quantize_activations(x.cpu())
    assert quantize_activations.launches == before + 1
    assert x8.shape == (2, 3, 40) and s.shape == (2, 3, 1)
    assert torch.equal(x8, quantize_activations_plain(x)[0])


def _dense_case(t, k, n, group, seed, device, bias_dtype):
    rng = np.random.default_rng(seed)
    packed, scale = pack_int4(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)), group)
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(t, k)).astype(np.int8))
    act = torch.from_numpy((rng.random((t, 1)) * 0.05 + 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32) * 0.1).to(bias_dtype)
    p = {I4.KEY: packed.to(device), "scale4": scale.to(device), "bias": bias.to(device)}
    return p, x8.to(device), act.to(device)


# (T, K, N, group): decode (split), the head (unsplit), the prefill body, and
# ragged T, N and groups on each route (group 16 and N 96 take the prefill
# body's plain loads)
DENSE_CASES = [(8, 1536, 8960, 256), (8, 512, 159867, 256), (6296, 1536, 8960, 256),
               (5, 128, 96, 32), (5, 512, 1000, 64), (37, 512, 1000, 64), (37, 256, 96, 32),
               (70, 256, 512, 16), (300, 1024, 1000, 256), (3, 96, 40, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,n,group", DENSE_CASES)
def test_w4a8_dense_kernel_equals_plain(cuda, t, k, n, group, bias_dtype, out_dtype):
    p, x8, act = _dense_case(t, k, n, group, 19, cuda, bias_dtype)
    ref = I4.dense_int4_prequant_plain(p, x8, act, out_dtype)
    got = I4.dense_int4_prequant(p, x8, act, out_dtype)
    assert got.dtype == out_dtype and got.shape == (t, n)
    assert torch.equal(got, ref)
    if t <= 16:        # the route the wrapper does not choose gives the same bits
        other = I4._dense_launch(x8, p[I4.KEY], p["scale4"], act, p["bias"], out_dtype, group,
                                 not I4.splits_over_groups(t, n))
        assert torch.equal(other, got)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 37])
def test_w4a8_dense_counts_one_launch(cuda, t):
    p, x8, act = _dense_case(t, 256, 96, 64, 20, cuda, torch.float32)
    before = w4a8_matmul.launches
    y = I4.dense_int4_prequant(p, x8.reshape(1, t, 256), act.reshape(1, t, 1), torch.bfloat16)
    I4.dense_int4_prequant({k: v.cpu() for k, v in p.items()}, x8.cpu(), act.cpu(),
                           torch.bfloat16)
    assert w4a8_matmul.launches == before + 1 and y.shape == (1, t, 96)


@pytest.mark.cuda
def test_dense_int4_layer_equals_plain_composition(cuda):
    """quantization + fused product, as a layer runs them, against the plain
    composition, in bf16 with a bf16 bias."""
    rng = np.random.default_rng(21)
    w = torch.from_numpy(rng.normal(size=(1536, 256)).astype(np.float32) * 0.03)
    b = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32) * 0.1)
    p = {k: v.to(cuda) for k, v in I4.quantize_dense_int4(
        {"kernel": w, "bias": b.to(torch.bfloat16)}).items()}
    x = _activations(37, 1536, 22, cuda, torch.bfloat16).reshape(1, 37, 1536)
    ref = I4.dense_int4_prequant_plain(p, *quantize_activations_plain(x), torch.bfloat16)
    assert torch.equal(I4.dense_int4(p, x), ref)


# ---------------------------------------------------------------------------
# W8A8: the epilogue kernel (csrc/int8.cu) and the product around it
# ---------------------------------------------------------------------------

def _epilogue_case(m, ld, n, bias_dtype, seed, device):
    """An int32 product [m, ld] (values up to 2^27, as K 8960 x 127 x 127
    reaches), per-row activation scales, per-column scales, a bias of n."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(-2 ** 27, 2 ** 27, size=(m, ld)).astype(np.int32))
    act = torch.from_numpy((rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32))
    scale = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32))
    bias = None if bias_dtype is None else torch.from_numpy(
        rng.normal(size=(n,)).astype(np.float32)).to(bias_dtype)
    return tuple(None if t is None else t.to(device) for t in (acc, act, scale, bias))


# (M, ld, n): t2i gate/up, decode head (odd n, padded ld), ragged rows and
# columns, a column slice of a wider product, one row
EPILOGUE_CASES = [(2064, 8960, 8960), (8, 159872, 159867), (37, 1000, 1000), (5, 104, 97),
                  (300, 2048, 1000), (1, 8, 3), (6296, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,ld,n", EPILOGUE_CASES)
def test_w8a8_epilogue_kernel_equals_plain(cuda, m, ld, n, bias_dtype, out_dtype):
    from unigen_tpu_torch.ops import quantization as QZ
    acc, act, scale, bias = _epilogue_case(m, ld, n, bias_dtype, 23, cuda)
    ref = QZ.w8a8_epilogue_plain(acc, act, scale, bias, out_dtype)
    got = QZ.w8a8_epilogue(acc, act, scale, bias, out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, ref)
    if m > 1:             # a row slice (the padded decode product's view)
        assert torch.equal(QZ.w8a8_epilogue(acc[1:], act[1:], scale, bias, out_dtype), ref[1:])


@pytest.mark.cuda
def test_w8a8_epilogue_counts_one_launch(cuda):
    from unigen_tpu_torch.ops import quantization as QZ
    acc, act, scale, bias = _epilogue_case(4, 16, 16, torch.float32, 24, cuda)
    before = QZ.w8a8_epilogue.launches
    QZ.w8a8_epilogue(acc, act, scale, bias, torch.bfloat16)
    QZ.w8a8_epilogue(acc.cpu(), act.cpu(), scale.cpu(), bias.cpu(), torch.bfloat16)
    assert QZ.w8a8_epilogue.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 2064])
def test_int8_matmul_exact_with_padded_rows(cuda, m):
    """torch._int_mm on the card takes more than 16 rows: smaller products
    run on rows padded with zeros to 32; every result is the exact product."""
    from unigen_tpu_torch.ops import quantization as QZ
    rng = np.random.default_rng(25)
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(m, 1536)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, size=(264, 1536)).astype(np.int8)).to(cuda)
    got = QZ.int8_matmul(x8, w)
    assert got.dtype == torch.int32 and got.shape == (m, 264)
    assert torch.equal(got.double(), x8.double() @ w.double().t())


@pytest.mark.cuda
def test_int8_matmul_weight_layout_makes_no_copy(cuda):
    """The W8A8 leaf's [Npad, K] weight is what torch._int_mm reads as its
    transposed operand: the product launches no copy or transpose kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from unigen_tpu_torch.ops import quantization as QZ
    p = QZ.quantize_dense({"kernel": torch.randn((1536, 8960), device=cuda)})
    assert p["kernel_int8"].shape == (8960, 1536) and p["kernel_int8"].is_contiguous()
    x8 = torch.randint(-127, 128, (2064, 1536), dtype=torch.int8, device=cuda)
    QZ.int8_matmul(x8, p["kernel_int8"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        QZ.int8_matmul(x8, p["kernel_int8"])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [n for n in names if "copy" in n.lower() or "transpose" in n.lower()]
    assert names and not copies, names


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 37])
def test_dense_int8_layer_equals_plain_composition(cuda, t):
    """quantization + torch._int_mm + the epilogue kernel, as a layer runs
    them, against the plain composition, in bf16 with a bf16 bias."""
    from unigen_tpu_torch.ops import quantization as QZ
    rng = np.random.default_rng(26)
    w = torch.from_numpy(rng.normal(size=(1536, 256)).astype(np.float32) * 0.03)
    b = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32) * 0.1)
    p = {k: v.to(cuda) for k, v in QZ.quantize_dense(
        {"kernel": w, "bias": b.to(torch.bfloat16)}).items()}
    x = _activations(t, 1536, 27, cuda, torch.bfloat16).reshape(1, t, 1536)
    ref = QZ.dense_int8_prequant_plain(p, *quantize_activations_plain(x), torch.bfloat16)
    assert torch.equal(QZ.dense_int8(p, x), ref)
