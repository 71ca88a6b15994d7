"""The port's hand-written Hopper kernels against their plain PyTorch
versions, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card with
`nvcc` and skips elsewhere. The file imports no JAX, so it also runs where
JAX is not installed (the repository's conftest imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from xtuner_tpu_torch.ops.attention.flash import (BIG_LSE, flash_attention,
                                                  flash_attention_plain, flash_dkv,
                                                  flash_dkv_plain, flash_dq, flash_dq_plain,
                                                  max_free_launches, reset_launches)
from xtuner_tpu_torch.ops.attention.paged_decode import (paged_decode_attn,
                                                         paged_decode_attn_plain)
from xtuner_tpu_torch.ops.bf16_grouped import (bf16_grouped_linear, grouped_gemm_bf16,
                                               grouped_gemm_bf16_dw, grouped_gemm_dw_plain,
                                               grouped_gemm_plain)

pytestmark = pytest.mark.cuda

# flash: the kernel rounds P to bf16 before the PV product (as the TPU
# kernel does) and the output to bf16; the plain version does neither
FLASH_OUT_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3  # both sum exactly-representable bf16 products in f32
# paged decode: both read the same bf16 values and compute in f32; only the
# summation order and exp2 vs exp differ
PAGED_ATOL = 2e-4
# flash backward: the kernels round p and ds to bf16 before the tensor-core
# products and the results to bf16; the plain versions do neither. Errors
# scale with the gradient, so the bound is relative to its largest entry.
FLASH_GRAD_RTOL = 2e-2
# grouped GEMMs: both accumulate bf16 products in f32 and round the output
# once (nn/nt, to bf16: <= 1 ulp, 2^-8 relative); dw keeps f32 and differs
# only in summation order
GG_RTOL = 1e-2
DW_RTOL = 1e-4
# fused CE: lse and label_logit are f32 sums of the same bf16 products in
# another order; dh and dw round the coefficient and the result to bf16
# (the grouped GEMMs' bound, relative to the largest entry)
CE_STAT_ATOL = 1e-3
# fp8 GEMMs: both sides multiply the same fp8 codes exactly; the kernels
# sum each 128-deep tile in the tensor cores' accumulator, the plain
# versions dequantise in f32 first and sum in another order. Outputs in bf16
# round once (the grouped GEMMs' bound, relative to the largest entry); f32
# outputs (the wgrad) differ by accumulation order and precision only
FP8_RTOL = 1e-2
FP8_DW_RTOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _packed(dev, b, l, hq, hkv, docs, pad, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, l, hq, 128), generator=g, device=dev).bfloat16()
    k = torch.randn((b, l, hkv, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((b, l, hkv, 128), generator=g, device=dev).bfloat16()
    seg = torch.zeros((b, l), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(1, l - pad), docs - 1, replace=False)) \
            if docs > 1 else []
        bounds = [0, *list(cuts), l - pad]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


@pytest.mark.parametrize("b,l,hq,hkv,docs,pad", [
    (1, 1024, 32, 8, 1, 24),   # the slice's prefill: 1000 tokens in a 1024 bucket
    (2, 1024, 16, 8, 6, 40),   # moe_heavy's heads: B2, 16/8 (group 2)
    (2, 200, 4, 2, 3, 7),      # packed documents, ragged tile edge
    (1, 64, 4, 4, 1, 0),       # one tile, no GQA
    (1, 77, 8, 2, 2, 60),      # mostly padding
])
def test_flash_kernel_matches_plain(cuda, b, l, hq, hkv, docs, pad):
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, docs, pad)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 128 ** -0.5)
    valid = seg != 0
    assert torch.isfinite(out.float()).all()
    assert (out[valid].float() - ref_out[valid].float()).abs().max().item() <= FLASH_OUT_ATOL
    lse_valid = lse.transpose(1, 2)[valid]
    ref_valid = ref_lse.transpose(1, 2)[valid]
    assert (lse_valid - ref_valid).abs().max().item() <= FLASH_LSE_ATOL
    assert (out[~valid] == 0).all()
    assert (lse.transpose(1, 2)[~valid] == torch.tensor(BIG_LSE, dtype=torch.float32)).all()


def _paged(dev, b, c, hq, hkv, bs, lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mb = -(-(max(lens) + c) // bs)
    nb = b * mb + 1
    pk = torch.randn((2, nb, bs, hkv, 128), generator=g, device=dev).bfloat16()
    pv = torch.randn((2, nb, bs, hkv, 128), generator=g, device=dev).bfloat16()
    q = torch.randn((b, c, hq, 128), generator=g, device=dev).bfloat16()
    table = torch.zeros((b, mb), dtype=torch.int32)
    perm = np.random.default_rng(seed).permutation(np.arange(1, nb)).tolist()
    for bi, n in enumerate(lens):
        if n:
            for t in range(-(-(n + c) // bs)):
                table[bi, t] = perm.pop()
    return (q, pk, pv, table.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("b,c,hq,hkv,bs,lens", [
    (4, 1, 32, 8, 128, [1000, 0, 517, 1900]),  # the slice's decode, one inactive slot
    (3, 1, 8, 2, 16, [37, 15, 63]),            # block edges
    (2, 2, 8, 2, 16, [31, 0]),                 # C = 2: 8 query rows per CTA
    (2, 1, 4, 4, 16, [20, 3]),                 # 1 query row (no GQA)
    (2, 1, 4, 2, 32, [40, 70]),                # 2 query rows
    (1, 3, 4, 4, 16, [33]),                    # 3 rows, padded to 4
    (1, 4, 8, 2, 16, [50]),                    # 16 rows, the most a CTA takes
])
def test_paged_decode_kernel_matches_plain(cuda, b, c, hq, hkv, bs, lens):
    q, pk, pv, table, seq_lens = _paged(cuda, b, c, hq, hkv, bs, lens)
    n0 = paged_decode_attn.launches
    out = paged_decode_attn(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert paged_decode_attn.launches == n0 + 1
    ref = paged_decode_attn_plain(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= PAGED_ATOL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, seg = _packed(cuda, 1, 64, 4, 2, 1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), seg)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                        v[..., :64].contiguous(), seg)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg)
    qd, pk, pv, table, lens = _paged(cuda, 2, 1, 8, 2, 16, [5, 9])
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attn(qd, pk, pv, 0, table.long(), lens, scale=1.0)
    with pytest.raises(ValueError, match="layer"):
        paged_decode_attn(qd, pk, pv, 2, table, lens, scale=1.0)


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("bound,max_free", [(11.3, True), (45.0, True), (60.0, False)])
def test_flash_max_free_variant_matches_plain(cuda, bound, max_free):
    q, k, v, seg = _packed(cuda, 1, 200, 8, 2, 3, 9)
    reset_launches()
    out, lse = flash_attention(q, k, v, seg, max_logit=torch.tensor(bound, device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and max_free_launches() == int(max_free)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 128 ** -0.5, max_free=max_free)
    valid = seg != 0
    assert (out[valid].float() - ref_out[valid].float()).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse.transpose(1, 2)[valid] - ref_lse.transpose(1, 2)[valid]).abs().max().item() \
        <= FLASH_LSE_ATOL
    assert (out[~valid] == 0).all()


@pytest.mark.parametrize("b,l,hq,hkv,docs,pad", [
    (1, 512, 8, 2, 3, 40),     # packed documents, padded tail, GQA 4
    (2, 1024, 16, 8, 6, 40),   # moe_heavy's heads: B2, 16/8 (group 2)
    (2, 200, 4, 2, 2, 7),      # L not a multiple of 64, GQA 2
    (1, 64, 4, 4, 1, 0),       # one tile, no GQA
    (1, 77, 8, 1, 2, 60),      # mostly padding, one kv head
])
def test_flash_backward_kernels_match_plain(cuda, b, l, hq, hkv, docs, pad):
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, docs, pad)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
    scale = 128 ** -0.5
    out, lse = flash_attention_plain(q, k, v, seg, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    reset_launches()
    dq = flash_dq(q, k, v, seg, lse, delta, do, scale)
    dk, dv = flash_dkv(q, k, v, seg, lse, delta, do, scale)
    torch.cuda.synchronize()
    assert (flash_dq.launches, flash_dkv.launches) == (1, 1)
    ref_dq = flash_dq_plain(q, k, v, seg, lse, delta, do, scale)
    ref_dk, ref_dv = flash_dkv_plain(q, k, v, seg, lse, delta, do, scale)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL
    assert (dq[seg == 0] == 0).all() and (dk[seg == 0] == 0).all()


def test_flash_autograd_matches_plain_autograd(cuda):
    q, k, v, seg = _packed(cuda, 1, 300, 8, 2, 3, 20, seed=3)
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda)
    grads = []
    for fn in (lambda *a: flash_attention(*a, max_logit=torch.tensor(11.3, device=cuda))[0],
               lambda *a: flash_attention_plain(*a, 128 ** -0.5)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, seg).float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL


def _grouped(dev, m, c, e, k, n, sizes, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, c), generator=g, device=dev).bfloat16()
    w = (torch.randn((e, k, n), generator=g, device=dev) * 0.05).bfloat16()
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("m,k,n,sizes", [
    (1024, 256, 384, [100, 0, 500, 424]),     # empty expert, unaligned sizes
    (1024, 256, 128, [0, 1024, 0, 0]),        # one expert with all rows
    (1000, 128, 224, [37, 300, 1, 600]),      # ragged M and N edges
    (700, 96, 64, [200, 0, 0, 400]),          # rows past the last group -> 0
    (8192, 1024, 1536, [300, 700, 0, 1200, 500, 400, 600, 100,  # moe_heavy gate|up: E16
                        800, 900, 200, 500, 300, 400, 292, 500]),
    (8192, 768, 1024, [512] * 16),            # moe_heavy down: E16
])
def test_grouped_gemm_kernels_match_plain(cuda, m, k, n, sizes):
    e = len(sizes)
    x, w, gs = _grouped(cuda, m, k, e, k, n, sizes)
    grouped_gemm_bf16.launches = {"nn": 0, "nt": 0}
    out = grouped_gemm_bf16(x, w, gs)
    dy = torch.randn((m, n), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda).bfloat16()
    dx = grouped_gemm_bf16(dy, w, gs, transpose_rhs=True)
    torch.cuda.synchronize()
    assert grouped_gemm_bf16.launches == {"nn": 1, "nt": 1}
    assert _rel_err(out, grouped_gemm_plain(x, w, gs)) <= GG_RTOL
    assert _rel_err(dx, grouped_gemm_plain(dy, w, gs, transpose_rhs=True)) <= GG_RTOL
    if sum(sizes) < m:
        assert (out[sum(sizes):] == 0).all() and (dx[sum(sizes):] == 0).all()
    if k % 16 == 0 and n % 16 == 0:
        n0 = grouped_gemm_bf16_dw.launches
        dw = grouped_gemm_bf16_dw(x, dy, gs, e)
        torch.cuda.synchronize()
        assert grouped_gemm_bf16_dw.launches == n0 + 1
        want = grouped_gemm_dw_plain(x, dy, gs, e)
        assert dw.dtype == torch.float32 and _rel_err(dw, want) <= DW_RTOL
        assert all((dw[i] == 0).all() for i, s in enumerate(sizes) if s == 0)


def test_grouped_linear_grads_match_plain(cuda):
    x, w, gs = _grouped(cuda, 1111, 256, 4, 256, 128, [400, 0, 600, 111])
    co = torch.randn((1111, 128), generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (bf16_grouped_linear(xl, wl, gs).float() * co).sum().backward()
    xr, wr = x.float().requires_grad_(True), w.float().requires_grad_(True)
    (grouped_gemm_plain(xr, wr, gs).float() * co).sum().backward()
    assert _rel_err(xl.grad, xr.grad) <= GG_RTOL
    assert _rel_err(wl.grad, wr.grad) <= GG_RTOL


def _ce_inputs(dev, n, v, hd, ignored=0.05, seed=0):
    """h, w as the model feeds them (unit-RMS rows times a 0.02 init, so
    logits of std ~0.02 sqrt(H)); labels with `ignored` of the rows clamped
    to 0 and given zero cotangents, as `_fused_ce` does."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, hd), generator=g, device=dev).bfloat16()
    w = (torch.randn((v, hd), generator=g, device=dev) * 0.02).bfloat16()
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    keep = torch.rand((n,), generator=g, device=dev) >= ignored
    labels = torch.where(keep, labels, torch.zeros_like(labels))
    g_lse = torch.where(keep, torch.rand((n,), generator=g, device=dev), 0.0)
    g_lab = torch.where(keep, -torch.rand((n,), generator=g, device=dev), 0.0)
    return h, w, labels, g_lse.contiguous(), g_lab.contiguous()


@pytest.mark.parametrize("n,v,hd,cotangents", [
    (16384, 151936, 1024, "both"),  # the moe_heavy step: 2 rows of 8192, Qwen's vocab
    # g_lse alone: dh and dw are the softmax part alone, held to their own
    # scale (with both, the label term's entries dominate dw at p ~ 1/V)
    (16384, 151936, 1024, "g_lse"),
    (1000, 100, 128, "both"),       # N not a multiple of 128, V < one tile
    (1000, 100, 128, "g_lab"),
    (300, 5000, 256, "g_lab"),      # ragged vocab tail
    (300, 5000, 256, "g_lse"),
])
def test_fused_ce_kernels_match_plain(cuda, n, v, hd, cotangents):
    from xtuner_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_lab = _ce_inputs(cuda, n, v, hd)
    if cotangents == "g_lab":
        g_lse = torch.zeros_like(g_lse)
    if cotangents == "g_lse":
        g_lab = torch.zeros_like(g_lab)
    fc.reset_launches()
    lse, lab = fc.ce_fwd(h, w, labels)
    ref_lse, ref_lab = fc.ce_fwd_plain(h, w, labels)
    assert (lse - ref_lse).abs().max().item() <= CE_STAT_ATOL
    assert (lab - ref_lab).abs().max().item() <= CE_STAT_ATOL
    dh = fc.ce_dh(h, w, labels, ref_lse, g_lse, g_lab)
    dw = fc.ce_dw(h, w, labels, ref_lse, g_lse, g_lab)
    torch.cuda.synchronize()
    assert (fc.ce_fwd.launches, fc.ce_dh.launches, fc.ce_dw.launches) == (1, 1, 1)
    assert dh.dtype == dw.dtype == torch.bfloat16 and dw.shape == w.shape
    assert _rel_err(dh, fc.ce_dh_plain(h, w, labels, ref_lse, g_lse, g_lab)) <= GG_RTOL
    assert _rel_err(dw, fc.ce_dw_plain(h, w, labels, ref_lse, g_lse, g_lab)) <= GG_RTOL


def test_fused_ce_autograd_matches_plain_autograd(cuda):
    from xtuner_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_lab = _ce_inputs(cuda, 700, 3000, 256, seed=5)
    grads = []
    # the kernels on bf16 leaves; autograd through the plain forward in f32
    for fn, dtype in ((fc.ce_stats_vh, torch.bfloat16), (fc.ce_fwd_plain, torch.float32)):
        hl = h.to(dtype).detach().clone().requires_grad_(True)
        wl = w.to(dtype).detach().clone().requires_grad_(True)
        lse, lab = fn(hl, wl, labels)
        ((lse * g_lse).sum() + (lab * g_lab).sum()).backward()
        grads.append((hl.grad, wl.grad))
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= GG_RTOL


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, seg = _packed(cuda, 1, 64, 4, 2, 1, 0)
    lse = torch.zeros((1, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="do must be"):
        flash_dq(q, k, v, seg, lse, lse, q.float(), 1.0)
    with pytest.raises(ValueError, match="delta"):
        flash_dkv(q, k, v, seg, lse, lse[:, :2], q, 1.0)
    with pytest.raises(ValueError, match="max_logit"):
        flash_attention(q, k, v, seg, max_logit=torch.tensor(1.0))
    x, w, gs = _grouped(cuda, 64, 64, 2, 64, 32, [30, 34])
    with pytest.raises(ValueError, match="bfloat16"):
        grouped_gemm_bf16(x.float(), w, gs)
    with pytest.raises(ValueError, match="int32"):
        grouped_gemm_bf16(x, w, gs.long())
    with pytest.raises(ValueError, match="multiple of 32"):
        grouped_gemm_bf16(x[:, :48].contiguous(), w[:, :48].contiguous(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm_bf16_dw(x.T.contiguous().T, x, gs, 2)
    with pytest.raises(ValueError, match="do not fit"):
        grouped_gemm_bf16(x, w, gs, transpose_rhs=True)
    from xtuner_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_lab = _ce_inputs(cuda, 64, 300, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        fc.ce_fwd(h.float(), w, labels)
    with pytest.raises(ValueError, match="int32"):
        fc.ce_fwd(h, w, labels.long())
    with pytest.raises(ValueError, match="multiple of 128"):
        fc.ce_fwd(h[:, :64].contiguous(), w[:, :64].contiguous(), labels)
    with pytest.raises(ValueError, match="contiguous"):
        fc.ce_dw(h, w.T.contiguous().T, labels, g_lse, g_lse, g_lab)


def _fp8_operands(dev, m, k, n, e=None, a_dtype=torch.float8_e4m3fn, seed=0):
    """x quantised per (row, 128-col) tile in `a_dtype`, w (K, N) or
    (E, K, N) per 128 x 128 block in e4m3."""
    from xtuner_tpu_torch.ops.fp8_gemm import quantize_blockwise, quantize_tilewise
    from xtuner_tpu_torch.ops.fp8_grouped import quantize_blockwise_stack

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n) if e is None else (e, k, n), generator=g, device=dev) * 0.05
    xq, sx = quantize_tilewise(x, dtype=a_dtype)
    wq, sw = quantize_blockwise(w) if e is None else quantize_blockwise_stack(w)
    return xq, sx, wq, sw


@pytest.mark.parametrize("m,k,n,a_dtype,b_dtype", [
    (16384, 1024, 2048, "e4m3", "e4m3"),  # moe_heavy q projection
    (16384, 2048, 1024, "e4m3", "e4m3"),  # o projection
    (4096, 1024, 1024, "e5m2", "e4m3"),   # an e5m2 dgrad
    (1024, 4096, 1024, "e4m3", "e5m2"),   # an e5m2 wgrad (contraction over rows)
    (200, 768, 256, "e4m3", "e4m3"),      # K = 768, M not a 128 multiple
    (77, 384, 128, "e5m2", "e4m3"),       # K = 384, M below one tile
])
def test_fp8_gemm_kernel_matches_plain(cuda, m, k, n, a_dtype, b_dtype):
    from xtuner_tpu_torch.ops import fp8_gemm as fg

    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    xq, sx, _, _ = _fp8_operands(cuda, m, k, n, a_dtype=dt[a_dtype])
    g = torch.Generator(device=cuda).manual_seed(3)
    wq, sw = fg.quantize_blockwise(torch.randn((k, n), generator=g, device=cuda) * 0.05,
                                   dtype=dt[b_dtype])
    fg.reset_launches()
    for out_dtype in (torch.bfloat16, torch.float32):
        got = fg.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=out_dtype)
        want = fg.fp8_gemm_tilewise_plain(xq, sx, wq, sw, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert _rel_err(got, want) <= (FP8_RTOL if out_dtype == torch.bfloat16 else FP8_DW_RTOL)
    assert fg.fp8_gemm_tilewise.launches == 2


@pytest.mark.parametrize("m,k,n,sizes,a_dtype", [
    # moe_heavy's gate/up at a quarter of its rows, one expert empty
    (32768, 1024, 768, [2500, 2000, 0, 2200, 2100, 1900, 2300, 2048, 2000,
                        2200, 2150, 2050, 1950, 2100, 2068, 3200], "e4m3"),
    (32768, 768, 1024, [2048] * 16, "e5m2"),  # down's dgrad shape, e5m2 gradient
    (700, 768, 256, [300, 1, 0, 333], "e4m3"),  # 1-row expert, 66 rows past the last
    (1000, 384, 128, [0, 1000, 0, 0], "e5m2"),  # K = 384, one expert has every row
])
def test_fp8_grouped_gemm_kernel_matches_plain(cuda, m, k, n, sizes, a_dtype):
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    e = len(sizes)
    xq, sx, wq, sw = _fp8_operands(cuda, m, k, n, e, a_dtype=dt[a_dtype])
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    fgr.reset_launches()
    got = fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)
    want = fgr.fp8_grouped_gemm_plain(xq, sx, wq, sw, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fgr.fp8_grouped_gemm.launches == 1 and got.dtype == torch.bfloat16
    assert _rel_err(got, want) <= FP8_RTOL
    assert (got[sum(sizes):] == 0).all()


@pytest.mark.parametrize("m,k,n,sizes,y_dtype", [
    (32768, 1024, 768, [2500, 2000, 0, 2200, 2100, 1900, 2300, 2048, 2000,
                        2200, 2150, 2050, 1950, 2100, 2068, 3200], "e4m3"),
    (32768, 768, 1024, [2048] * 16, "e5m2"),
    (640, 768, 256, [300, 1, 0, 339], "e4m3"),  # tiles straddle experts, a 1-row expert
    (1024, 384, 128, [0, 0, 1000, 0], "e5m2"),  # 24 rows past the last group
])
def test_fp8_grouped_dw_kernel_matches_plain(cuda, m, k, n, sizes, y_dtype):
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    e = len(sizes)
    g = torch.Generator(device=cuda).manual_seed(4)
    xq, sx = fgr.quantize_rowtile(torch.randn((m, k), generator=g, device=cuda))
    yq, sy = fgr.quantize_rowtile(torch.randn((m, n), generator=g, device=cuda),
                                  dtype=dt[y_dtype])
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    fgr.reset_launches()
    got = fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, e)
    want = fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, gs, e)
    torch.cuda.synchronize()
    assert fgr.fp8_grouped_gemm_dw.launches == 1 and got.dtype == torch.float32
    assert _rel_err(got, want) <= FP8_DW_RTOL
    assert all((got[i] == 0).all() for i, s_ in enumerate(sizes) if s_ == 0)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_quantisers_on_the_card_match_the_cpu(cuda, dtype):
    """The same codes and scales on both devices (the CPU ones are JAX's,
    tests/test_torch_float8.py)."""
    from xtuner_tpu_torch.ops import fp8_gemm as fg
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    x = torch.randn((3, 512, 768), generator=torch.Generator().manual_seed(7)).bfloat16()
    for fn, t in ((fg.quantize_tilewise, x), (fg.quantize_blockwise, x[0]),
                  (fgr.quantize_blockwise_stack, x), (fgr.quantize_rowtile, x[1])):
        (qc, sc), (qg, sg) = fn(t, dtype=dtype), fn(t.to(cuda), dtype=dtype)
        assert torch.equal(qg.cpu().view(torch.uint8), qc.view(torch.uint8)), fn.__name__
        assert torch.equal(sg.cpu(), sc), fn.__name__


@pytest.mark.parametrize("gran,e5m2", [("tilewise", False), ("tilewise", True),
                                       ("tensorwise", False)])
def test_fp8_matmul_on_the_card_matches_the_cpu(cuda, gran, e5m2):
    """The autograd op through the kernels against the same op on the CPU,
    where the wrappers run the plain versions."""
    from xtuner_tpu_torch.ops.float8 import fp8_matmul

    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 500, 1024), generator=g).bfloat16()
    w = torch.randn((1024, 640), generator=g) * 0.05
    co = torch.randn((3, 500, 640), generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xl = x.to(dev).requires_grad_(True)
        wl = w.to(dev).bfloat16().requires_grad_(True)
        y = fp8_matmul(xl, wl, gran, 128, e5m2)
        (y.float() * co.to(dev)).sum().backward()
        grads.append([t.float().cpu() for t in (y.detach(), xl.grad, wl.grad)])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FP8_RTOL


@pytest.mark.parametrize("e5m2", [False, True])
def test_fp8_grouped_linear_on_the_card_matches_the_cpu(cuda, e5m2):
    from xtuner_tpu_torch.ops.fp8_grouped import fp8_grouped_linear

    g = torch.Generator().manual_seed(6)
    sizes = [700, 0, 1, 1299]
    x = torch.randn((2000, 768), generator=g).bfloat16()
    w = torch.randn((4, 768, 1024), generator=g) * 0.05
    co = torch.randn((2000, 1024), generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        xl = x.to(dev).requires_grad_(True)
        wl = w.to(dev).bfloat16().requires_grad_(True)
        y = fp8_grouped_linear(xl, wl, gs, e5m2)
        (y.float() * co.to(dev)).sum().backward()
        grads.append([t.float().cpu() for t in (y.detach(), xl.grad, wl.grad)])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FP8_RTOL


def test_fp8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from xtuner_tpu_torch.ops import fp8_gemm as fg
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    xq, sx, wq, sw = _fp8_operands(cuda, 256, 256, 128)
    with pytest.raises(ValueError, match="tile 64"):
        x64, s64 = fg.quantize_tilewise(torch.ones((4, 64), device=cuda), 64)
        w64, t64 = fg.quantize_blockwise(torch.ones((64, 64), device=cuda), 64)
        fg.fp8_gemm_tilewise(x64, s64, w64, t64, tile=64)
    with pytest.raises(ValueError, match="out_dtype"):
        fg.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="fp8 codes"):
        fg.fp8_gemm_tilewise(xq.float(), sx, wq, sw)
    xq, sx, wq, sw = _fp8_operands(cuda, 256, 256, 128, e=2)
    gs = torch.tensor([100, 156], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs.long())
    with pytest.raises(RuntimeError, match="CUDA error"):  # e5m2 weights: no kernel
        fgr.fp8_grouped_gemm(xq, sx, wq.float().to(torch.float8_e5m2), sw, gs)
