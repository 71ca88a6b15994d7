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
                                                  flash_attention_plain, flash_bwd,
                                                  flash_bwd_plain, fold_sinks, fwd_key_tile,
                                                  fwd_tile_plan, fwd_tiles_walked, group_sum,
                                                  max_free_launches, reset_launches)
from xtuner_tpu_torch.ops.attention.paged_decode import (_sm_count, max_window_blocks,
                                                         paged_decode_attn,
                                                         paged_decode_attn_plain,
                                                         paged_decode_split_plain,
                                                         paged_decode_split_plan)
from xtuner_tpu_torch.ops.bf16_grouped import (bf16_grouped_linear, grouped_gemm_bf16,
                                               grouped_gemm_bf16_dw, grouped_gemm_dw_plain,
                                               grouped_gemm_plain, grouped_plan_counts,
                                               grouped_tiles_walked)
from xtuner_tpu_torch.ops.bf16_grouped import reset_launches as reset_grouped

pytestmark = pytest.mark.cuda

# flash: the kernel rounds P to bf16 before the PV product (as the TPU
# kernel does) and the output to bf16; the plain version does neither
FLASH_OUT_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3  # both sum exactly-representable bf16 products in f32
# paged decode: both read the same bf16 values and compute in f32; only the
# summation order and exp2 vs exp differ
PAGED_ATOL = 2e-4
# flash backward: the kernel rounds p and ds to bf16 before the tensor-core
# products and the results to bf16; the plain versions do neither. Errors
# scale with the gradient, so the bound is relative to its largest entry.
# dq is summed over k tiles by atomics in an order that changes from run to
# run, so two launches agree within the same bound, not bit for bit.
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


def _packed(dev, b, l, hq, hkv, docs, pad, seed=0, d=128, dv=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, l, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, l, hkv, dv), generator=g, device=dev).bfloat16()
    seg = torch.zeros((b, l), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(1, l - pad), docs - 1, replace=False)) \
            if docs > 1 else []
        bounds = [0, *list(cuts), l - pad]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


def _with_lens(seg, lens):
    """Explicit document lengths from position 0 in every row, the rest padding."""
    seg.zero_()
    bounds = np.cumsum([0, *lens])
    for si in range(len(lens)):
        seg[:, bounds[si]:bounds[si + 1]] = si + 1
    return seg


def _check_flash(out, lse, ref_out, ref_lse, seg):
    valid = seg != 0
    assert torch.isfinite(out.float()).all()
    assert (out[valid].float() - ref_out[valid].float()).abs().max().item() <= FLASH_OUT_ATOL
    lse_valid = lse.transpose(1, 2)[valid]
    ref_valid = ref_lse.transpose(1, 2)[valid]
    assert (lse_valid - ref_valid).abs().max().item() <= FLASH_LSE_ATOL
    assert (out[~valid] == 0).all()
    assert (lse.transpose(1, 2)[~valid] == torch.tensor(BIG_LSE, dtype=torch.float32)).all()


@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", [
    (1, 1024, 32, 8, 1, 24, None),   # the slice's prefill: 1000 tokens in a 1024 bucket
    (2, 1024, 16, 8, 6, 40, None),   # moe_heavy's heads: B2, 16/8 (group 2)
    (2, 200, 4, 2, 3, 7, None),      # packed documents, ragged tile edge
    (1, 64, 4, 4, 1, 0, None),       # one tile, no GQA
    (1, 77, 8, 2, 2, 60, None),      # mostly padding
    (1, 8192, 32, 4, 5, 250, None),  # Qwen3-30B-A3B's train step: 5 documents, GQA 8
    (1, 700, 8, 2, 0, 0, [5, 100, 17, 60, 1, 127, 300]),  # documents shorter than a tile
    (2, 640, 8, 4, 0, 0, [256, 128, 128]),  # boundaries on tile edges, a padding tile
    (1, 129, 4, 2, 0, 0, [129]),     # the last q and k tile hold one row
    (1, 65, 4, 1, 0, 0, [40, 25]),   # L < 64: q and k tiles past L
])
def test_flash_kernel_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens):
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, max(docs, 1), pad)
    if lens is not None:
        seg = _with_lens(seg, lens)
    reset_launches()
    out, lse = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and max_free_launches() == 0
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 128 ** -0.5)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    # the kernel walks the tiles its plan says, once per q head
    walk, full = fwd_tile_plan(seg)
    assert fwd_tiles_walked() == (int(walk.sum()) * hq, int(full.sum()) * hq)


@pytest.mark.parametrize("b,l,hq,hkv,lens", [
    (1, 1024, 8, 2, [1000]),
    (2, 600, 4, 4, [37, 300, 200]),
])
def test_flash_running_max_beyond_the_max_free_bound(cuda, b, l, hq, hkv, lens):
    """Scaled logits up to ~80 (q times 16): exp2 of the raw logits would
    overflow f32 in a row's sum, so only the running max keeps them finite;
    the running-max variant (no bound given, or one above 45) must still
    agree with the plain version."""
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, 1, 0)
    seg = _with_lens(seg, lens)
    q = (q.float() * 16).bfloat16()
    scale = 128 ** -0.5
    logits = torch.einsum("blhd,bmgd->bhlm", q.float(), k.float()[:, :, :1]) * scale
    assert logits.abs().max().item() > 60
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, scale)
    for bound in (None, torch.tensor(90.0, device=cuda)):
        reset_launches()
        out, lse = flash_attention(q, k, v, seg, max_logit=bound)
        torch.cuda.synchronize()
        assert max_free_launches() == 0
        _check_flash(out, lse, ref_out, ref_lse, seg)


def test_flash_forward_two_launches_agree_bitwise(cuda):
    """No atomics touch out or lse: two launches give the same bits."""
    q, k, v, seg = _packed(cuda, 2, 2048, 16, 8, 3, 50)
    for bound in (None, torch.tensor(11.3, device=cuda)):
        a = flash_attention(q, k, v, seg, max_logit=bound)
        b = flash_attention(q, k, v, seg, max_logit=bound)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _paged(dev, b, c, hq, hkv, bs, lens, seed=0, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    mb = -(-(max(lens) + c) // bs)
    nb = b * mb + 1
    pk = torch.randn((2, nb, bs, hkv, d), generator=g, device=dev).bfloat16()
    pv = torch.randn((2, nb, bs, hkv, d), generator=g, device=dev).bfloat16()
    q = torch.randn((b, c, hq, d), generator=g, device=dev).bfloat16()
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
    (4, 1, 8, 2, 16, [31, 1, 0, 47]),          # seq_len + C on a block edge, one token
    (2, 2, 8, 2, 32, [30, 1]),                 # C = 2 ending on an edge
    (2, 1, 32, 8, 256, [700, 255]),            # blocks of 256: four 64-row chunks
    (2, 1, 8, 2, 48, [100, 47]),               # 48-row chunks
    (32, 1, 32, 8, 128, [4096] * 32),          # a rollout: 32 slots x 4096 cached
])
def test_paged_decode_kernel_matches_plain(cuda, b, c, hq, hkv, bs, lens):
    q, pk, pv, table, seq_lens = _paged(cuda, b, c, hq, hkv, bs, lens)
    n0 = paged_decode_attn.launches
    out = paged_decode_attn(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    again = paged_decode_attn(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert paged_decode_attn.launches == n0 + 2
    assert torch.equal(out, again)  # the splits merge in a fixed order
    ref = paged_decode_attn_plain(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= PAGED_ATOL


def test_paged_decode_kernel_skips_pad_and_unused_entries(cuda):
    """Slots past seq_len + C hold NaN (never written) and table entries < 0
    or >= NB name no block: the kernel reads neither, as its work order in
    plain torch (`paged_decode_split_plain`, the plan's split count) does."""
    b, c, hq, hkv, bs, lens = 3, 1, 8, 2, 16, [37, 70, 20]
    q, pk, pv, table, seq_lens = _paged(cuda, b, c, hq, hkv, bs, lens)
    clean_k, clean_v = pk.clone(), pv.clone()
    nb = pk.shape[1]
    for bi, n in enumerate(lens):
        t, s = divmod(n + c, bs)
        if s:
            pk[1, table[bi, t], s:] = float("nan")
            pv[1, table[bi, t], s:] = float("nan")
    ref = paged_decode_attn_plain(q, clean_k, clean_v, 1, table, seq_lens, scale=128 ** -0.5)
    out = paged_decode_attn(q, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out - ref).abs().max().item() <= PAGED_ATOL
    table[1, 1], table[1, 3] = -1, nb
    splits = paged_decode_split_plan(b, hkv, table.shape[1], _sm_count(cuda.index or 0))
    out = paged_decode_attn(q, clean_k, clean_v, 1, table, seq_lens, scale=128 ** -0.5)
    ref = paged_decode_split_plain(q, clean_k, clean_v, 1, table, seq_lens,
                                   scale=128 ** -0.5, splits=splits)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out - ref).abs().max().item() <= PAGED_ATOL


def test_paged_decode_kernel_on_two_streams(cuda):
    """Launches on two streams at once each merge their own splits: the
    merge tickets are one buffer per stream."""
    b, hkv = 32, 8
    q, pk, pv, table, seq_lens = _paged(cuda, b, 1, 32, hkv, 128, [4096] * b)
    q2 = q.flip(0).contiguous()
    want = [paged_decode_attn(x, pk, pv, 1, table, seq_lens, scale=128 ** -0.5)
            for x in (q, q2)]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for s, x, acc in zip(streams, (q, q2), got):
            with torch.cuda.stream(s):
                acc.append(paged_decode_attn(x, pk, pv, 1, table, seq_lens, scale=128 ** -0.5))
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        assert all(torch.equal(w, o) for o in outs)


# gpt-oss's attention: head dim 64 for q, k and v, 64 q heads over 8 kv
# heads, a window of 128 on even layers and full attention on odd ones,
# per-head sinks (folded into out and lse after the kernel)
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", [
    (1, 1024, 64, 8, 1, 24, None),    # gpt-oss's prefill: 1000 tokens in a 1024 bucket
    (1, 4096, 64, 8, 5, 250, None),   # five documents at L4096
    (2, 640, 8, 4, 0, 0, [256, 128, 128]),  # boundaries on tile edges, a padding tile
    (1, 700, 8, 2, 0, 0, [5, 100, 17, 60, 1, 127, 300]),  # documents shorter than a tile
    (1, 65, 4, 1, 0, 0, [40, 25]),    # L < 64
    (1, 2048, 14, 2, 9, 40, None),    # Qwen2.5-0.5B's LoRA row: 14 / 2 heads, a group of 7
])
@pytest.mark.parametrize("window", [None, 128, 8, 300])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_flash_kernel_64_window_sinks_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens,
                                                    window, with_sinks):
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, max(docs, 1), pad, d=64, dv=64)
    if lens is not None:
        seg = _with_lens(seg, lens)
    sinks = torch.linspace(-2.0, 3.0, hq, device=cuda) if with_sinks else None
    reset_launches()
    out, lse = flash_attention(q, k, v, seg, window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 64 ** -0.5, window=window)
    if sinks is not None:
        ref_out, ref_lse = fold_sinks(ref_out, ref_lse, sinks)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    # tiles wholly outside the window are never walked
    walk, full = fwd_tile_plan(seg, window)
    assert fwd_tiles_walked() == (int(walk.sum()) * hq, int(full.sum()) * hq)


@pytest.mark.parametrize("b,c,hq,hkv,bs,lens,window", [
    (4, 1, 64, 8, 128, [1000, 0, 517, 1900], 128),  # gpt-oss's decode, a windowed layer
    (4, 1, 64, 8, 128, [1000, 0, 517, 1900], None),  # and a full one
    (4, 1, 64, 8, 128, [127, 128, 129, 255], 128),   # the window's first slot on both
                                                     # sides of a block edge
    (3, 1, 8, 2, 16, [37, 15, 63], 20),              # windows across small blocks
    (2, 2, 8, 2, 16, [31, 0], 16),                   # C = 2
    (1, 4, 8, 2, 16, [50], 5),                       # 16 rows, a window inside a block
    (32, 1, 64, 8, 128, [4096] * 32, 128),           # a rollout: 32 slots x 4096 cached
    (32, 1, 64, 8, 128, [4096] * 32, None),
])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_paged_decode_kernel_64_window_sinks_matches_plain(cuda, b, c, hq, hkv, bs, lens,
                                                          window, with_sinks):
    """Head dim 64 with the window and the sinks, against the gather plain
    version and the kernel's work order (`paged_decode_split_plain` at the
    split count the wrapper plans over the in-window blocks)."""
    q, pk, pv, table, seq_lens = _paged(cuda, b, c, hq, hkv, bs, lens, d=64)
    sinks = torch.linspace(-1.0, 2.5, hq, device=cuda) if with_sinks else None
    kw = dict(scale=64 ** -0.5, window=window, sinks=sinks)
    n0 = paged_decode_attn.launches
    out = paged_decode_attn(q, pk, pv, 1, table, seq_lens, **kw)
    again = paged_decode_attn(q, pk, pv, 1, table, seq_lens, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attn.launches == n0 + 2 and torch.equal(out, again)
    live = seq_lens > 0
    ref = paged_decode_attn_plain(q, pk, pv, 1, table, seq_lens, **kw)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out[live] - ref[live]).abs().max().item() <= PAGED_ATOL
    mb = table.shape[1]
    if window:
        mb = min(mb, max_window_blocks(window, c, bs))
    splits = paged_decode_split_plan(b, hkv, mb, _sm_count(cuda.index or 0))
    walk = paged_decode_split_plain(q, pk, pv, 1, table, seq_lens, splits=splits, **kw)
    assert (out - walk).abs().max().item() <= PAGED_ATOL


# Qwen3.5's gated full attention: head dim 256 for q, k and v, 16 q heads
# over 2 kv heads, causal, no window, no sinks; the kernel walks 64-key
# tiles (fwd_key_tile)
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", [
    (1, 1024, 16, 2, 1, 24, None),    # the serving prefill: 1000 tokens in a 1024 bucket
    (1, 4096, 16, 2, 5, 250, None),   # five documents at L4096
    (2, 640, 8, 4, 0, 0, [256, 128, 128]),  # boundaries on tile edges, a padding tile
    (1, 700, 8, 2, 0, 0, [5, 100, 17, 60, 1, 127, 300]),  # documents shorter than a tile
    (1, 129, 4, 2, 0, 0, [129]),      # the last q tile holds one row
    (1, 65, 4, 1, 0, 0, [40, 25]),    # L < 128: one q tile, its second half past L
])
@pytest.mark.parametrize("bound", [None, 45.0])
def test_flash_kernel_256_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens, bound):
    """Both variants at (256, 256) (random q and k of unit scale keep every
    scaled logit far below 45, so the max-free variant is exact), against
    the plain version; the kernel walks the 64-key tiles of its plan."""
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, max(docs, 1), pad, d=256, dv=256)
    if lens is not None:
        seg = _with_lens(seg, lens)
    reset_launches()
    max_logit = None if bound is None else torch.tensor(bound, device=cuda)
    out, lse = flash_attention(q, k, v, seg, max_logit=max_logit)
    again, lse2 = flash_attention(q, k, v, seg, max_logit=max_logit)
    torch.cuda.synchronize()
    assert flash_attention.launches == 2 and max_free_launches() == 2 * (bound is not None)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 256 ** -0.5,
                                             max_free=bound is not None)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    walk, full = fwd_tile_plan(seg, key_tile=fwd_key_tile(256, 256))
    assert fwd_tiles_walked() == (2 * int(walk.sum()) * hq, 2 * int(full.sum()) * hq)


def test_flash_256_running_max_beyond_the_max_free_bound(cuda):
    """Scaled logits past 60 at (256, 256): the running-max variant stays
    finite and agrees with the plain version."""
    q, k, v, seg = _packed(cuda, 1, 1024, 8, 2, 1, 0, d=256, dv=256)
    seg = _with_lens(seg, [1000])
    q = (q.float() * 16).bfloat16()
    scale = 256 ** -0.5
    logits = torch.einsum("blhd,bmgd->bhlm", q.float(), k.float()[:, :, :1]) * scale
    assert logits.abs().max().item() > 60
    reset_launches()
    out, lse = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert max_free_launches() == 0
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, scale)
    _check_flash(out, lse, ref_out, ref_lse, seg)


@pytest.mark.parametrize("b,c,hq,hkv,bs,lens", [
    (4, 1, 16, 2, 128, [1000, 0, 517, 1900]),  # Qwen3.5's decode, one inactive slot
    (32, 1, 16, 2, 128, [4096] * 32),          # a rollout: 32 slots x 4096 cached
    (3, 1, 8, 2, 16, [37, 15, 63]),            # block edges
    (2, 2, 8, 2, 16, [31, 0]),                 # C = 2: 8 query rows per CTA
    (4, 1, 16, 2, 128, [127, 128, 1, 255]),    # seq_len + 1 on and off block edges
])
def test_paged_decode_kernel_256_matches_plain(cuda, b, c, hq, hkv, bs, lens):
    """Head dim 256 (one CTA an SM: O and Q fill the register file), against
    the gather plain version and the kernel's work order at the split count
    the wrapper plans; two launches give the same bits."""
    q, pk, pv, table, seq_lens = _paged(cuda, b, c, hq, hkv, bs, lens, d=256)
    kw = dict(scale=256 ** -0.5)
    n0 = paged_decode_attn.launches
    out = paged_decode_attn(q, pk, pv, 1, table, seq_lens, **kw)
    again = paged_decode_attn(q, pk, pv, 1, table, seq_lens, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attn.launches == n0 + 2 and torch.equal(out, again)
    live = seq_lens > 0
    ref = paged_decode_attn_plain(q, pk, pv, 1, table, seq_lens, **kw)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out[live] - ref[live]).abs().max().item() <= PAGED_ATOL
    splits = paged_decode_split_plan(b, hkv, table.shape[1], _sm_count(cuda.index or 0))
    walk = paged_decode_split_plain(q, pk, pv, 1, table, seq_lens, splits=splits, **kw)
    assert (out - walk).abs().max().item() <= PAGED_ATOL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, seg = _packed(cuda, 1, 64, 4, 2, 1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), seg)
    with pytest.raises(ValueError, match="head_dim"):  # (32, 32): no kernel
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), seg)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg)
    with pytest.raises(ValueError, match="head_dim"):  # (128, 64): no kernel
        flash_attention(q, k, v[..., :64].contiguous(), seg)
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
    _check_flash(out, lse, ref_out, ref_lse, seg)


def _bwd_inputs(dev, b, l, hq, hkv, docs, pad, seed=0, lens=None, d=128, dv=128,
                window=None, sinks=None, causal=True):
    q, k, v, seg = _packed(dev, b, l, hq, hkv, docs, pad, seed, d, dv)
    if lens is not None:
        seg = _with_lens(seg, lens)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn((b, l, hq, dv), generator=g, device=dev).bfloat16()
    scale = d ** -0.5
    out, lse = flash_attention_plain(q, k, v, seg, scale, window=window, causal=causal)
    if sinks is not None:  # the backward's lse and out carry the sinks
        out, lse = fold_sinks(out, lse, sinks)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, seg, lse, delta, do, scale


BWD_SHAPES = [
    # b, l, hq, hkv, docs, pad, lens
    (1, 8192, 32, 4, 5, 250, None),   # Qwen3-30B-A3B's train step: GQA 8
    (2, 8192, 16, 8, 4, 120, None),   # moe_heavy's sft step: B2, 16/8 (group 2)
    (1, 512, 8, 2, 3, 40, None),      # packed documents, padded tail, GQA 4
    (2, 200, 4, 2, 2, 7, None),       # L not a multiple of 128 (nor of 64), GQA 2
    (1, 300, 4, 4, 2, 0, [30, 20, 50]),  # documents shorter than a q tile; k tiles
                                         # 1 and 2 are padding only; no GQA
    (1, 77, 8, 1, 2, 60, None),       # mostly padding, one kv head (GQA 8)
    (1, 64, 4, 4, 1, 0, None),        # one tile, no GQA
]


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", BWD_SHAPES)
def test_flash_backward_kernels_match_plain(cuda, b, l, hq, hkv, docs, pad, lens, two_pass):
    """The one-pass backward (dq with grouped dk/dv, or with per-q-head
    dk_h/dv_h) against its plain version; padding rows exactly zero."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, hq, hkv, docs, pad,
                                                      lens=lens)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": int(not two_pass), "two_pass": int(two_pass)}
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass)
    for t, w, like in zip(got, want, (q, q if two_pass else k, q if two_pass else v)):
        assert t.shape == like.shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_backward_two_launches_agree(cuda):
    """dq's atomics sum in another order on each launch: two launches agree
    within the tolerance; dk and dv are summed in a fixed order."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 2, 2048, 16, 8, 3, 50)
    for two_pass in (False, True):
        a = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
        b = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
        assert _rel_err(a[0], b[0]) <= FLASH_GRAD_RTOL
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# MLA's head dims, q/k 192 and v 128 (DeepSeek-V3): the forward is the
# 128/128 kernel's template at (192, 128); the backward is a dq kernel and a
# dk/dv kernel, each output written once. Same tolerances as at 128/128: the
# kernels round P and dS to bf16 where the plain versions keep f32
MLA_SHAPES = [
    # b, l, h (q and kv heads), docs, pad, lens
    (1, 1024, 8, 3, 40, None),        # packed documents, padded tail
    (2, 200, 4, 2, 7, None),          # L not a multiple of 128 (nor of 64)
    (1, 300, 4, 2, 0, [30, 20, 50]),  # documents shorter than a tile, padding tiles
    (1, 77, 8, 2, 60, None),          # mostly padding
    (1, 65, 4, 0, 0, [40, 25]),       # L < 128: tiles past L
    (1, 4096, 16, 4, 100, None),      # 16 heads, 4 documents
]


@pytest.mark.parametrize("b,l,h,docs,pad,lens", MLA_SHAPES)
def test_flash_mla_forward_matches_plain(cuda, b, l, h, docs, pad, lens):
    q, k, v, seg = _packed(cuda, b, l, h, h, max(docs, 1), pad, d=192, dv=128)
    if lens is not None:
        seg = _with_lens(seg, lens)
    reset_launches()
    out, lse = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1 and out.shape == (b, l, h, 128)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 192 ** -0.5)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    walk, full = fwd_tile_plan(seg)
    assert fwd_tiles_walked() == (int(walk.sum()) * h, int(full.sum()) * h)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("b,l,h,docs,pad,lens", MLA_SHAPES + [(1, 512, 8, 3, 40, None)])
def test_flash_mla_backward_matches_plain(cuda, b, l, h, docs, pad, lens, two_pass):
    """dq, dk, dv at (192, 128) against the plain version, both switches
    (at one q head per kv head they compute the same thing); the last
    shape adds GQA 4 (8 q heads on 2 kv heads), which the kernels take."""
    hkv = 2 if l == 512 else h
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, h, hkv, max(docs, 1), pad,
                                                      lens=lens, d=192, dv=128)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": int(not two_pass), "two_pass": int(two_pass)}
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass)
    shapes = (q.shape, (b, l, h if two_pass else hkv, 192), (b, l, h if two_pass else hkv, 128))
    for t, w, shape in zip(got, want, shapes):
        assert t.shape == shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_mla_backward_two_launches_give_the_same_bits(cuda):
    """At (192, 128) every output is written once: dq too."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 2048, 8, 8, 3, 50,
                                                      d=192, dv=128)
    for two_pass in (False, True):
        a = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
        b = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_mla_autograd_matches_plain_autograd(cuda):
    q, k, v, seg = _packed(cuda, 1, 300, 4, 4, 3, 20, seed=3, d=192, dv=128)
    grads = []
    for fn in (lambda *a: flash_attention(*a)[0],
               lambda *a: flash_attention_plain(*a, 192 ** -0.5)[0]):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, seg).float().square().sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL


# gpt-oss's backward: the split kernels at (64, 64), with its window of
# 128, small windows, one past a document's length, and in full, from an
# lse with the sinks folded in (the kernels never see the sinks)
OSS_BWD_SHAPES = [
    # b, l, hq, hkv, docs, pad, lens
    (1, 4096, 64, 8, 5, 250, None),   # gpt-oss's heads (GQA 8), five documents
    (1, 1024, 8, 2, 3, 40, None),     # packed documents, padded tail
    (2, 200, 4, 2, 2, 7, None),       # L not a multiple of 128 (nor of 64)
    (1, 300, 4, 4, 0, 0, [30, 20, 50]),  # documents shorter than a tile, padding tiles
    (1, 700, 8, 2, 0, 0, [5, 100, 17, 60, 1, 127, 300]),  # documents shorter than a tile
    (1, 65, 4, 1, 0, 0, [40, 25]),    # L < 128: tiles past L
    (1, 2048, 14, 2, 9, 40, None),    # Qwen2.5-0.5B's LoRA row: a group of 7
    (2, 512, 14, 2, 2, 100, None),    # its reward rows: one document and padding a row
]


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("window", [None, 128, 8, 64, 300])
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", OSS_BWD_SHAPES)
def test_flash_backward_64_window_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens, window,
                                                two_pass):
    """dq, dk, dv at (64, 64) with a window against the plain version,
    both switches; padding rows exactly zero."""
    sinks = torch.linspace(-2.0, 3.0, hq, device=cuda)
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(
        cuda, b, l, hq, hkv, max(docs, 1), pad, lens=lens, d=64, dv=64, window=window,
        sinks=sinks)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, window)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": int(not two_pass), "two_pass": int(two_pass)}
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass, window)
    for t, w, like in zip(got, want, (q, q if two_pass else k, q if two_pass else v)):
        assert t.shape == like.shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_backward_64_window_two_launches_give_the_same_bits(cuda):
    """At (64, 64) every output is written once: dq too."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 2048, 16, 2, 3, 50, d=64,
                                                      dv=64, window=128)
    for two_pass in (False, True):
        a = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, 128)
        b = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, 128)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("window", [128, None])
def test_flash_64_window_sinks_autograd_matches_plain_autograd(cuda, window):
    """Autograd through the kernels with the window and the sinks as a leaf
    against the plain forward, fold and autograd."""
    q, k, v, seg = _packed(cuda, 1, 1000, 8, 2, 3, 20, seed=5, d=64, dv=64)
    sinks = torch.linspace(-1.0, 2.0, 8, device=cuda)
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda)
    grads = []
    for fn in (lambda q_, k_, v_, s_: flash_attention(q_, k_, v_, seg, window=window,
                                                      sinks=s_)[0],
               lambda q_, k_, v_, s_: fold_sinks(*flash_attention_plain(
                   q_, k_, v_, seg, 64 ** -0.5, window=window), s_)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, sinks)]
        (fn(*leaves).float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("window", [128, 8])
def test_flash_mla_backward_with_a_window_matches_plain(cuda, window, two_pass):
    """The split kernels take a window at 192/128 too (no preset trains
    MLA with one: the model refuses it)."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 1024, 8, 2, 3, 40, d=192,
                                                      dv=128, window=window)
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, window)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass, window)
    for t, w in zip(got, want):
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_backward_one_pass_refuses_a_window(cuda):
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 256, 4, 2, 2, 10)
    with pytest.raises(ValueError, match="no sliding window"):
        flash_bwd(q, k, v, seg, lse, delta, do, scale, False, 128)


# Qwen3.5's gated full attention in training: #2-#4 at (256, 256), the dq
# kernel and the dk/dv kernel of 192/128 and 64/64 without the window terms.
# The tolerance is the backward's at 128/128 (FLASH_GRAD_RTOL): the kernels
# round p and ds to bf16 before the products, the plain versions keep f32
BWD_256_SHAPES = [
    # b, l, hq, hkv, docs, pad, lens
    (1, 4096, 16, 2, 5, 250, None),   # the recipe's heads (group 8), five documents
    (1, 512, 8, 2, 3, 40, None),      # packed documents, padded tail, GQA 4
    (2, 200, 4, 2, 2, 7, None),       # L not a multiple of 128 (nor of 64)
    (1, 300, 4, 4, 0, 0, [30, 20, 50]),  # documents shorter than a tile, padding tiles
    (1, 65, 4, 1, 0, 0, [40, 25]),    # L < 128: tiles past L, one kv head
]


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", BWD_256_SHAPES)
def test_flash_backward_256_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens, two_pass):
    """dq, dk, dv at (256, 256), grouped (#2 + #3) and two-pass (#2 + #4),
    against the plain version; padding rows exactly zero; two launches
    give the same bits (every output written once)."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, hq, hkv, max(docs, 1), pad,
                                                      lens=lens, d=256, dv=256)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
    again = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": 2 * int(not two_pass), "two_pass": 2 * two_pass}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass)
    heads = hq if two_pass else hkv
    for t, w, shape in zip(got, want, (q.shape, (b, l, heads, 256), (b, l, heads, 256))):
        assert t.shape == shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_256_autograd_matches_plain_autograd(cuda):
    """Through `flash_attention` at (256, 256) with a max-logit bound (the
    max-free forward, as zero-centred qk-norm gives it), both switches."""
    import os

    q, k, v, seg = _packed(cuda, 1, 700, 16, 2, 4, 30, seed=5, d=256, dv=256)
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda)
    for bwd in ("grouped", "two_pass"):
        os.environ["XTUNER_ATTN_BWD"] = bwd
        try:
            grads = []
            for fn in (lambda *a: flash_attention(*a, max_logit=torch.tensor(
                           20.0, device=cuda))[0],
                       lambda *a: flash_attention_plain(*a, 256 ** -0.5)[0]):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                (fn(*leaves, seg).float() * co).sum().backward()
                grads.append([t.grad for t in leaves])
        finally:
            del os.environ["XTUNER_ATTN_BWD"]
        for got, want in zip(*grads):
            assert _rel_err(got, want) <= FLASH_GRAD_RTOL


def test_flash_backward_256_refuses_a_window(cuda):
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 256, 4, 2, 2, 10, d=256,
                                                      dv=256)
    with pytest.raises(ValueError, match="no sliding window"):
        flash_bwd(q, k, v, seg, lse, delta, do, scale, False, 128)


# Qwen3-VL's vision tower: bidirectional attention within each image (a
# segment per frame), head dim 64, 16 q heads over 16 kv heads (group 1).
# #1-#4 at (64, 64) with causal=False; the tolerances are the causal ones
# (FLASH_OUT_ATOL, FLASH_LSE_ATOL, FLASH_GRAD_RTOL): the same bf16 roundings
NONCAUSAL_SHAPES = [
    # b, l, hq, hkv, docs, pad, lens
    (1, 8192, 16, 16, 0, 0, [4096, 3072, 1024]),  # the recipe's images: 1024x1024, 1024x768, 512
    (1, 4198, 16, 16, 0, 0, [1, 100, 4097]),     # segments of 1, 100 and 4097; L % 128 != 0
    (1, 2000, 16, 16, 0, 0, [1024, 256, 300]),   # a padded tail (420 patches of segment 0)
    (1, 700, 8, 2, 0, 0, [5, 100, 17, 60, 1, 127, 300]),  # short segments, GQA 4
    (2, 640, 8, 4, 0, 0, [256, 128, 128]),       # boundaries on tile edges, a padding tile
    (1, 65, 4, 1, 0, 0, [40, 25]),               # L < 128: tiles past L
]


@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", NONCAUSAL_SHAPES)
def test_flash_kernel_64_noncausal_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens):
    """#1 non-causal at (64, 64) against the plain version; the kernel walks
    the tiles `fwd_tile_plan(causal=False)` says, once per q head."""
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, 1, 0, d=64, dv=64)
    seg = _with_lens(seg, lens)
    reset_launches()
    out, lse = flash_attention(q, k, v, seg, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 64 ** -0.5, causal=False)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    walk, full = fwd_tile_plan(seg, causal=False)
    assert fwd_tiles_walked() == (int(walk.sum()) * hq, int(full.sum()) * hq)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad,lens", NONCAUSAL_SHAPES)
def test_flash_backward_64_noncausal_matches_plain(cuda, b, l, hq, hkv, docs, pad, lens,
                                                   two_pass):
    """#2 with #3 (grouped) or #4 (two-pass) non-causal at (64, 64) against
    the plain version; padding rows exactly zero; two launches give the
    same bits (every output written once)."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, hq, hkv, 1, 0, lens=lens,
                                                      d=64, dv=64, causal=False)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    again = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": 2 * int(not two_pass), "two_pass": 2 * two_pass}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    heads = hq if two_pass else hkv
    for t, w, shape in zip(got, want, (q.shape, (b, l, heads, 64), (b, l, heads, 64))):
        assert t.shape == shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_64_noncausal_autograd_matches_plain_autograd(cuda):
    """Autograd through `flash_attention(causal=False)` at (64, 64), both
    switches, against the plain forward's autograd."""
    import os

    q, k, v, seg = _packed(cuda, 1, 1500, 16, 16, 1, 0, seed=5, d=64, dv=64)
    seg = _with_lens(seg, [1024, 300, 76])
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda)
    for bwd in ("grouped", "two_pass"):
        os.environ["XTUNER_ATTN_BWD"] = bwd
        try:
            grads = []
            for fn in (lambda *a: flash_attention(*a, causal=False)[0],
                       lambda *a: flash_attention_plain(*a, 64 ** -0.5, causal=False)[0]):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                (fn(*leaves, seg).float() * co).sum().backward()
                grads.append([t.grad for t in leaves])
        finally:
            del os.environ["XTUNER_ATTN_BWD"]
        for got, want in zip(*grads):
            assert _rel_err(got, want) <= FLASH_GRAD_RTOL


# Qwen3-VL-8B's tower: 16 heads of 72, #1-#4 non-causal at (72, 72) on
# 128-column tiles (columns 72-127 zero-filled by TMA, never stored); the
# same tolerances as at 64/64 (the same bf16 roundings, sums over 72)
NONCAUSAL_72_SHAPES = [
    # b, l, hq, hkv, lens
    (1, 8192, 16, 16, [4096, 3072, 1024]),  # the 8B recipe's kind of row (three images)
    (1, 4198, 16, 16, [1, 100, 4097]),     # segments of 1, 100 and 4097; L % 128 != 0
    (1, 2000, 16, 16, [1024, 256, 300]),   # a padded tail (420 patches of segment 0)
    (1, 700, 8, 2, [5, 100, 17, 60, 1, 127, 300]),  # short segments, GQA 4
    (2, 640, 8, 4, [256, 128, 128]),       # boundaries on tile edges, a padding tile
    (1, 65, 4, 1, [40, 25]),               # L < 128: tiles past L
]


@pytest.mark.parametrize("b,l,hq,hkv,lens", NONCAUSAL_72_SHAPES)
def test_flash_kernel_72_noncausal_matches_plain(cuda, b, l, hq, hkv, lens):
    """#1 non-causal at (72, 72) against the plain version (scale 72^-0.5);
    the kernel walks the tiles `fwd_tile_plan(causal=False)` says; padding
    rows get out 0 and lse 1e30."""
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, 1, 0, d=72, dv=72)
    seg = _with_lens(seg, lens)
    reset_launches()
    out, lse = flash_attention(q, k, v, seg, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == flash_attention.noncausal_launches == 1
    assert out.shape == (b, l, hq, 72)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 72 ** -0.5, causal=False)
    _check_flash(out, lse, ref_out, ref_lse, seg)
    pad = seg == 0
    assert (out[pad] == 0).all() and (lse.transpose(1, 2)[pad] == 1e30).all()
    walk, full = fwd_tile_plan(seg, causal=False)
    assert fwd_tiles_walked() == (int(walk.sum()) * hq, int(full.sum()) * hq)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("b,l,hq,hkv,lens", NONCAUSAL_72_SHAPES)
def test_flash_backward_72_noncausal_matches_plain(cuda, b, l, hq, hkv, lens, two_pass):
    """#2 with #3 (grouped) or #4 (two-pass) non-causal at (72, 72) against
    the plain version; padding rows exactly zero; two launches give the
    same bits (a store past a head's 72 columns would land on the next
    head's and show in the error)."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, hq, hkv, 1, 0, lens=lens,
                                                      d=72, dv=72, causal=False)
    reset_launches()
    got = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    again = flash_bwd(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    torch.cuda.synchronize()
    assert flash_bwd.noncausal_launches == {"grouped": 2 * int(not two_pass),
                                            "two_pass": 2 * two_pass}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = flash_bwd_plain(q, k, v, seg, lse, delta, do, scale, two_pass, causal=False)
    heads = hq if two_pass else hkv
    for t, w, shape in zip(got, want, (q.shape, (b, l, heads, 72), (b, l, heads, 72))):
        assert t.shape == shape and t.dtype == torch.bfloat16
        assert torch.isfinite(t.float()).all()
        assert _rel_err(t, w) <= FLASH_GRAD_RTOL
        assert (t[seg == 0] == 0).all()


def test_flash_72_noncausal_autograd_matches_plain_autograd(cuda):
    """Autograd through `flash_attention(causal=False)` at (72, 72), both
    switches, against the plain forward's autograd."""
    import os

    q, k, v, seg = _packed(cuda, 1, 1500, 16, 16, 1, 0, seed=5, d=72, dv=72)
    seg = _with_lens(seg, [1024, 300, 76])
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda)
    for bwd in ("grouped", "two_pass"):
        os.environ["XTUNER_ATTN_BWD"] = bwd
        try:
            grads = []
            for fn in (lambda *a: flash_attention(*a, causal=False)[0],
                       lambda *a: flash_attention_plain(*a, 72 ** -0.5, causal=False)[0]):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                (fn(*leaves, seg).float() * co).sum().backward()
                grads.append([t.grad for t in leaves])
        finally:
            del os.environ["XTUNER_ATTN_BWD"]
        for got, want in zip(*grads):
            assert _rel_err(got, want) <= FLASH_GRAD_RTOL


def test_flash_kernel_64_noncausal_on_internvit_tiles(cuda):
    """#1 non-causal at (64, 64) on InternViT's layout: tiles of 1025
    tokens (the cls token and 32 x 32 patches) packed in one row, one
    segment per tile, 16 heads."""
    q, k, v, seg = _packed(cuda, 1, 4 * 1025, 16, 16, 1, 0, d=64, dv=64)
    seg = _with_lens(seg, [1025] * 4)
    out, lse = flash_attention(q, k, v, seg, causal=False)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, 64 ** -0.5, causal=False)
    _check_flash(out, lse, ref_out, ref_lse, seg)


def test_flash_128_on_internvl_rows_matches_plain(cuda):
    """#1 (max-free) and #2 + #3 at 128/128 on InternVL's language rows:
    8 rows of 16384, 32 q over 8 kv heads, 4-5 conversations a row and a
    padded tail; the plain versions one row and one kv head's q-head group
    at a time (an (L, L) f32 slab of 4 heads, 4.3 GB)."""
    lens = [[3900, 3400, 2800, 3100, 2900], [5100, 4000, 3300, 3500], [2759] * 5,
            [4400, 4300, 4200, 3000], [3385] * 4, [16384], [1, 100, 4097, 8000],
            [5163, 5163, 5000]]
    b, l, hq, hkv, d = 8, 16384, 32, 8, 128
    q, k, v, seg = _packed(cuda, b, l, hq, hkv, 1, 0, seed=9)
    for r, row in enumerate(lens):
        _with_lens(seg[r:r + 1], row)
    bound = torch.tensor(d ** 0.5, device=cuda)
    out, lse = flash_attention(q, k, v, seg, max_logit=bound)
    g = torch.Generator(device=cuda).manual_seed(10)
    do = torch.randn(out.shape, generator=g, device=cuda).bfloat16()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash_bwd(q, k, v, seg, lse, delta, do, d ** -0.5)
    rep = hq // hkv
    for r in range(b):
        for h in range(hkv):
            hs, rs = slice(h * rep, (h + 1) * rep), slice(r, r + 1)
            args = (q[rs, :, hs], k[rs, :, h:h + 1], v[rs, :, h:h + 1], seg[rs])
            ro, rl = flash_attention_plain(*args, d ** -0.5, max_free=True)
            _check_flash(out[rs, :, hs], lse[rs, hs], ro, rl, seg[rs])
            want = flash_bwd_plain(*args, lse[rs, hs].contiguous(),
                                   delta[rs, hs].contiguous(), do[rs, :, hs], d ** -0.5)
            # dk, dv of a group: the kernel's kv head h, the plain one's only head
            assert _rel_err(got[0][rs, :, hs], want[0]) <= FLASH_GRAD_RTOL
            assert _rel_err(got[1][rs, :, h:h + 1], want[1]) <= FLASH_GRAD_RTOL
            assert _rel_err(got[2][rs, :, h:h + 1], want[2]) <= FLASH_GRAD_RTOL


def test_flash_noncausal_refused_where_no_kernel_takes_it(cuda):
    """A non-causal call on a CUDA tensor at any pair but (64, 64), or with
    a window, raises: no fallback to the plain version."""
    q, k, v, seg = _packed(cuda, 1, 256, 4, 2, 2, 10)
    with pytest.raises(NotImplementedError, match="non-causal"):
        flash_attention(q, k, v, seg, causal=False)
    _, _, _, seg, lse, delta, do, scale = _bwd_inputs(cuda, 1, 256, 4, 2, 2, 10)
    with pytest.raises(NotImplementedError, match="non-causal"):
        flash_bwd(q, k, v, seg, lse, delta, do, scale, False, causal=False)
    q, k, v, seg = _packed(cuda, 1, 256, 4, 2, 2, 10, d=64, dv=64)
    with pytest.raises(NotImplementedError, match="window"):
        flash_attention(q, k, v, seg, causal=False, window=128)
    # (72, 72) is built non-causal only, without a window
    q, k, v, seg = _packed(cuda, 1, 256, 4, 2, 2, 10, d=72, dv=72)
    with pytest.raises(NotImplementedError, match="causal flash_attention at"):
        flash_attention(q, k, v, seg)
    with pytest.raises(NotImplementedError, match="window"):
        flash_attention(q, k, v, seg, causal=False, window=128)
    for d in (128, 192, 256):  # the pairs Queue 2 A1 keeps
        q, k, v, seg = _packed(cuda, 1, 256, 4, 2, 2, 10, d=d, dv=128 if d == 192 else d)
        with pytest.raises(NotImplementedError, match="non-causal"):
            flash_attention(q, k, v, seg, causal=False)


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


@pytest.mark.parametrize("m,k,n,sizes", [
    # the longctx row's down dgrad: output width 128 (the 128-wide tile)
    (4096, 128, 1024, [700, 0, 1500, 900, 300, 96]),
    # 128 experts, 60 of them empty, 32 rows past the last group
    (8192, 256, 384, [0] * 60 + [120] * 68),
    # an expert ending mid-chunk, one short expert, rows past the last
    (1000, 96, 224, [100, 37, 700]),
])
def test_grouped_kernels_walk_their_plan(cuda, m, k, n, sizes):
    """Each launch's CTAs walk exactly the items and contraction chunks of
    `grouped_plan_counts` (nn/nt: `grouped_tile_plan`'s tiles), and the
    results match the plain versions."""
    e = len(sizes)
    x, w, gs = _grouped(cuda, m, k, e, k, n, sizes)
    dy = torch.randn((m, n), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda).bfloat16()
    reset_grouped()
    out = grouped_gemm_bf16(x, w, gs)
    dx = grouped_gemm_bf16(dy, w, gs, transpose_rhs=True)
    dw = grouped_gemm_bf16_dw(x, dy, gs, e)
    walked = grouped_tiles_walked()
    reset_grouped()
    for kind in ("nn", "nt", "dw"):
        assert walked[kind] == grouped_plan_counts(gs, m, kind, k, n), kind
    assert _rel_err(out, grouped_gemm_plain(x, w, gs)) <= GG_RTOL
    assert _rel_err(dx, grouped_gemm_plain(dy, w, gs, transpose_rhs=True)) <= GG_RTOL
    assert _rel_err(dw, grouped_gemm_dw_plain(x, dy, gs, e)) <= DW_RTOL
    assert (out[sum(sizes):] == 0).all() and (dx[sum(sizes):] == 0).all()
    assert all((dw[i] == 0).all() for i, s in enumerate(sizes) if s == 0)


def test_grouped_kernels_ignore_rows_past_the_last_group(cuda):
    """NaN in the x and dy rows past the last group: nn/nt give exact zeros
    there and the plain results elsewhere; dW stays finite and equal to the
    plain version (the wgrad zeroes those rows of its last chunk in both
    operands: 0 * NaN would be NaN)."""
    m, k, n, sizes = 1000, 256, 384, [300, 0, 333, 200]
    e, used = len(sizes), sum(sizes)
    x, w, gs = _grouped(cuda, m, k, e, k, n, sizes)
    dy = torch.randn((m, n), generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda).bfloat16()
    x[used:] = float("nan")
    dy[used:] = float("nan")
    out = grouped_gemm_bf16(x, w, gs)
    dx = grouped_gemm_bf16(dy, w, gs, transpose_rhs=True)
    dw = grouped_gemm_bf16_dw(x, dy, gs, e)
    torch.cuda.synchronize()
    assert (out[used:] == 0).all() and (dx[used:] == 0).all()
    assert _rel_err(out[:used], grouped_gemm_plain(x, w, gs)[:used]) <= GG_RTOL
    assert _rel_err(dx[:used], grouped_gemm_plain(dy, w, gs, transpose_rhs=True)[:used]) \
        <= GG_RTOL
    assert torch.isfinite(dw).all()
    assert _rel_err(dw, grouped_gemm_dw_plain(x, dy, gs, e)) <= DW_RTOL


def test_grouped_dw_keeps_the_next_experts_rows_out(cuda):
    """Expert 0 ends mid-chunk (row 100 of a 64-row chunk walk) and expert
    1's rows are 1e3 times larger: a row of expert 1 leaking into expert
    0's last chunk would move dW[0] by ~1e6 relative to its own entries of
    ~10, far above DW_RTOL, which each expert's dW is held to on its own
    scale."""
    m, k, n, sizes = 512, 128, 256, [100, 300, 112]
    e = len(sizes)
    x, _, gs = _grouped(cuda, m, k, e, k, n, sizes)
    dy = torch.randn((m, n), generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).bfloat16()
    x[100:400] *= 1e3
    dy[100:400] *= 1e3
    dw = grouped_gemm_bf16_dw(x, dy, gs, e)
    want = grouped_gemm_dw_plain(x, dy, gs, e)
    for i in range(e):
        assert _rel_err(dw[i], want[i]) <= DW_RTOL, i


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


@pytest.mark.parametrize("n,v,hd,cotangents,w_grad", [
    (16384, 151936, 1024, "both", True),  # the moe_heavy step: 2 rows of 8192, Qwen's vocab
    # g_lse alone: dh and dw are the softmax part alone, held to their own
    # scale (with both, the label term's entries dominate dw at p ~ 1/V)
    (16384, 151936, 1024, "g_lse", True),
    (1000, 100, 128, "both", True),       # N not a multiple of 128, V < one tile
    (1000, 100, 128, "g_lab", True),
    (300, 5000, 256, "g_lab", True),      # ragged vocab tail
    (300, 5000, 256, "g_lse", True),
    (4096 + 300, 151936, 1024, "both", True),  # N = Nc + 300: the last chunk is ragged
    (65536, 151936, 1024, "g_lse", True),  # the longctx path's CE: 16 chunks
    # through autograd with w not requiring grad: no dW product, its
    # counter stays
    (4096 + 300, 151936, 1024, "both", False),
    # the Qwen3-8B QLoRA recipe's CE: one row of 8192 over an untied head of
    # H4096, frozen (no dW), and with dW for the kernel's own check
    (8192, 151936, 4096, "both", False),
    (8192, 151936, 4096, "both", True),
])
def test_fused_ce_kernels_match_plain(cuda, n, v, hd, cotangents, w_grad):
    from xtuner_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_lab = _ce_inputs(cuda, n, v, hd)
    if cotangents == "g_lab":
        g_lse = torch.zeros_like(g_lse)
    if cotangents == "g_lse":
        g_lab = torch.zeros_like(g_lab)
    chunks = len(fc.ce_chunk_plan(n, v).chunks)
    fc.reset_launches()
    reset_grouped()
    lse, lab = fc.ce_fwd(h, w, labels)
    # the per-tile statistics fold in a fixed order: two launches, one result
    lse2, lab2 = fc.ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert torch.equal(lse, lse2) and torch.equal(lab, lab2)
    ref_lse, ref_lab = fc.ce_fwd_plain(h, w, labels)
    assert (lse - ref_lse).abs().max().item() <= CE_STAT_ATOL
    assert (lab - ref_lab).abs().max().item() <= CE_STAT_ATOL
    if w_grad:
        dh = fc.ce_dh(h, w, labels, ref_lse, g_lse, g_lab)
        dw = fc.ce_dw(h, w, labels, ref_lse, g_lse, g_lab)
        # the one backward: both products from one sweep, as the directly
        # called pair gives them
        dh2, dw2 = fc.ce_bwd(h, w, labels, ref_lse, g_lse, g_lab)
        torch.cuda.synchronize()
        want = (2, 3 * chunks, 2, 2)
        assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
        assert dh.dtype == dw.dtype == torch.bfloat16 and dw.shape == w.shape
        assert _rel_err(dw, fc.ce_dw_plain(h, w, labels, ref_lse, g_lse, g_lab)) <= GG_RTOL
    else:
        hl = h.detach().clone().requires_grad_(True)
        lse_a, lab_a = fc.ce_stats_vh(hl, w, labels)
        fc.reset_launches()
        ((lse_a * g_lse).sum() + (lab_a * g_lab).sum()).backward()
        torch.cuda.synchronize()
        dh, ref_lse, want = hl.grad, lse_a.detach(), (0, chunks, 1, 0)
    assert (fc.ce_fwd.launches, fc.ce_coeff.launches, fc.ce_dh.launches,
            fc.ce_dw.launches) == want
    assert _rel_err(dh, fc.ce_dh_plain(h, w, labels, ref_lse, g_lse, g_lab)) <= GG_RTOL
    # ignored rows (label clamped to 0, zero cotangents): c is 0, so dh is
    # exactly 0
    dead = (g_lse == 0) & (g_lab == 0)
    assert dead.any() and (dh[dead] == 0).all()
    # the CE's products count nothing in the MoE layer's counters
    assert grouped_gemm_bf16.launches == {"nn": 0, "nt": 0}
    assert grouped_gemm_bf16_dw.launches == 0
    assert all(v == (0, 0, 0) for v in grouped_tiles_walked().values())


def test_fused_ce_coefficient_kernel_matches_plain(cuda):
    """One chunk's c against `ce_coeff_plain` (bf16 both: the same rounding
    of nearly the same f32 value) at a ragged row count and vocab tail,
    the pad columns exactly 0."""
    from xtuner_tpu_torch.ops import fused_ce as fc

    h, w, labels, g_lse, g_lab = _ce_inputs(cuda, 300, 5000, 256)
    lse = fc.ce_fwd_plain(h, w, labels)[0]
    v_pad = fc.ce_chunk_plan(300, 5000).v_pad
    fc.reset_launches()
    c = fc.ce_coeff(h, w, labels, lse, g_lse, g_lab, v_pad)
    torch.cuda.synchronize()
    assert fc.ce_coeff.launches == 1 and c.shape == (300, v_pad)
    assert _rel_err(c, fc.ce_coeff_plain(h, w, labels, lse, g_lse, g_lab, v_pad)) <= GG_RTOL
    assert (c[:, 5000:] == 0).all()


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
        flash_bwd(q, k, v, seg, lse, lse, q.float(), 1.0)
    with pytest.raises(ValueError, match="delta"):
        flash_bwd(q, k, v, seg, lse, lse[:, :2], q, 1.0, True)
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
    many = torch.zeros(257, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 256 experts"):
        grouped_gemm_bf16_dw(x, x, many, 257)
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
    wt = fg.k_major(wq).view(wq.dtype)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = fg.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=out_dtype)
        want = fg.fp8_gemm_tilewise_plain(xq, sx, wq, sw, out_dtype=torch.float32)
        again = fg.fp8_gemm_launch(xq, sx, wt, sw, out_dtype)  # counts its launch too
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and torch.equal(got, again)
        assert _rel_err(got, want) <= (FP8_RTOL if out_dtype == torch.bfloat16 else FP8_DW_RTOL)
    assert fg.fp8_gemm_tilewise.launches == 4


def test_fp8_gemm_kernel_takes_no_rows(cuda):
    from xtuner_tpu_torch.ops import fp8_gemm as fg

    xq, sx, wq, sw = _fp8_operands(cuda, 0, 256, 384)
    fg.reset_launches()
    wt = fg.k_major(wq).view(wq.dtype)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = fg.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=out_dtype)
        assert got.shape == (0, 384) and got.dtype == out_dtype
        assert fg.fp8_gemm_launch(xq, sx, wt, sw, out_dtype).shape == (0, 384)
    assert fg.fp8_gemm_tilewise.launches == 0


# expert starts at 0, 1, 15, 16, 17 and 127 of a 128-row tile, an empty
# first and last expert, 1-row experts, 85 rows past the last group
FP8_BOUNDARIES = [0, 1, 14, 1, 1, 110, 300, 0]


@pytest.mark.parametrize("m,k,n,sizes,a_dtype", [
    # moe_heavy's gate/up at a quarter of its rows, one expert empty
    (32768, 1024, 768, [2500, 2000, 0, 2200, 2100, 1900, 2300, 2048, 2000,
                        2200, 2150, 2050, 1950, 2100, 2068, 3200], "e4m3"),
    (32768, 768, 1024, [2048] * 16, "e5m2"),  # down's dgrad shape, e5m2 gradient
    (700, 768, 256, [300, 1, 0, 333], "e4m3"),  # 1-row expert, 66 rows past the last
    (1000, 384, 128, [0, 1000, 0, 0], "e5m2"),  # K = 384, one expert has every row
    (512, 1024, 256, FP8_BOUNDARIES, "e4m3"),   # every start offset inside a tile
    (512, 768, 384, FP8_BOUNDARIES, "e5m2"),
    (256, 256, 128, [128, 0, 128], "e4m3"),     # experts of exactly 128 aligned rows
    (100, 512, 128, [0, 37, 1, 50, 0], "e5m2"),  # M below one tile, 12 rows past the last
])
def test_fp8_grouped_gemm_kernel_matches_plain(cuda, m, k, n, sizes, a_dtype):
    """bf16 and f32 out against the plain version and the kernel's own
    order in plain torch (`fp8_grouped_tiled_plain`); two launches give the
    same bits; rows past the last group are zero; the CTAs walk
    `fp8_plan_counts`."""
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    e = len(sizes)
    xq, sx, wq, sw = _fp8_operands(cuda, m, k, n, e, a_dtype=dt[a_dtype])
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    want = fgr.fp8_grouped_gemm_plain(xq, sx, wq, sw, gs, out_dtype=torch.float32)
    tiled = fgr.fp8_grouped_tiled_plain(xq, sx, wq, sw, gs)
    fgr.reset_launches()
    got = fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)
    got32 = fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs, out_dtype=torch.float32)
    again = fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)
    walked = fgr.fp8_grouped_walked()["gg"]
    torch.cuda.synchronize()
    assert fgr.fp8_grouped_gemm.launches == 3 and got.dtype == torch.bfloat16
    assert got32.dtype == torch.float32
    assert _rel_err(got, want) <= FP8_RTOL
    assert _rel_err(got32, want) <= FP8_DW_RTOL and _rel_err(got32, tiled) <= FP8_DW_RTOL
    assert torch.equal(got, again)
    assert (got[sum(sizes):] == 0).all() and (got32[sum(sizes):] == 0).all()
    assert walked == tuple(3 * c for c in fgr.fp8_plan_counts(gs, m, "gg", k, n))


def test_fp8_grouped_gemm_ignores_rows_past_the_last_group(cuda):
    """NaN codes in the rows past the last group: exact zeros there, the
    plain results elsewhere (those rows share a tile only with zero items)."""
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    m, k, n, sizes = 700, 512, 256, [300, 0, 333]
    xq, sx, wq, sw = _fp8_operands(cuda, m, k, n, len(sizes))
    used = sum(sizes)
    xq.view(torch.uint8)[used:] = 0x7F  # e4m3 NaN
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    got = fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)
    want = fgr.fp8_grouped_gemm_plain(xq[:used], sx[:used], wq, sw, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (got[used:] == 0).all()
    assert _rel_err(got[:used], want) <= FP8_RTOL


@pytest.mark.parametrize("m,k,n,sizes,y_dtype", [
    (32768, 1024, 768, [2500, 2000, 0, 2200, 2100, 1900, 2300, 2048, 2000,
                        2200, 2150, 2050, 1950, 2100, 2068, 3200], "e4m3"),
    (32768, 768, 1024, [2048] * 16, "e5m2"),
    (640, 768, 256, [300, 1, 0, 339], "e4m3"),  # tiles straddle experts, a 1-row expert
    (1024, 384, 128, [0, 0, 1000, 0], "e5m2"),  # 24 rows past the last group
    (512, 1024, 256, FP8_BOUNDARIES, "e4m3"),   # every start offset inside a tile
    (512, 768, 384, FP8_BOUNDARIES, "e5m2"),
    (256, 256, 128, [128, 0, 128], "e4m3"),     # experts of exactly 128 aligned rows
    (128, 512, 128, [0, 37, 1, 50, 0], "e5m2"),  # 100 rows padded to one tile
])
def test_fp8_grouped_dw_kernel_matches_plain(cuda, m, k, n, sizes, y_dtype):
    """Against the plain version and the kernel's own order in plain torch
    (`fp8_dw_walk_plain`); two launches give the same bits; an empty
    expert's dW is zero; the CTAs walk `fp8_plan_counts`."""
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    dt = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
    e = len(sizes)
    g = torch.Generator(device=cuda).manual_seed(4)
    xq, sx = fgr.quantize_rowtile(torch.randn((m, k), generator=g, device=cuda))
    yq, sy = fgr.quantize_rowtile(torch.randn((m, n), generator=g, device=cuda),
                                  dtype=dt[y_dtype])
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    want = fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, gs, e)
    walk = fgr.fp8_dw_walk_plain(xq, sx, yq, sy, gs, e)
    fgr.reset_launches()
    got = fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, e)
    again = fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, e)
    walked = fgr.fp8_grouped_walked()["dw"]
    torch.cuda.synchronize()
    assert fgr.fp8_grouped_gemm_dw.launches == 2 and got.dtype == torch.float32
    assert _rel_err(got, want) <= FP8_DW_RTOL and _rel_err(got, walk) <= FP8_DW_RTOL
    assert torch.equal(got, again)
    assert all((got[i] == 0).all() for i, s_ in enumerate(sizes) if s_ == 0)
    assert walked == tuple(2 * c for c in fgr.fp8_plan_counts(gs, m, "dw", k, n))


def test_fp8_grouped_dw_masks_the_rows_outside_each_expert(cuda):
    """NaN codes in the rows past the last group, which share the last
    expert's final row tile: the kernel zeroes them before the product, so
    dW stays finite and equal to the plain version over the used rows; and
    each expert's dW, held on its own scale, sees none of its neighbours'
    rows (a 1-row expert beside two large ones)."""
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    m, k, n, sizes = 640, 256, 256, [300, 1, 250]
    e, used = len(sizes), sum(sizes)
    g = torch.Generator(device=cuda).manual_seed(5)
    xq, sx = fgr.quantize_rowtile(torch.randn((m, k), generator=g, device=cuda))
    yq, sy = fgr.quantize_rowtile(torch.randn((m, n), generator=g, device=cuda))
    want = fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, torch.tensor(
        sizes, dtype=torch.int32, device=cuda), e)
    xq.view(torch.uint8)[used:] = 0x7F  # e4m3 NaN
    yq.view(torch.uint8)[used:] = 0x7F
    got = fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy,
                                  torch.tensor(sizes, dtype=torch.int32, device=cuda), e)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for i in range(e):
        assert _rel_err(got[i], want[i]) <= FP8_DW_RTOL, i


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
    # the launch functions, on operands in the kernel's layout
    wt = fg.k_major(wq).view(wq.dtype)
    with pytest.raises(ValueError, match="contiguous"):
        fgr.fp8_grouped_gemm_launch(xq, sx, wt.transpose(1, 2).contiguous().transpose(1, 2),
                                    sw, gs)
    with pytest.raises(ValueError, match="group_sizes on"):
        fgr.fp8_grouped_gemm_launch(xq, sx, wt, sw, gs.cpu())
    with pytest.raises(ValueError, match="fp8 codes"):
        fgr.fp8_grouped_gemm_launch(xq, sx.double(), wt, sw, gs)
    with pytest.raises(ValueError, match="do not fit"):
        fgr.fp8_grouped_gemm_launch(xq, sx, wt[:, :, :128].contiguous(), sw, gs)
    xt = torch.zeros((2, 256, 128), dtype=torch.float8_e4m3fn, device=cuda)
    st = torch.ones((2, 1), device=cuda)
    with pytest.raises(ValueError, match="on one device"):
        fgr.fp8_grouped_dw_launch(xt, st, xt.cpu(), st, gs, 2)
    with pytest.raises(ValueError, match="do not fit"):
        fgr.fp8_grouped_dw_launch(xt, st, xt[:1], st, gs, 2)


# ---------------------------------------------------------------- block-sparse
# block-sparse attention (#14, #15): the kernels round p (and ds) to bf16
# before the tensor-core products and the outputs to bf16, as flash does,
# so out, lse and the gradients take flash's bounds; the per-slot mass is
# a ratio of f32 sums of unrounded p, off by the scores' summation order
BS_MASS_ATOL = 1e-3


def _block_sparse(dev, b, l, hq, hkv, d, dv, block, s, docs, pad, hot=False, seed=0,
                  visible_only=False):
    """bf16 q, k, v, packed documents with a padded tail, and a selection
    from random block-max scores through `select_from_blockmax` (early
    q-blocks have fewer causal blocks than S: leading -1 slots); with `hot`
    every q-block also chooses key block 0; with `visible_only` a q-block
    chooses only blocks that share a document with it (the indexer's
    block maxima are -inf elsewhere), as the GLM-5.2 recipe's rows do."""
    from xtuner_tpu_torch.ops.attention.block_sparse import select_from_blockmax

    seg = _packed(dev, b, l, hq, hkv, docs, pad, seed)[3]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn((b, l, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, l, hkv, dv), generator=g, device=dev).bfloat16()
    nb = l // block
    blockmax = torch.randn((b, nb, nb), generator=g, device=dev)
    if hot:
        blockmax[..., 0] = 1e4
    if visible_only:
        docs_in = torch.nn.functional.one_hot(seg.long(), int(seg.max()) + 1)[..., 1:]
        present = docs_in.reshape(b, nb, block, -1).amax(dim=2).float()
        blockmax = blockmax.masked_fill((present @ present.transpose(1, 2)) == 0, float("-inf"))
    return q, k, v, seg, select_from_blockmax(blockmax, s)


@pytest.mark.parametrize("b,l,hq,hkv,d,dv,block,s,docs,pad,hot", [
    (1, 1024, 4, 4, 256, 256, 256, 2, 3, 100, False),  # GLM-5.2's dims, its block
    (1, 1024, 4, 2, 256, 256, 64, 4, 4, 37, True),     # Hq = 2 Hkv; block 0 chosen by all
    (1, 768, 4, 2, 192, 128, 64, 5, 2, 64, False),     # DeepSeek's 192/128
    (2, 512, 2, 2, 128, 128, 64, 3, 3, 10, False),     # B2, 128/128
    (1, 512, 2, 1, 128, 128, 128, 4, 1, 300, True),    # mostly padding, one kv head
    # the GLM-5.2 recipe's shape of selection: 256/256, block 256, S 8, ~40
    # short documents, so each q-block sees 1-2 blocks (visible ones only)
    (1, 4096, 4, 4, 256, 256, 256, 8, 40, 50, None),
    # block 64: the two 64-row halves of every 128-row CTA in different
    # q-blocks with different selections
    (1, 1024, 4, 2, 128, 128, 64, 3, 2, 0, False),
    # block 192: the halves of every other CTA in different q-blocks
    (1, 768, 2, 2, 192, 128, 192, 2, 3, 40, False),
    # L = 9 x 64: the last 128-row CTA's second half lies past L
    (1, 576, 4, 2, 192, 128, 192, 3, 3, 30, True),
])
def test_block_sparse_kernels_match_plain(cuda, b, l, hq, hkv, d, dv, block, s, docs, pad,
                                          hot):
    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    q, k, v, seg, idx = _block_sparse(cuda, b, l, hq, hkv, d, dv, block, s, docs, pad,
                                      bool(hot), visible_only=hot is None)
    assert (idx[:, 0, :-1] == -1).all()  # the first q-block has one causal block
    if block == 64:  # some CTA's halves chose differently
        assert (idx[:, 0::2] != idx[:, 1::2]).any()
    scale = d ** -0.5
    bs.reset_launches()
    out, lse, mass = bs.block_sparse_fwd(q, k, v, idx, seg, scale, block)
    ref_out, ref_lse, ref_mass = bs.block_sparse_fwd_plain(q, k, v, idx, seg, scale, block)
    torch.cuda.synchronize()
    valid = seg != 0
    assert (out[valid].float() - ref_out[valid].float()).abs().max().item() <= FLASH_OUT_ATOL
    lse_t, ref_t = lse.transpose(1, 2), ref_lse.transpose(1, 2)
    assert (lse_t[valid] - ref_t[valid]).abs().max().item() <= FLASH_LSE_ATOL
    assert (mass[valid] - ref_mass[valid]).abs().max().item() <= BS_MASS_ATOL
    assert (out[~valid] == 0).all() and (mass[~valid] == 0).all()
    assert (lse_t[~valid] == BIG_LSE).all()
    do = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).bfloat16()
    grads = bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale, block)
    refs = bs.block_sparse_bwd_plain(q, k, v, idx, seg, out, lse, do, scale, block)
    torch.cuda.synchronize()
    assert (bs.block_sparse_fwd.launches, bs.block_sparse_bwd.launches) == (1, 1)
    for got, want in zip(grads, refs):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL
    assert (grads[0][~valid] == 0).all() and (grads[1][~valid] == 0).all()
    # deterministic: no atomics
    again = bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale, block)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    again = bs.block_sparse_fwd(q, k, v, idx, seg, scale, block)
    assert all(torch.equal(a, b_) for a, b_ in zip((out, lse, mass), again))


def test_block_sparse_autograd_matches_plain_autograd(cuda):
    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    q, k, v, seg, idx = _block_sparse(cuda, 1, 512, 4, 2, 256, 256, 128, 2, 3, 20, seed=3)
    co = torch.randn((1, 512, 4, 256), generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda)
    grads = []
    for on_card in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if on_card:
            out = bs.block_sparse_attention(*leaves, idx, seg, block=128)
        else:  # autograd through the plain forward
            out = _plain_bs_autograd(*leaves, idx, seg, 256 ** -0.5, 128)
        (out.float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL


def _plain_bs_autograd(q, k, v, idx, seg, scale, block):
    """The block-sparse forward as a dense masked softmax in f32 that
    autograd differentiates (q, k, v (B, L, H, D), one kv head per q head
    group)."""
    from xtuner_tpu_torch.ops.attention.block_sparse import _visible

    b, l, hq, d = q.shape
    ratio = hq // k.shape[2]
    nq = l // block
    mask_g, kpos = _visible(idx, seg, block, True)  # (B, nq, block, S*block)
    # an empty slot gathers block 0 again (masked): accumulate, then test > 0
    allow = torch.zeros((b, l, l), dtype=torch.int32, device=q.device)
    bi = torch.arange(b, device=q.device)[:, None, None, None]
    rows = torch.arange(l, device=q.device).reshape(1, nq, block, 1)
    allow.index_put_((bi, rows, kpos[:, :, None, :]), mask_g.int(), accumulate=True)
    allow = allow > 0
    kk = k.float().repeat_interleave(ratio, dim=2)
    vv = v.float().repeat_interleave(ratio, dim=2)
    sc = torch.einsum("blhd,bmhd->bhlm", q.float(), kk) * scale
    sc = sc.masked_fill(~allow[:, None], float("-inf"))
    p = torch.softmax(sc, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhlm,bmhd->blhd", p, vv)


def test_block_sparse_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    q, k, v, seg, idx = _block_sparse(cuda, 1, 256, 2, 2, 128, 128, 64, 2, 1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        bs.block_sparse_fwd(q.float(), k.float(), v.float(), idx, seg, 0.1, 64)
    with pytest.raises(ValueError, match=r"\(D, Dv\)"):
        bs.block_sparse_fwd(q[..., :64].contiguous(), k[..., :64].contiguous(), v, idx, seg,
                            0.1, 64)
    q32, k32, v32, seg32, idx32 = _block_sparse(cuda, 1, 256, 2, 2, 128, 128, 32, 2, 1, 0)
    with pytest.raises(ValueError, match="multiple of 64"):
        bs.block_sparse_fwd(q32, k32, v32, idx32, seg32, 0.1, 32)
    with pytest.raises(ValueError, match="int32"):
        bs.block_sparse_fwd(q, k, v, idx.long(), seg, 0.1, 64)


# ---- the two-pass instantiation (#4) and the fused MoE MLP (#16)
@pytest.mark.parametrize("b,l,hq,hkv,docs,pad", [
    (1, 512, 8, 2, 3, 40),     # packed documents, padded tail, GQA 4
    (2, 1024, 16, 8, 6, 40),   # moe_heavy's heads: B2, 16/8 (group 2)
    (2, 200, 4, 2, 2, 7),      # L not a multiple of 64, GQA 2
    (1, 64, 4, 4, 1, 0),       # one tile, no GQA
    (1, 77, 8, 1, 2, 60),      # mostly padding, one kv head (GQA 8)
])
def test_flash_dkv_two_pass_kernel_matches_plain_and_grouped(cuda, b, l, hq, hkv, docs, pad):
    """The two-pass instantiation with the group sum against the grouped one."""
    q, k, v, seg, lse, delta, do, scale = _bwd_inputs(cuda, b, l, hq, hkv, docs, pad)
    reset_launches()
    dq_tp, dk_h, dv_h = flash_bwd(q, k, v, seg, lse, delta, do, scale, True)
    dq, dk, dv = flash_bwd(q, k, v, seg, lse, delta, do, scale, False)
    torch.cuda.synchronize()
    assert flash_bwd.launches == {"grouped": 1, "two_pass": 1}
    assert _rel_err(dq_tp, dq) <= FLASH_GRAD_RTOL
    assert _rel_err(group_sum(dk_h, hkv, k.dtype), dk) <= FLASH_GRAD_RTOL
    assert _rel_err(group_sum(dv_h, hkv, v.dtype), dv) <= FLASH_GRAD_RTOL


def test_flash_two_pass_autograd_matches_plain_autograd(cuda, monkeypatch):
    monkeypatch.setenv("XTUNER_ATTN_BWD", "two_pass")
    q, k, v, seg = _packed(cuda, 1, 300, 8, 2, 3, 20, seed=3)
    co = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda)
    reset_launches()
    grads = []
    for fn in (lambda *a: flash_attention(*a, max_logit=torch.tensor(11.3, device=cuda))[0],
               lambda *a: flash_attention_plain(*a, 128 ** -0.5)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, seg).float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
    assert flash_bwd.launches == {"grouped": 0, "two_pass": 1}
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= FLASH_GRAD_RTOL


def _moe_mlp(dev, m, h, f, sizes, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    e = len(sizes)
    x = torch.randn((m, h), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, h, 2 * f), generator=g, device=dev) * 0.05).bfloat16()
    w_dn = (torch.randn((e, f, h), generator=g, device=dev) * 0.05).bfloat16()
    return x, w_gu, w_dn, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("m,h,f,sizes", [
    (1000, 256, 128, [100, 0, 500, 400]),          # an empty expert, unaligned sizes
    (1001, 256, 128, [0, 1001, 0, 0]),             # odd M, one expert with all rows
    (777, 128, 768, [37, 300, 1, 400]),            # F 768 (moe_heavy), a 1-row expert
    (700, 1024, 128, [200, 0, 0, 400]),            # rows past the last group -> 0
    (4096, 1024, 768, [300, 700, 0, 1200, 500, 400, 600, 100, 296]),  # moe_heavy widths
    (1500, 384, 1536, [500, 0, 499, 1, 400]),      # F 1536, the largest F; H not a multiple of 256
    (900, 256, 64, [300, 0, 555]),                 # F 64: one half-empty gate|up chunk
])
def test_fused_moe_mlp_kernel_matches_plain(cuda, m, h, f, sizes):
    from xtuner_tpu_torch.ops import fused_moe_mlp as fm

    x, w_gu, w_dn, gs = _moe_mlp(cuda, m, h, f, sizes)
    fm.reset_launches()
    out, gu = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, gs)
    out2, gu2 = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, gs)
    torch.cuda.synchronize()
    assert fm.fused_moe_mlp_fwd.launches == 2
    assert torch.equal(out, out2) and torch.equal(gu, gu2)  # bit for bit, run to run
    # the tiles and chunks the CTAs walked: the plain plan's, per launch
    assert fm.fused_mlp_tiles_walked() == tuple(
        2 * c for c in fm.fused_mlp_plan_counts(gs, m, h, f))
    ref_out, ref_gu = fm.fused_moe_mlp_plain(x, w_gu, w_dn, gs)
    for got, want in ((out, ref_out), (gu, ref_gu)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        assert _rel_err(got, want) <= GG_RTOL
    if sum(sizes) < m:
        assert (out[sum(sizes):] == 0).all() and (gu[sum(sizes):] == 0).all()


@pytest.mark.parametrize("f", [128, 768, 1536, 64])
def test_fused_moe_mlp_autograd_matches_plain_autograd(cuda, f):
    from xtuner_tpu_torch.ops import fused_moe_mlp as fm

    x, w_gu, w_dn, gs = _moe_mlp(cuda, 1111, 256, f, [400, 0, 600, 111], seed=2)
    co = torch.randn((1111, 256), generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda)
    grads = []
    # the plain version through autograd in f32 (bf16 `out_dtype` products
    # have no derivative)
    for fn, dtype in ((fm.fused_moe_mlp, torch.bfloat16),
                      (lambda *a: fm.fused_moe_mlp_plain(*a)[0], torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (x, w_gu, w_dn)]
        (fn(*leaves, gs).float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got.shape == want.shape and _rel_err(got, want) <= GG_RTOL


def test_fused_moe_mlp_rejects_what_the_kernel_does_not_take(cuda):
    from xtuner_tpu_torch.ops import fused_moe_mlp as fm

    x, w_gu, w_dn, gs = _moe_mlp(cuda, 64, 256, 128, [30, 34])
    with pytest.raises(ValueError, match="bfloat16"):
        fm.fused_moe_mlp_fwd(x.float(), w_gu, w_dn, gs)
    with pytest.raises(ValueError, match="int32"):
        fm.fused_moe_mlp_fwd(x, w_gu, w_dn, gs.long())
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_moe_mlp_fwd(x.T.contiguous().T, w_gu, w_dn, gs)
    with pytest.raises(ValueError, match="do not fit"):
        fm.fused_moe_mlp_fwd(x, w_gu, w_dn[:, :64].contiguous(), gs)
    xs, gus, dns, gss = _moe_mlp(cuda, 64, 192, 128, [30, 34])  # H not a multiple of 128
    with pytest.raises(ValueError, match="multiple of 128"):
        fm.fused_moe_mlp_fwd(xs, gus, dns, gss)
    xs, gus, dns, gss = _moe_mlp(cuda, 64, 128, 96, [30, 34])  # F not a multiple of 64
    with pytest.raises(ValueError, match="multiple of 64"):
        fm.fused_moe_mlp_fwd(xs, gus, dns, gss)
    xs, gus, dns, gss = _moe_mlp(cuda, 64, 128, 1600, [30, 34])  # F past the kernel's limit
    with pytest.raises(ValueError, match="at most"):
        fm.fused_moe_mlp_fwd(xs, gus, dns, gss)


# per-token logprobs: both modes read the same bf16 hidden and head; the
# chunk mode's logits are f32 sums of bf16 products, the fused mode's (#8)
# the same sums in another order, so logprobs agree within the CE
# statistics' bound; the gradients round the coefficient and the results
# to bf16 in #9/#10 (the grouped GEMMs' bound, relative to the largest entry)
LOGPROB_ATOL = 2 * CE_STAT_ATOL


@pytest.mark.parametrize("b,l,hd,v", [
    (2, 2048, 2560, 151936),  # Qwen3-4B's width and tied vocab, 4096 rows
    (3, 300, 256, 5000),      # N not a multiple of 128, a ragged vocab tail
])
def test_per_token_logprobs_fused_matches_chunk(cuda, b, l, hd, v):
    """`per_token_logprobs(mode="fused")` (#8-#10) against the chunk mode on
    the same tied head (`embed.T`, a view), values and both gradients, with
    ignored labels; the fused run launches #8 once and the backward's
    coefficient kernel once per row chunk."""
    from xtuner_tpu_torch.loss.ce_loss import per_token_logprobs
    from xtuner_tpu_torch.ops import fused_ce as fc

    g = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn((b, l, hd), generator=g, device=cuda).bfloat16()
    emb = (torch.randn((v, hd), generator=g, device=cuda) * 0.02).bfloat16()
    labels = torch.randint(0, v, (b, l), generator=g, device=cuda, dtype=torch.int32)
    labels[:, :7] = -100
    cot = torch.randn((b, l), generator=g, device=cuda)
    out = {}
    for mode in ("chunk", "fused"):
        hl, el = h.clone().requires_grad_(True), emb.clone().requires_grad_(True)
        fc.reset_launches()
        lp = per_token_logprobs(hl, el.T, labels, 1024, mode=mode)
        (lp * cot).sum().backward()
        torch.cuda.synchronize()
        out[mode] = (lp.detach(), hl.grad, el.grad,
                     (fc.ce_fwd.launches, fc.ce_coeff.launches))
    (lp_c, dh_c, de_c, n_c), (lp_f, dh_f, de_f, n_f) = out["chunk"], out["fused"]
    assert n_c == (0, 0) and n_f == (1, len(fc.ce_chunk_plan(b * l, v).chunks))
    assert torch.isfinite(lp_f).all() and (lp_f[:, :7] == 0).all()
    assert (lp_f - lp_c).abs().max().item() <= LOGPROB_ATOL
    assert _rel_err(dh_f, dh_c) <= GG_RTOL
    assert _rel_err(de_f, de_c) <= GG_RTOL


# one generate step: the prefill through #1 and the decode step's plain
# cached attention in bf16 on the card, against the same step in f32 on the
# CPU (the plain flash); logits relative to their largest entry
GEN_STEP_RTOL = 3e-2


def test_generate_step_matches_plain(cuda):
    """`_forward_cached` as `generate` runs it on a tiny Qwen3 (2 layers,
    4 / 2 heads of 128, qk-norm): a left-padded prefill (#1, one launch per
    layer, segment ids from the pad mask) and one decode step over the
    dense cache, on the card against the CPU's plain path on the same
    weights; then `generate` itself, greedy, gives the CPU's first token."""
    from xtuner_tpu_torch.model.generate import (GenerateConfig, _forward_cached,
                                                 compute_copy, generate, init_cache)
    from xtuner_tpu_torch.model.qwen import _qwen3_dense
    from xtuner_tpu_torch.module.params import init_params

    cfg = _qwen3_dense(256, 512, 2, 4, 2, vocab=512, tie=True)
    model = cfg.build()
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    p, n_pad = 64, 9
    rng = np.random.default_rng(0)
    ids = torch.full((2, p), 7, dtype=torch.int64)
    ids[0, n_pad:] = torch.as_tensor(rng.integers(0, 512, p - n_pad))
    ids[1] = torch.as_tensor(rng.integers(0, 512, p))
    mask = ids != 7
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    kv = torch.cat([mask, torch.zeros((2, 4), dtype=torch.bool)], dim=1)
    nxt = torch.as_tensor(rng.integers(0, 512, (2, 1)))
    logits = {}
    for dev, dtype in ((cuda, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        prm = _to(compute_copy(params, dtype, copy=False), dev)
        caches = init_cache(model, 2, p + 4, dtype, dev)
        reset_launches()
        l0, caches, _ = _forward_cached(model, prm, ids.to(dev), pos.to(dev), caches, 0, dtype,
                                        kv.to(dev))
        launches = flash_attention.launches
        kv1 = kv.clone()
        kv1[:, p] = True
        l1, _, _ = _forward_cached(model, prm, nxt.to(dev), (pos[:, -1:] + 1).to(dev), caches,
                                   p, dtype, kv1.to(dev))
        logits[dev.type] = (l0[:, -1].float().cpu(), l1[:, 0].float().cpu(), launches)
    (c0, c1, n_cuda), (p0, p1, _) = logits["cuda"], logits["cpu"]
    assert n_cuda == 2  # one #1 launch per layer in the prefill, none in the decode
    assert _rel_err(c0, p0) <= GEN_STEP_RTOL and _rel_err(c1, p1) <= GEN_STEP_RTOL
    gcfg = GenerateConfig(max_new_tokens=2, do_sample=False, eos_token_id=1)
    out = generate(model, _to(params, cuda), ids.numpy(), gcfg, pad_token_id=7,
                   return_logprobs=True)
    assert np.isfinite(out["logprobs"]).all()
    top2 = torch.topk(p0, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.05  # rows whose greedy token bf16 cannot flip
    assert (out["generated"][:, 0][clear.numpy()] == p0.argmax(-1)[clear].numpy()).all()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# first-token logprobs of one request served with chunked prefill and a
# prefix-cache hit, against the same request with both off: bf16 on the
# card, where the two schedules round at different points (the flash
# kernel's P to bf16 on a whole prompt, the plain cached attention over the
# restored prefix on the rest)
SERVE_FIRST_LP_ATOL = 5e-2


def test_chunked_prefill_and_prefix_hit_on_the_card(cuda):
    """A tiny Qwen3 (2 layers, 4 / 2 heads of 128) served on the card: a
    300-token prompt through 64-token chunks (the first on #1), then its
    repeat, which resumes from 256 cached tokens, against an engine with
    both off; the first token's logprob and top-5 logprobs agree within
    SERVE_FIRST_LP_ATOL, #1 and #5 ran."""
    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.qwen import _qwen3_dense
    from xtuner_tpu_torch.module.params import init_params

    cfg = _qwen3_dense(256, 512, 2, 4, 2, vocab=512)
    model = cfg.build()
    params = init_params(model.param_specs(), torch.Generator(device=cuda).manual_seed(0),
                         cuda, torch.bfloat16)
    prompt = np.random.default_rng(1).integers(0, 512, 300).tolist()
    outs, engs = {}, {}
    for name, kw in (("plain", dict(prefill_chunk=0, prefix_cache=False)),
                     ("served", dict(prefill_chunk=64, prefix_cache=True))):
        engs[name] = eng = PagedGenerator(model, _to(params, cuda), GenerateConfig(
            max_new_tokens=4, do_sample=False, max_length=512, top_logprobs=5, **kw),
            max_batch=2, block_size=128)
        reset_launches()
        paged_decode_attn.launches = 0
        outs[name] = eng.generate([{"prompt_ids": prompt}]) + \
            eng.generate([{"prompt_ids": prompt}])
        outs[name + "_launches"] = (flash_attention.launches, paged_decode_attn.launches)
    served = engs["served"]
    # 5 chunks (bucket 320), then one resumed chunk after 256 cached tokens
    assert served._chunked_prefills == 6 and served.prefix_cache.cached_tokens == 256
    assert outs["served_launches"][0] == 2 and outs["served_launches"][1] > 0
    for s, p in zip(outs["served"], outs["plain"]):
        assert abs(s["logprobs"][0] - p["logprobs"][0]) <= SERVE_FIRST_LP_ATOL
        np.testing.assert_allclose(s["top_logprobs"][0], p["top_logprobs"][0],
                                   atol=SERVE_FIRST_LP_ATOL)


def test_load_hf_checkpoint_into_the_card(cuda, tmp_path):
    """`load_hf_checkpoint` straight into cuda bf16 equals a CPU load cast
    to bf16, leaf for leaf (a tiny Qwen3-MoE: per-expert keys, the
    transposes, the layer stacks)."""
    from xtuner_tpu_torch.checkpoint.hf import load_hf_checkpoint, save_hf_checkpoint
    from xtuner_tpu_torch.model.moe import Qwen3MoEConfig
    from xtuner_tpu_torch.module.attention import MHAConfig
    from xtuner_tpu_torch.module.params import init_params, tree_paths

    cfg = Qwen3MoEConfig(vocab_size=512, num_hidden_layers=2, hidden_size=256,
                         intermediate_size=512, moe_intermediate_size=128,
                         n_routed_experts=8, num_experts_per_tok=2,
                         attention=MHAConfig(num_attention_heads=4, num_key_value_heads=2,
                                             head_dim=64, qk_norm=True))
    m = cfg.build()
    params = init_params(m.param_specs(), torch.Generator().manual_seed(0), "cpu")
    save_hf_checkpoint(tmp_path, params, m.hf_key_map(), cfg)
    on_card = load_hf_checkpoint(tmp_path, m.param_specs(), m.hf_key_map(), cuda,
                                 torch.bfloat16)
    on_cpu = load_hf_checkpoint(tmp_path, m.param_specs(), m.hf_key_map(), "cpu")
    for (path, a), (_, b) in zip(tree_paths(on_card), tree_paths(on_cpu)):
        assert a.device.type == "cuda" and a.dtype == torch.bfloat16, path
        assert torch.equal(a.cpu(), b.bfloat16()), path


# ---------------------------------------------------------------- QLoRA
def test_nf4_quantizer_on_the_card_matches_the_host(cuda):
    """`quantize_nf4_device` on the card gives the host quantizer's codes
    and scales bit for bit (a Qwen3-8B gate_proj-sized weight in bf16, as
    the HF load reads it, and a block of exact midpoint ties), and the
    dequantize on the card equals the CPU's."""
    from xtuner_tpu_torch.module import quant

    g = torch.Generator(device=cuda).manual_seed(3)
    w = (torch.randn((4096, 12288), generator=g, device=cuda) * 0.02).bfloat16().T
    ties = torch.tensor([-0.45999527, -0.045525018, 0.03979015, 0.20352125, 0.38931254,
                         0.6427869, 1.0], device=cuda)
    small = torch.cat([ties, torch.zeros(57, device=cuda)])
    for t in (w.float().contiguous(), small):
        codes, absmax = quant.quantize_nf4_device(t)
        want_c, want_a = quant.quantize_nf4(t.cpu().numpy())
        assert np.array_equal(codes.cpu().numpy(), want_c)
        assert np.array_equal(absmax.cpu().numpy(), want_a)
    got = quant.dequantize_nf4(codes, absmax, (64,), torch.bfloat16)
    want = quant.dequantize_nf4(codes.cpu(), absmax.cpu(), (64,), torch.bfloat16)
    assert torch.equal(got.cpu(), want)
