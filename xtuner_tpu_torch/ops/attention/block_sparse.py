"""Block-sparse flash attention over selected key blocks, the DSA kernel
(counterpart: `xtuner_tpu/ops/attention/block_sparse.py`).

`select_key_blocks` and `select_from_blockmax` pick the top-S key blocks per
q-block; `block_sparse_attention` attends each q-block to its selected
blocks only and is differentiable in q, k and v through
`_BlockSparseAttention` (JAX `_bs_attn`'s custom VJP), whose two wrappers
each launch a hand-written Hopper kernel on a CUDA tensor
(`csrc/block_sparse.cu`) or raise, and run the plain PyTorch version beside
it on a CPU tensor:

- `block_sparse_fwd` (TPU kernel #14, `_fwd_kernel`): out, lse and the
  per-slot attention mass;
- `block_sparse_bwd` (TPU kernel #15, `_bwd_kernel`): dq, dk and dv, with
  `delta = rowsum(do * out)` computed before it in plain PyTorch, as JAX
  does outside its kernel. The card computes dk and dv directly, one key
  tile at a time over the q-blocks that selected it (an inverse of
  `block_idx` built on the card), and writes each once. JAX writes one
  partial block per (q-block, slot) and scatter-adds them outside the
  kernel, a TPU workaround for aliased-input revisits; only the plain
  version keeps that form here.

Layouts are JAX's at the public function: q (B, L, Hq, D), k (B, L, Hkv, D),
v (B, L, Hkv, Dv), block_idx (B, L // block, S) int32 ascending with -1 for
an empty slot. A key is visible to a query when it lies in a selected block
of the query's q-block, in the same non-padding document, at or before it.
A row that sees no key gets out 0, lse 1e30 and mass 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import BIG_LSE, NEG_INF

# the kernels' tiles: q rows and keys per step; a selection block must be a
# multiple of it
TILE = 64
# (D, Dv) pairs the kernels are built for: GLM-5.2's 256/256, DeepSeek's
# 192/128, and 128/128
KERNEL_DIMS = ((256, 256), (192, 128), (128, 128))


def select_key_blocks(scores, block: int, num_sel: int, causal: bool = True):
    """Pool (B, L, L) token-level indexer scores (-inf masked) to blocks and
    pick the top-S key blocks per q-block -> (B, nq, S) int32, ascending,
    -1 = unused slot."""
    b, l, _ = scores.shape
    nq = nk = l // block
    pooled = scores.reshape(b, nq, block, nk, block)
    pooled = torch.where(torch.isfinite(pooled), pooled, float("-inf")).amax(dim=(2, 4))
    return select_from_blockmax(pooled, num_sel, causal=causal)


def select_from_blockmax(pooled, num_sel: int, causal: bool = True):
    """Top-S key blocks per q-block from (B, nq, nk) block-max scores ->
    (B, nq, S) int32, ascending with the -1 slots first. Ties go to the
    lower block index, as `jax.lax.top_k` breaks them."""
    from ..sparse_mla import topk_desc

    b, nq, nk = pooled.shape
    if causal:  # a q-block may only see k-blocks at or before it
        qb = torch.arange(nq, device=pooled.device)[:, None]
        kb = torch.arange(nk, device=pooled.device)[None, :]
        pooled = torch.where(kb <= qb, pooled, float("-inf"))
    s = min(num_sel, nk)
    top, idx = topk_desc(pooled, s)
    idx = torch.where(torch.isfinite(top), idx, -1)
    idx = torch.sort(idx, dim=-1).values
    if s < num_sel:
        idx = torch.nn.functional.pad(idx, (num_sel - s, 0), value=-1)
    return idx.to(torch.int32)


# ---------------------------------------------------------------- plain
def _gather_blocks(t, block_idx, block: int):
    """(B, L, H, X) -> the selected key blocks per q-block,
    (B, H, nq, S * block, X); an empty slot reads block 0 (masked)."""
    b, l, h, x = t.shape
    nq, s = block_idx.shape[1:]
    blocks = t.permute(0, 2, 1, 3).reshape(b, h, l // block, block, x)
    idx = block_idx.clamp(min=0).long().reshape(b, 1, nq * s, 1, 1)
    out = blocks.gather(2, idx.expand(b, h, nq * s, block, x))
    return out.reshape(b, h, nq, s * block, x)


def _visible(block_idx, segment_ids, block: int, causal: bool):
    """(B, nq, block, S * block) bool mask of the gathered keys, and their
    absolute positions (B, nq, S * block)."""
    b, l = segment_ids.shape
    nq, s = block_idx.shape[1:]
    dev = segment_ids.device
    off = torch.arange(block, device=dev)
    kpos = (block_idx.clamp(min=0).long()[..., None] * block + off).reshape(b, nq, s * block)
    kvalid = (block_idx >= 0)[..., None].expand(b, nq, s, block).reshape(b, nq, s * block)
    qpos = torch.arange(l, device=dev).reshape(nq, block)
    qseg = segment_ids.reshape(b, nq, block).long()
    kseg = segment_ids.long().gather(1, kpos.reshape(b, -1)).reshape(b, nq, s * block)
    mask = (kvalid[:, :, None, :] & (qseg[..., None] == kseg[:, :, None, :])
            & (qseg[..., None] != 0))
    if causal:
        mask = mask & (qpos[None, :, :, None] >= kpos[:, :, None, :])
    return mask, kpos


def _head_groups(hq: int, hkv: int):
    ratio = hq // hkv
    return [(h, h // ratio) for h in range(hq)]


def block_sparse_fwd_plain(q, k, v, block_idx, segment_ids, scale: float, block: int,
                           causal: bool = True):
    """Plain version of #14: f32 masked softmax over each q-block's gathered
    key blocks, one q head at a time. Returns out (B, L, Hq, Dv) in q.dtype,
    lse (B, Hq, L) f32 (1e30 where nothing is visible) and mass
    (B, L, Hq, S) f32, the share of each slot's keys in the row's softmax."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    nq, s = block_idx.shape[1:]
    mask, _ = _visible(block_idx, segment_ids, block, causal)
    out = torch.empty((b, l, hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    mass = torch.empty((b, l, hq, s), dtype=torch.float32, device=q.device)
    for h, g in _head_groups(hq, hkv):
        qh = q[:, :, h].float().reshape(b, nq, block, d)
        kh = _gather_blocks(k[:, :, g:g + 1], block_idx, block)[:, 0].float()
        vh = _gather_blocks(v[:, :, g:g + 1], block_idx, block)[:, 0].float()
        sc = torch.einsum("bqtd,bqkd->bqtk", qh, kh) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(sc - m)
        denom = p.sum(dim=-1, keepdim=True)
        valid = denom > 0
        p = p / denom.clamp(min=1e-37)
        out[:, :, h] = torch.einsum("bqtk,bqkd->bqtd", p, vh).reshape(b, l, dv).to(q.dtype)
        lse[:, h] = torch.where(valid, m + torch.log(denom.clamp(min=1e-37)),
                                BIG_LSE).reshape(b, l)
        mass[:, :, h] = p.reshape(b, nq, block, s, block).sum(-1).reshape(b, l, s)
    return out, lse, mass


def block_sparse_bwd_plain(q, k, v, block_idx, segment_ids, out, lse, do, scale: float,
                           block: int, causal: bool = True):
    """Plain version of #15, JAX's form: p from the saved lse; dq per q-block
    over its slots; dk and dv as one partial block per (q-block, slot),
    scatter-added into (B, L, Hkv, .) and summed over the q-head group.
    Returns dq, dk, dv in the dtypes of q, k, v."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    nq, s = block_idx.shape[1:]
    mask, kpos = _visible(block_idx, segment_ids, block, causal)
    delta = (do.float() * out.float()).sum(-1)  # (B, L, Hq)
    dq = torch.empty_like(q)
    dk = torch.zeros((b, l, hkv, d), dtype=torch.float32, device=q.device)
    dvv = torch.zeros((b, l, hkv, dv), dtype=torch.float32, device=q.device)
    flat = (torch.arange(b, device=q.device)[:, None] * l + kpos.reshape(b, -1)).reshape(-1)
    for h, g in _head_groups(hq, hkv):
        qh = q[:, :, h].float().reshape(b, nq, block, d)
        doh = do[:, :, h].float().reshape(b, nq, block, dv)
        kh = _gather_blocks(k[:, :, g:g + 1], block_idx, block)[:, 0].float()
        vh = _gather_blocks(v[:, :, g:g + 1], block_idx, block)[:, 0].float()
        sc = torch.einsum("bqtd,bqkd->bqtk", qh, kh) * scale
        p = torch.where(mask, torch.exp(sc - lse[:, h].reshape(b, nq, block, 1)), 0.0)
        dp = torch.einsum("bqtd,bqkd->bqtk", doh, vh)
        ds = p * (dp - delta[:, :, h].reshape(b, nq, block, 1)) * scale
        dq[:, :, h] = torch.einsum("bqtk,bqkd->bqtd", ds, kh).reshape(b, l, d).to(q.dtype)
        # one partial block per (q-block, slot), scatter-added outside
        dk_part = torch.einsum("bqtk,bqtd->bqkd", ds, qh).reshape(b * nq * s * block, d)
        dv_part = torch.einsum("bqtk,bqtd->bqkd", p, doh).reshape(b * nq * s * block, dv)
        dk[:, :, g].view(b * l, d).index_add_(0, flat, dk_part)
        dvv[:, :, g].view(b * l, dv).index_add_(0, flat, dv_part)
    return dq, dk.to(k.dtype), dvv.to(v.dtype)


# ---------------------------------------------------------------- kernels
def _check_kernel_args(q, k, v, block_idx, segment_ids, block: int, causal: bool, name: str):
    if not (k.device == v.device == segment_ids.device == block_idx.device == q.device):
        raise ValueError(f"{name}: inputs on different devices")
    b, l, hq, d = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:2] != (b, l) or v.shape[:3] != k.shape[:3] \
            or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not fit (B, L, Hq, D), (B, L, Hkv, D), (B, L, Hkv, Dv)")
    if (d, v.shape[3]) not in KERNEL_DIMS:
        raise ValueError(f"{name} kernel: (D, Dv) = {(d, v.shape[3])} not in {KERNEL_DIMS}")
    if not causal:
        raise ValueError(f"{name} kernel: causal only")
    if block % TILE or l % block:
        raise ValueError(f"{name} kernel: block {block} must be a multiple of {TILE} "
                         f"and divide L {l}")
    if block_idx.dim() != 3 or block_idx.shape[:2] != (b, l // block) \
            or block_idx.dtype != torch.int32:
        raise ValueError(f"{name}: block_idx must be (B, L // block, S) int32")
    if segment_ids.shape != (b, l) or segment_ids.dtype != torch.int32:
        raise ValueError(f"{name}: segment_ids must be (B, L) int32")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: {n} is {t.dtype}, want bfloat16")
    for n, t in (("q", q), ("k", k), ("v", v), ("block_idx", block_idx),
                 ("segment_ids", segment_ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {n} must be contiguous and 16-byte aligned")


def block_sparse_fwd(q, k, v, block_idx, segment_ids, scale: float, block: int,
                     causal: bool = True):
    """The forward kernel (#14): (out (B, L, Hq, Dv) in q.dtype, lse
    (B, Hq, L) f32, mass (B, L, Hq, S) f32)."""
    if q.device.type == "cpu":
        return block_sparse_fwd_plain(q, k, v, block_idx, segment_ids, scale, block, causal)
    _check_kernel_args(q, k, v, block_idx, segment_ids, block, causal, "block_sparse_fwd")
    from ..cuda_lib import check, load

    b, l, hq, _ = q.shape
    s = block_idx.shape[-1]
    out = torch.empty((b, l, hq, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    mass = torch.empty((b, l, hq, s), dtype=torch.float32, device=q.device)
    err = load().xt_block_sparse_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
        segment_ids.data_ptr(), out.data_ptr(), lse.data_ptr(), mass.data_ptr(),
        b, l, hq, k.shape[2], q.shape[-1], v.shape[-1], block, s, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_block_sparse_fwd_bf16")
    block_sparse_fwd.launches += 1
    return out, lse, mass


def block_sparse_bwd(q, k, v, block_idx, segment_ids, out, lse, do, scale: float,
                     block: int, causal: bool = True):
    """The backward kernel (#15): dq, dk, dv in the dtypes of q, k, v. On
    the card one call launches the inverse-table helper, the dq kernel and
    the dk/dv kernel, and counts once."""
    if q.device.type == "cpu":
        return block_sparse_bwd_plain(q, k, v, block_idx, segment_ids, out, lse, do, scale,
                                      block, causal)
    _check_kernel_args(q, k, v, block_idx, segment_ids, block, causal, "block_sparse_bwd")
    b, l, hq, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    if do.shape != out.shape or do.dtype != torch.bfloat16 or not do.is_contiguous():
        raise ValueError(f"block_sparse_bwd kernel: do must be a contiguous bfloat16 "
                         f"{tuple(out.shape)}")
    if lse.shape != (b, hq, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("block_sparse_bwd kernel: lse must be contiguous float32 (B, Hq, L)")
    from ..cuda_lib import check, load

    nq, s = block_idx.shape[1:]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # (B, Hq, L)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvo = torch.empty_like(v)
    # inverse of block_idx: per (row, key block) the q-blocks that chose it
    inv_count = torch.empty((b, l // block), dtype=torch.int32, device=q.device)
    inv_list = torch.empty((b, l // block, nq), dtype=torch.int32, device=q.device)
    err = load().xt_block_sparse_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
        segment_ids.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        inv_count.data_ptr(), inv_list.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvo.data_ptr(), b, l, hq, hkv, q.shape[-1], dv, block, s, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_block_sparse_bwd_bf16")
    block_sparse_bwd.launches += 1
    return dq, dk, dvo


block_sparse_fwd.launches = 0  # kernel launches since the last reset
block_sparse_bwd.launches = 0


def reset_launches() -> None:
    block_sparse_fwd.launches = block_sparse_bwd.launches = 0


class _BlockSparseAttention(torch.autograd.Function):
    """`_bs_attn`'s custom VJP: residuals (q, k, v, block_idx, segment_ids,
    out, lse); `mass` carries no gradient (the distillation target is
    stop-gradient in JAX too)."""

    @staticmethod
    def forward(ctx, q, k, v, block_idx, segment_ids, scale, block, causal):
        out, lse, mass = block_sparse_fwd(q, k, v, block_idx, segment_ids, scale, block,
                                          causal)
        ctx.save_for_backward(q, k, v, block_idx, segment_ids, out, lse)
        ctx.args = (scale, block, causal)
        ctx.mark_non_differentiable(mass)
        return out, mass

    @staticmethod
    def backward(ctx, dout, _dmass):
        q, k, v, block_idx, segment_ids, out, lse = ctx.saved_tensors
        do = dout.to(out.dtype).contiguous()
        dq, dk, dv = block_sparse_bwd(q, k, v, block_idx, segment_ids, out, lse, do,
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q, k, v, block_idx, segment_ids, *, scale: Optional[float] = None,
                           causal: bool = True, block: int = 256,
                           return_block_mass: bool = False):
    """q: (B, L, Hq, D); k: (B, L, Hkv, D); v: (B, L, Hkv, Dv); block_idx
    (B, L // block, S) ascending k-block ids per q-block (-1 = unused).
    Returns out (B, L, Hq, Dv); with return_block_mass also the (B, L, Hq, S)
    per-slot attention mass (no gradient)."""
    b, l, hq, d = q.shape
    if l % block:
        raise ValueError(f"L ({l}) must be a multiple of block ({block})")
    scale = scale if scale is not None else d ** -0.5
    out, mass = _BlockSparseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                            block_idx.to(torch.int32).contiguous(),
                                            segment_ids.to(torch.int32).contiguous(),
                                            float(scale), block, causal)
    return (out, mass) if return_block_mass else out
