"""DSA sparse attention ops (counterpart: `xtuner_tpu/ops/sparse_mla.py`).

Plain PyTorch in both packages (the JAX module is jnp, no Pallas kernel):

- the lightning indexer: `indexer_scores`, the causal (B, L, L) score
  matrix I[t, s] = sum_h w[t, h] * relu(q_idx[t, h] . k_idx[s, h]), and
  `indexer_block_stats`, its block-pooled statistics computed one key block
  at a time, each block under `torch.utils.checkpoint` (JAX scans the key
  blocks with `jax.checkpoint` on the body), so no (B, L, L) tensor exists
  in the forward or the backward;
- `topk_select`, `sparse_gather_attention` and `indexer_kl_loss`, the
  token-granular selection, attention and distillation loss.

Indexer math is f32, as in JAX. Top-k breaks ties as `jax.lax.top_k` does
(the lower index first), through a stable descending sort.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def indexer_scores(q_idx, k_idx, head_weights, segment_ids=None):
    """q_idx, k_idx: (B, L, Hi, Di); head_weights: (B, L, Hi) -> (B, L, L)
    f32, -inf where the key is in the future or in another document."""
    scores = torch.einsum("bthd,bshd->bths", q_idx.float(), k_idx.float())
    scores = torch.einsum("bths,bth->bts", torch.relu(scores), head_weights.float())
    l = scores.shape[1]
    pos = torch.arange(l, device=scores.device)
    mask = pos[:, None] >= pos[None, :]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :]) \
            & (segment_ids[:, :, None] != 0)
    else:
        mask = mask[None]
    return torch.where(mask, scores, float("-inf"))


def _block_stats(qh, wh, k_blk, seg, seg_k, kpos, block: int):
    """One key block: qh (B, Hi, L, Di) f32, wh (B, Hi, L, 1) f32, k_blk
    (B, Hi, block, Di) -> (logsumexp over the block's keys (B, L), block
    max per q-block (B, nq))."""
    b, _, l, _ = qh.shape
    s = torch.relu(qh @ k_blk.transpose(-1, -2))  # (B, Hi, L, block)
    s = (s * wh).sum(dim=1)  # (B, L, block)
    pos = torch.arange(l, device=s.device)
    mask = ((pos[:, None] >= kpos[None, :])[None]
            & (seg[:, :, None] == seg_k[:, None, :]) & (seg_k[:, None, :] != 0))
    s = torch.where(mask, s, float("-inf"))
    col_lse = torch.logsumexp(s, dim=-1)
    bm = s.reshape(b, l // block, block * block).amax(dim=-1)
    return col_lse, bm


def indexer_block_stats(q_idx, k_idx, head_weights, segment_ids, block: int):
    """Block-pooled indexer statistics without a (B, L, L) tensor.

    q_idx, k_idx: (B, L, Hi, Di) (k_idx may be a broadcast view);
    head_weights (B, L, Hi); segment_ids (B, L). Walks the key blocks of
    `block` tokens; each holds one (B, Hi, L, block) f32 score slab and runs
    under `torch.utils.checkpoint`, so the backward recomputes it too.
    Returns pooled_lse (B, L, nk) f32, the logsumexp of the scores over each
    key block per query token (the block-level distillation input), and
    blockmax (B, nq, nk) f32, the max score per (q-block, k-block), -inf
    where nothing is visible (the selection input)."""
    b, l, hi, di = q_idx.shape
    nk = l // block
    qh = q_idx.float().permute(0, 2, 1, 3).contiguous()  # (B, Hi, L, Di)
    wh = head_weights.float().permute(0, 2, 1)[..., None]  # (B, Hi, L, 1)
    seg = segment_ids
    lses, bms = [], []
    for jb in range(nk):
        lo = jb * block
        k_blk = k_idx[:, lo:lo + block].float().permute(0, 2, 1, 3)  # (B, Hi, block, Di)
        seg_k = seg[:, lo:lo + block]
        kpos = torch.arange(lo, lo + block, device=q_idx.device)
        col_lse, bm = checkpoint(_block_stats, qh, wh, k_blk, seg, seg_k, kpos, block,
                                 use_reentrant=False)
        lses.append(col_lse)
        bms.append(bm)
    return torch.stack(lses, dim=-1), torch.stack(bms, dim=-1)


def topk_desc(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last dim, in
    descending order with ties taken lower index first (`jax.lax.top_k`'s
    order; `torch.topk` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_select(scores, top_k: int):
    """(B, L, L) -> indices (B, L, K) int32 of the best keys per query
    (causal slots past the valid prefix select -inf keys; the attention
    re-masks them)."""
    return topk_desc(scores, top_k)[1].to(torch.int32)


def sparse_gather_attention(q, k, v, select_idx, select_scores, *,
                            scale: Optional[float] = None, return_probs: bool = False):
    """q: (B, L, Hq, Dq); k: (B, L, Hkv, Dq); v: (B, L, Hkv, Dv);
    select_idx (B, L, K); select_scores (B, L, K) (-inf marks invalid slots).
    Returns (B, L, Hq, Dv) in q.dtype (and the (B, L, Hq, K) f32 probs)."""
    b, l, hq, dq = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else dq ** -0.5
    bi = torch.arange(b, device=q.device)[:, None, None]
    idx = select_idx.long()
    k_sel = k[bi, idx]  # (B, L, K, Hkv, D)
    v_sel = v[bi, idx]
    rep = hq // hkv
    if rep > 1:
        k_sel = k_sel.repeat_interleave(rep, dim=3)
        v_sel = v_sel.repeat_interleave(rep, dim=3)
    logits = torch.einsum("blhd,blkhd->blhk", q.float(), k_sel.float()) * scale
    valid = torch.isfinite(select_scores)[:, :, None, :]  # (B, L, 1, K)
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True).clamp(min=-1e29)
    p = torch.exp(logits - m)
    p = torch.where(valid, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / denom.clamp(min=1e-37)
    out = torch.einsum("blhk,blkhd->blhd", p, v_sel.float())
    if return_probs:
        return out.to(q.dtype), p
    return out.to(q.dtype)


def indexer_kl_loss(select_scores, attn_probs, valid_tokens=None):
    """KL(mean-head attention || indexer softmax over the selected slots) up
    to a constant: the indexer's only training signal. select_scores
    (B, L, K) (-inf invalid); attn_probs (B, L, Hq, K)."""
    target = attn_probs.mean(dim=2).detach()
    valid = torch.isfinite(select_scores)
    logz = torch.log_softmax(torch.where(valid, select_scores, -1e30), dim=-1)
    kl = -(target * logz).sum(dim=-1)
    if valid_tokens is not None:
        kl = kl * valid_tokens
        return kl.sum() / valid_tokens.sum().clamp(min=1.0)
    return kl.mean()
