"""DSA: sparse MLA attention with the lightning indexer (counterpart:
`xtuner_tpu/module/dsa.py`).

`DSAConfig` (MLA fields plus the indexer's), `dsa_param_specs` and
`dsa_forward` with both selection granularities:

- "token": per-query top-k keys from the (B, L, L) indexer scores, gathered
  attention (`ops/sparse_mla.py`) and the token-level KL distillation of
  the indexer;
- "block": the selection pooled to key blocks of `index_block` tokens,
  `index_top_k // index_block` blocks per q-block, from the chunked indexer
  statistics (no (B, L, L) tensor), attention through the block-sparse
  kernels of `ops/attention/block_sparse.py` (TPU kernels #14 and #15), and
  the block-level distillation against the per-slot attention mass.

A `select_idx` passed in is reused as is (the cross-layer top-k sharing);
the token path then has no indexer loss. The indexer's only gradient is
its distillation loss: the selection itself is discrete.

Not ported yet: the DSA decode `dsa_cached_forward` ([serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import not_ported
from ..ops.sparse_mla import (indexer_block_stats, indexer_kl_loss, indexer_scores,
                              sparse_gather_attention, topk_select)
from .mla import MLAConfig, mla_param_specs, mla_project, mla_softmax_scale
from .mlp import linear
from .params import ParamSpec


@dataclass
class DSAConfig(MLAConfig):
    """MLA plus the lightning indexer, with the JAX defaults."""

    index_n_heads: int = 4
    index_head_dim: int = 32
    index_top_k: int = 512
    # "token": per-token top-k and gather; "block": selection quantised to
    # key blocks of `index_block` tokens, the block-sparse kernels
    select_granularity: str = "token"
    index_block: int = 256


def dsa_param_specs(cfg: DSAConfig, hidden_size: int, init_scale: float = 0.02) -> dict:
    specs = mla_param_specs(cfg, hidden_size, init_scale)
    hi, di = cfg.index_n_heads, cfg.index_head_dim
    specs["idx_q_proj"] = {"w": ParamSpec((hidden_size, hi * di), scale=init_scale)}
    specs["idx_k_proj"] = {"w": ParamSpec((hidden_size, di), scale=init_scale)}
    specs["idx_w_proj"] = {"w": ParamSpec((hidden_size, hi), scale=init_scale)}
    return specs


def dsa_cached_forward(p: dict, cfg: DSAConfig, x, cos, sin, cache_c, cache_r, cache_len,
                       rope_scaling=None, kv_mask=None):
    raise not_ported("DSA decode (dsa_cached_forward)", "serve-rest")


def _indexer_inputs(p, cfg: DSAConfig, x):
    """q_idx (B, L, Hi, Di), k_idx broadcast to (B, L, Hi, Di) (one key per
    token, shared by the indexer heads), head weights (B, L, Hi)."""
    b, l, _ = x.shape
    hi, di = cfg.index_n_heads, cfg.index_head_dim
    q_idx = linear(x, p["idx_q_proj"]).reshape(b, l, hi, di)
    k_idx = linear(x, p["idx_k_proj"]).reshape(b, l, 1, di).expand(b, l, hi, di)
    return q_idx, k_idx, linear(x, p["idx_w_proj"])


def dsa_forward(p: dict, cfg: DSAConfig, x, cos, sin, segment_ids, rope_scaling=None,
                select_idx=None, **_):
    """x: (B, L, H) -> (out (B, L, H), select_idx, indexer loss (0-d f32));
    select_idx is reusable by later layers."""
    b, l, _ = x.shape
    nh = cfg.num_attention_heads
    q_full, k_full, v = mla_project(p, cfg, x, cos, sin)
    scale = mla_softmax_scale(cfg, rope_scaling)

    if cfg.select_granularity == "block":
        if l % cfg.index_block != 0:
            raise ValueError(
                f"select_granularity='block' needs seq len ({l}) divisible by "
                f"index_block ({cfg.index_block}); pad the pack length or "
                f"change index_block")
        return _dsa_block_forward(p, cfg, x, q_full, k_full, v, segment_ids, scale,
                                  select_idx)

    scores = None
    if select_idx is None:
        q_idx, k_idx, w_idx = _indexer_inputs(p, cfg, x)
        scores = indexer_scores(q_idx, k_idx, w_idx, segment_ids)
        select_idx = topk_select(scores, min(cfg.index_top_k, l))
        select_scores = scores.gather(-1, select_idx.long())
    else:
        # shared top-k: validity re-derived from the causal structure
        pos = torch.arange(l, device=x.device)
        causal_ok = select_idx.long() <= pos[None, :, None]
        select_scores = torch.where(causal_ok, 0.0, float("-inf"))

    o, attn_probs = sparse_gather_attention(q_full, k_full, v, select_idx, select_scores,
                                            scale=scale, return_probs=True)
    if scores is not None:
        idx_loss = indexer_kl_loss(select_scores, attn_probs, (segment_ids != 0).float())
    else:
        idx_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    o = o.reshape(b, l, nh * cfg.v_head_dim)
    return linear(o, p["o_proj"]), select_idx, idx_loss


def _dsa_block_forward(p, cfg: DSAConfig, x, q_full, k_full, v, segment_ids, scale,
                       select_idx):
    """Block-granular DSA: the block-sparse kernels, with the indexer
    distilled at block level, KL(block attention mass || softmax of the
    pooled indexer scores over the selected blocks)."""
    from ..ops.attention.block_sparse import block_sparse_attention, select_from_blockmax

    b, l, nh, _ = q_full.shape
    block = cfg.index_block
    num_sel = max(cfg.index_top_k // block, 1)

    q_idx, k_idx, w_idx = _indexer_inputs(p, cfg, x)
    # pooled (B, L, nk) logsumexp per key block + (B, nq, nk) block maxes
    pooled, blockmax = indexer_block_stats(q_idx, k_idx, w_idx, segment_ids, block)
    if select_idx is None:
        select_idx = select_from_blockmax(blockmax.detach(), num_sel)

    o, mass = block_sparse_attention(q_full, k_full, v, select_idx, segment_ids,
                                     scale=scale, block=block, return_block_mass=True)

    # the pooled indexer scores at the selected slots vs the attention mass
    sel_per_row = select_idx.long().repeat_interleave(block, dim=1)  # (B, L, S)
    sel_scores = pooled.gather(-1, sel_per_row.clamp(min=0))
    sel_scores = torch.where(sel_per_row >= 0, sel_scores, float("-inf"))
    target = mass.mean(dim=2).detach()  # (B, L, S)
    target = target / target.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    logz = torch.log_softmax(torch.where(torch.isfinite(sel_scores), sel_scores, -1e30),
                             dim=-1)
    valid = (segment_ids != 0).float()
    kl = -(target * logz).sum(dim=-1) * valid
    idx_loss = kl.sum() / valid.sum().clamp(min=1.0)

    o = o.reshape(b, l, nh * cfg.v_head_dim)
    return linear(o, p["o_proj"]), select_idx, idx_loss
