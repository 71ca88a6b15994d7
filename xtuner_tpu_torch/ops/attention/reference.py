"""Eager reference attention, the parity oracle (counterpart:
`xtuner_tpu/ops/attention/reference.py`).

Packed documents are given by segment ids (0 = padding); key m is visible
to query l iff seg[l] == seg[m] != 0, when causal m <= l, and with a
sliding window l - m < window. Softmax in fp32. GPT-OSS sinks (a per-head
logit) join each row's softmax denominator and weight no value.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_attention_mask(segment_ids: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """(B, L) segment ids -> (B, 1, L, L) boolean mask."""
    seg_q = segment_ids[:, :, None]
    seg_k = segment_ids[:, None, :]
    mask = (seg_q == seg_k) & (seg_q != 0)
    pos = torch.arange(segment_ids.shape[-1], device=segment_ids.device)
    if causal:
        mask = mask & (pos[:, None] >= pos[None, :])
    if window is not None:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    return mask[:, None, :, :]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, L, Hkv, D) -> (B, L, Hkv*n_rep, D), HF repeat_kv layout."""
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None, :].expand(b, l, h, n_rep, d).reshape(b, l, h * n_rep, d)


def reference_attention(q, k, v, segment_ids, *, causal: bool = True,
                        scale: Optional[float] = None, window: Optional[int] = None,
                        sinks=None):
    """q: (B, L, Hq, D); k, v: (B, L, Hkv, D); sinks: optional (Hq,)
    per-head sink logits -> (B, L, Hq, D) in q.dtype."""
    rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    logits = logits.masked_fill(~make_attention_mask(segment_ids, causal, window),
                                float("-inf"))
    if sinks is not None:
        # softmax over [logits, sink]; only the real columns weight values
        sink = sinks.float()[None, :, None, None].expand(*logits.shape[:3], 1)
        m = torch.cat([logits, sink], dim=-1).amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        probs = e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        m = logits.amax(dim=-1, keepdim=True).clamp(min=-1e30)  # fully-masked rows
        e = torch.exp(logits - m)
        probs = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-37)
    return torch.einsum("bhlm,bmhd->blhd", probs, v.float()).to(q.dtype)
