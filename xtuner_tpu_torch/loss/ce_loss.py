"""Cross-entropy loss with global calibration and chunked logits
(counterpart: `xtuner_tpu/loss/ce_loss.py`).

Per-token weights come from the reduction mode (`build_loss_weights`, on
the host) and the denominator is the global sum of weights over the whole
optimizer batch, so the loss does not depend on how the batch is split
into micro-batches. In "chunk" mode the (tokens, vocab) logits are never
held for the backward: each chunk runs under `torch.utils.checkpoint` and
its logits are recomputed in the backward, as the JAX `@jax.checkpoint`
chunk body does. Logits are f32 from compute-dtype operands.

`mode="fused"` routes as the JAX package does: without a head bias and at
a hidden size that is a multiple of 128 it runs `_fused_ce`, the CE
statistics of `ops/fused_ce.py` (TPU kernels #8-#10, Hopper kernels on a
card) over the vocab-major head; otherwise the chunk/eager path. The
mesh-sharded variant of `_fused_ce` waits for the parallelism item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import not_ported

IGNORE_IDX = -100


@dataclass
class CELossConfig:
    mode: Literal["eager", "chunk", "fused"] = "chunk"
    chunk_size: int = 1024
    loss_reduction: Literal["token", "sample", "square"] = "token"
    ignore_idx: int = IGNORE_IDX


def build_loss_weights(shifted_labels: np.ndarray, doc_lens_per_token: np.ndarray,
                       reduction: str = "token") -> np.ndarray:
    """Host-side (collator) weights. shifted_labels: (B, L) int;
    doc_lens_per_token: (B, L) supervised tokens of the token's document."""
    valid = shifted_labels != IGNORE_IDX
    if reduction == "token":
        w = valid.astype(np.float32)
    elif reduction == "sample":
        w = np.where(valid, 1.0 / np.maximum(doc_lens_per_token, 1), 0.0).astype(np.float32)
    elif reduction == "square":
        w = np.where(valid, 1.0 / np.sqrt(np.maximum(doc_lens_per_token, 1)), 0.0).astype(np.float32)
    else:
        raise ValueError(f"Unknown loss reduction {reduction!r}")
    return w


class _LogitsF32(torch.autograd.Function):
    """h (N, H) @ w (H, V) -> f32 logits from bf16 operands on the card
    (`torch.mm(..., out_dtype=float32)` accumulates in f32 and never rounds
    the logits to bf16); the gradients come back in the operands' dtypes."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gc = g.to(h.dtype)
        return torch.mm(gc, w.T), torch.mm(h.T, gc, out_dtype=torch.float32).to(w.dtype)


def lm_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., H) @ w (H, V) with an f32 output, as the JAX
    `jnp.dot(..., preferred_element_type=float32)`; differentiable. Off the
    card, or in f32, both operands are upcast (bf16 products are exact in
    f32, so the result is the same)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        out = _LogitsF32.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def _ce_from_logits(logits, labels, ignore_idx: int):
    """logits (N, V) fp32, labels (N,) -> per-token CE with 0 at ignored."""
    valid = labels != ignore_idx
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, safe[:, None].long())[:, 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse))


def _chunk_ce(h_c, w, lab_c, ignore_idx: int):
    return _ce_from_logits(lm_logits(h_c, w), lab_c, ignore_idx)


def _fused_ce(hidden, lm_head_w, labels, ignore_idx: int):
    """Per-token CE from the fused statistics (JAX `_fused_ce` without a
    mesh). Ignored rows are clamped to label 0 and masked by the `where`,
    so their cotangents are zero. `lm_head_w` (H, V) is the tied `embed.T`
    or the untied head; `ce_lse_and_label` reads the tied one as the
    (V, H) embedding it is, with no transpose or pad copy."""
    from ..ops.fused_ce import ce_lse_and_label

    valid = labels != ignore_idx
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse, lab = ce_lse_and_label(hidden, lm_head_w, safe)
    return torch.where(valid, lse - lab, torch.zeros_like(lse))


def ce_loss(hidden: torch.Tensor, lm_head_w: torch.Tensor, shifted_labels: torch.Tensor,
            loss_weights: torch.Tensor, global_denom, cfg: CELossConfig, lm_head_b=None):
    """hidden: (B, L, H) compute dtype; lm_head_w: (H, V);
    shifted_labels / loss_weights: (B, L); global_denom: scalar (the sum of
    weights over the whole optimizer batch). Returns (loss, sum_ce,
    num_tokens): `loss` is calibrated for the backward."""
    if lm_head_b is not None:
        raise not_ported("an lm_head bias in ce_loss", "train-slice")
    b, l, h = hidden.shape
    n = b * l
    hidden = hidden.reshape(n, h)
    labels = shifted_labels.reshape(n)
    weights = loss_weights.reshape(n).float()
    if cfg.mode == "fused" and h % 128 == 0:
        ce = _fused_ce(hidden, lm_head_w, labels, cfg.ignore_idx)
    elif cfg.mode == "eager" or n <= cfg.chunk_size:
        ce = _ce_from_logits(lm_logits(hidden, lm_head_w), labels, cfg.ignore_idx)
    else:
        parts = []
        for start in range(0, n, cfg.chunk_size):
            sl = slice(start, start + cfg.chunk_size)
            parts.append(checkpoint(_chunk_ce, hidden[sl], lm_head_w, labels[sl],
                                    cfg.ignore_idx, use_reentrant=False))
        ce = torch.cat(parts)
    loss = (ce * weights).sum() / torch.as_tensor(global_denom, dtype=torch.float32,
                                                  device=ce.device).clamp(min=1e-8)
    valid = labels != cfg.ignore_idx
    sum_ce = (ce * valid).sum()
    num_tokens = valid.sum()
    return loss, sum_ce, num_tokens
