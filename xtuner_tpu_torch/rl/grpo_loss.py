"""GRPO policy loss, token-level PPO-clip with a KL penalty, and OREAL's
(counterpart: `xtuner_tpu/rl/grpo_loss.py`; the configs are dataclasses).

Runs inside the engine's train step on the policy logprobs of
`loss/ce_loss.py::per_token_logprobs`; metrics are 0-d tensors, each
divided by the batch's global denominator, so their sums over the
micro-batches are the batch's values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .rollout_is import RolloutISConfig, compute_rollout_is, mismatch_metrics


@dataclass
class GRPOLossConfig:
    cliprange_low: float = 0.2
    cliprange_high: float = 0.2
    kl_coef: float = 0.0  # 0 disables the ref-KL term
    kl_type: str = "k3"  # k1 | abs | mse/k2 | low_var_kl/k3
    # legacy scalar truncated-IS cap on the policy ratio; None disables
    is_clip: Optional[float] = None
    # rollout importance-sampling correction; needs rollout_logprobs
    rollout_is: Optional[RolloutISConfig] = None
    loss_reduction: str = "token"


@dataclass
class OREALLossConfig(GRPOLossConfig):
    """OREAL: separate calibration for positive- and negative-advantage
    tokens and an SFT-style term on the positives."""

    positive_loss_factor: float = 1.0
    pos_sft_loss_weight: float = 1.0
    pos_policy_loss_weight: float = 1.0
    negative_loss_factor: float = 1.0


def kl_penalty(logprobs, ref_logprobs, kind: str = "k3"):
    """Per-token KL estimators: k1 the difference, abs, mse/k2 half its
    square, k3/low_var_kl the non-negative exp(ref - pi) - (ref - pi) - 1."""
    d = logprobs - ref_logprobs
    if kind in ("k1", "kl"):
        return d
    if kind == "abs":
        return d.abs()
    if kind in ("mse", "k2"):
        return 0.5 * d * d
    if kind in ("k3", "low_var_kl"):
        return torch.exp(-d) + d - 1.0
    raise ValueError(f"Unknown kl_type {kind!r}")


def _clipped_pg(logprobs, old_logprobs, advantages, cfg):
    """-> (ratio, pg1, pg2, pg = max(pg1, pg2)) per token."""
    ratio = torch.exp(logprobs - old_logprobs)
    if cfg.is_clip is not None:
        ratio = ratio.clamp(max=cfg.is_clip)
    pg1 = -advantages * ratio
    pg2 = -advantages * ratio.clamp(1.0 - cfg.cliprange_low, 1.0 + cfg.cliprange_high)
    return ratio, pg1, pg2, torch.maximum(pg1, pg2)


def _add_kl(loss, metrics, logprobs, ref_logprobs, mask, denom, cfg):
    if cfg.kl_coef > 0.0 and ref_logprobs is not None:
        kl_loss = (kl_penalty(logprobs, ref_logprobs, cfg.kl_type) * mask).sum() / denom
        loss = loss + cfg.kl_coef * kl_loss
        metrics["kl"] = kl_loss.detach()
    return loss


def grpo_loss(logprobs, old_logprobs, advantages, mask, cfg: GRPOLossConfig,
              ref_logprobs=None, global_denom=None, rollout_logprobs=None):
    """All inputs (B, L); mask selects the response tokens. With
    `rollout_logprobs` the drift metrics are logged, and with
    `cfg.rollout_is` the IS weights (no gradient) multiply the policy term
    and rejections shrink the mask. Returns (loss, metrics)."""
    mask = mask.float()
    metrics = {}
    is_w = None
    if rollout_logprobs is not None:
        metrics.update(mismatch_metrics(old_logprobs, rollout_logprobs, mask))
        if cfg.rollout_is is not None:
            is_w, mask, is_mets = compute_rollout_is(old_logprobs, rollout_logprobs, mask,
                                                     cfg.rollout_is)
            metrics.update(is_mets)
    denom = global_denom if global_denom is not None else mask.sum().clamp(min=1.0)

    ratio, pg1, pg2, pg = _clipped_pg(logprobs, old_logprobs, advantages, cfg)
    if is_w is not None:
        pg = pg * is_w.detach()
    loss = (pg * mask).sum() / denom
    metrics.update({
        "pg_loss": loss.detach(),
        "ratio_mean": ((ratio * mask).sum() / denom).detach(),
        "clip_frac": (((pg2 > pg1).float() * mask).sum() / denom).detach(),
    })
    loss = _add_kl(loss, metrics, logprobs, ref_logprobs, mask, denom, cfg)
    return loss, metrics


def oreal_loss(logprobs, old_logprobs, advantages, mask, cfg: OREALLossConfig,
               ref_logprobs=None, global_denom=None, global_pos=None, global_neg=None):
    """OREAL: the positives' SFT (-logprob) and policy terms over the global
    positive-token count, the negatives' policy term over the global
    negative count. Under gradient accumulation pass the whole batch's
    counts (`rl/trainer.py::_pack` emits them); the local counts are exact
    for one micro-batch only. `global_denom` is taken and unused, as in
    JAX."""
    mask = mask.float()
    pos = mask * (advantages > 0)
    neg = mask * (advantages <= 0)
    n_pos = (pos.sum() if global_pos is None else global_pos).clamp(min=1.0)
    n_neg = (neg.sum() if global_neg is None else global_neg).clamp(min=1.0)

    ratio, pg1, pg2, pg = _clipped_pg(logprobs, old_logprobs, advantages, cfg)
    pos_w = cfg.positive_loss_factor / n_pos
    sft_loss = (-logprobs * pos).sum() * cfg.pos_sft_loss_weight * pos_w
    pos_pg = (pg * pos).sum() * cfg.pos_policy_loss_weight * pos_w
    neg_pg = (pg * neg).sum() * cfg.negative_loss_factor / n_neg
    loss = sft_loss + pos_pg + neg_pg

    denom = mask.sum().clamp(min=1.0)
    metrics = {
        "pg_loss": (pos_pg + neg_pg).detach(),
        "sft_loss": sft_loss.detach(),
        "ratio_mean": ((ratio * mask).sum() / denom).detach(),
        "clip_frac": (((pg2 > pg1).float() * mask).sum() / denom).detach(),
    }
    loss = _add_kl(loss, metrics, logprobs, ref_logprobs, mask, denom, cfg)
    return loss, metrics
