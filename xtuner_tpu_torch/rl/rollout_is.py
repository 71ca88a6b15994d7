"""Rollout importance-sampling correction, truncated or masked (counterpart:
`xtuner_tpu/rl/rollout_is.py`).

Corrects the mismatch between the rollout policy (the decode's numerics,
possibly stale weights) and the training policy: IS weights aggregated per
token, per sequence or as a per-sequence geometric mean, clamped
("truncate") and/or turned into rejections of the response mask ("mask"),
a per-token veto that rejects a whole sequence, and drift metrics. One
sequence per row, so a sequence is a row's masked sum. Metrics are 0-d
tensors, summed over micro-batches by the engine as JAX sums them.

Three points where JAX departs from the upstream trainer are kept as JAX
has them (tests/test_torch_rl.py holds each one): no `valid` flag is
emitted, so `merge_rollout_is_metrics` counts an all-padding batch as
valid and its sequence max/min stay at -inf/+inf; `rollout_is_seq_std` is
the population std (n), not `torch.std`'s n - 1; and the merge takes its
keys from the first batch and raises KeyError on a batch without one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

import torch

# exp(+-20) caps ratios at ~4.8e8 before any threshold handling
SAFETY_BOUND = 20.0


@dataclass
class RolloutISConfig:
    """threshold upper/lower bound the IS weights; lower defaults to
    1/upper. mode="truncate" clamps weights into [lower, upper] (TIS);
    mode="mask" instead zeroes the response mask outside [mask_lower,
    mask_upper] (MIS / rejection); "both" does both. veto (lower, upper)
    rejects a whole sequence when ANY token ratio falls outside it."""

    level: Literal["token", "sequence", "geometric"] = "token"
    mode: Literal["truncate", "mask", "both"] = "truncate"
    threshold_upper: float = 2.0
    threshold_lower: Optional[float] = None  # None -> 1/threshold_upper
    mask_threshold_upper: Optional[float] = None  # None -> threshold_upper
    mask_threshold_lower: Optional[float] = None
    veto_threshold: Optional[Tuple[float, float]] = None  # (lower, upper)

    def __post_init__(self):
        if self.threshold_upper <= self.lower:
            raise ValueError("threshold_upper must exceed threshold_lower")
        if self.veto_threshold is not None and self.veto_threshold[0] >= self.veto_threshold[1]:
            raise ValueError("veto_threshold must be (lower, upper) with lower < upper")

    @property
    def lower(self) -> float:
        return self.threshold_lower if self.threshold_lower is not None else 1.0 / self.threshold_upper

    @property
    def mask_upper(self) -> float:
        return self.mask_threshold_upper if self.mask_threshold_upper is not None else self.threshold_upper

    @property
    def mask_lower(self) -> float:
        return self.mask_threshold_lower if self.mask_threshold_lower is not None else self.lower


def _masked_mean(x, mask, dim=None):
    if dim is None:
        return (x * mask).sum() / mask.sum().clamp(min=1.0)
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim).clamp(min=1.0)


def _masked_max(x, keep):
    return torch.where(keep, x, torch.full_like(x, -math.inf)).max()


def _masked_min(x, keep):
    return torch.where(keep, x, torch.full_like(x, math.inf)).min()


def compute_rollout_is(old_logprobs, rollout_logprobs, mask, cfg: RolloutISConfig):
    """old_logprobs: training-policy logprobs of the rollout tokens (B, L);
    rollout_logprobs: the decode's logprobs (B, L); mask: response mask.
    Returns (weights (B, L), the new mask (B, L), metrics dict of 0-d
    tensors); padding positions get weight 0."""
    mask = mask.float()
    log_ratio = (old_logprobs - rollout_logprobs) * mask

    if cfg.level == "token":
        log_agg = log_ratio
        weights = torch.exp(log_ratio.clamp(-SAFETY_BOUND, SAFETY_BOUND))
    elif cfg.level == "sequence":
        log_agg = log_ratio.sum(dim=-1, keepdim=True).expand_as(mask)
        weights = torch.exp(log_agg.clamp(-SAFETY_BOUND, SAFETY_BOUND))
    else:  # geometric mean over response tokens
        log_agg = _masked_mean(log_ratio, mask, dim=-1)[..., None].expand_as(mask)
        weights = torch.exp(log_agg.clamp(-SAFETY_BOUND, SAFETY_BOUND))

    # per-token veto: any catastrophic token rejects its whole sequence
    if cfg.veto_threshold is not None:
        v_lo, v_hi = cfg.veto_threshold
        catastrophic = ((log_ratio < math.log(v_lo)) | (log_ratio > math.log(v_hi))) & (mask > 0)
        has_cat = catastrophic.any(dim=-1, keepdim=True)
    else:
        catastrophic = torch.zeros_like(mask, dtype=torch.bool)
        has_cat = torch.zeros((*mask.shape[:-1], 1), dtype=torch.bool, device=mask.device)
    veto_mask = 1.0 - has_cat.float()

    metrics = _is_metrics(weights, log_agg, mask, cfg, has_cat, catastrophic)

    new_mask = mask
    if cfg.mode in ("mask", "both"):
        keep = ((weights >= cfg.mask_lower) & (weights <= cfg.mask_upper)).float()
        metrics["rollout_is_masked_fraction"] = _masked_mean(1.0 - keep, mask)
        seq_has_masked = ((keep < 0.5) & (mask > 0)).any(dim=-1).float()
        seq_valid = (mask.sum(dim=-1) > 0).float()
        metrics["rollout_is_seq_masked_fraction"] = (
            (seq_has_masked * seq_valid).sum() / seq_valid.sum().clamp(min=1.0))
        new_mask = mask * keep
    if cfg.mode in ("truncate", "both"):
        weights = weights.clamp(cfg.lower, cfg.threshold_upper)
    new_mask = new_mask * veto_mask
    return weights * mask, new_mask, metrics


def _is_metrics(weights, log_agg, mask, cfg, has_cat, catastrophic):
    """Drift and diagnostic metrics of the IS weights."""
    seq_valid = (mask.sum(dim=-1) > 0).float()
    n_seq = seq_valid.sum().clamp(min=1.0)
    log_up, log_lo = math.log(cfg.threshold_upper), math.log(cfg.lower)
    live = mask > 0
    m = {
        "rollout_is_veto_fraction": (has_cat[..., 0].float() * seq_valid).sum() / n_seq,
        "rollout_is_catastrophic_token_fraction": _masked_mean(catastrophic.float(), mask),
        "rollout_is_mean": _masked_mean(weights, mask),
        "rollout_is_ratio_fraction_high": _masked_mean((log_agg > log_up).float(), mask),
        "rollout_is_ratio_fraction_low": _masked_mean((log_agg < log_lo).float(), mask),
        "rollout_is_max": _masked_max(weights, live),
        "rollout_is_min": _masked_min(weights, live),
    }
    # std / effective sample size on clamped weights (overflow-safe)
    w_c = weights.clamp(cfg.lower, cfg.threshold_upper)
    mean_c = _masked_mean(w_c, mask)
    var = (_masked_mean(w_c * w_c, mask) - mean_c * mean_c).clamp(min=0.0)
    m["rollout_is_std"] = torch.sqrt(var)
    w_n = w_c / (mean_c + 1e-8)
    m["rollout_is_eff_sample_size"] = 1.0 / _masked_mean(w_n * w_n, mask).clamp(min=1e-8)
    # per-sequence mean-weight spread: population std over the valid rows
    seq_mean = _masked_mean(weights, mask, dim=-1)
    sm_mean = (seq_mean * seq_valid).sum() / n_seq
    m["rollout_is_seq_mean"] = sm_mean
    sm_var = ((seq_mean * seq_mean * seq_valid).sum() / n_seq - sm_mean * sm_mean).clamp(min=0.0)
    m["rollout_is_seq_std"] = torch.sqrt(sm_var)
    m["rollout_is_seq_max"] = _masked_max(seq_mean, seq_valid > 0)
    m["rollout_is_seq_min"] = _masked_min(seq_mean, seq_valid > 0)
    m["rollout_is_seq_max_deviation"] = ((seq_mean - 1.0).abs() * seq_valid).max()
    m["rollout_is_seq_fraction_high"] = (
        (seq_mean > cfg.threshold_upper).float() * seq_valid).sum() / n_seq
    m["rollout_is_seq_fraction_low"] = ((seq_mean < cfg.lower).float() * seq_valid).sum() / n_seq
    return m


def mismatch_metrics(old_logprobs, rollout_logprobs, mask):
    """Training <-> rollout drift metrics, whether or not IS correction is
    on: k1 / k3 KL estimates and per-sequence perplexity drift."""
    mask = mask.float()
    d = (old_logprobs - rollout_logprobs) * mask  # log(pi_train / pi_rollout)
    seq_valid = (mask.sum(dim=-1) > 0).float()
    n_seq = seq_valid.sum().clamp(min=1.0)
    mean_lp_train = _masked_mean(old_logprobs, mask, dim=-1)  # (B,)
    mean_lp_roll = _masked_mean(rollout_logprobs, mask, dim=-1)
    log_ppl_diff = (mean_lp_roll - mean_lp_train) * seq_valid
    return {
        "mismatch_kl": _masked_mean(-d, mask),
        "mismatch_k3_kl": _masked_mean(torch.exp(d) - d - 1.0, mask),
        "mismatch_abs_logprob_diff": _masked_mean(d.abs(), mask),
        "mismatch_training_ppl": (torch.exp(-mean_lp_train) * seq_valid).sum() / n_seq,
        "mismatch_training_log_ppl": (-mean_lp_train * seq_valid).sum() / n_seq,
        "mismatch_rollout_ppl": (torch.exp(-mean_lp_roll) * seq_valid).sum() / n_seq,
        "mismatch_rollout_log_ppl": (-mean_lp_roll * seq_valid).sum() / n_seq,
        "mismatch_log_ppl_diff": log_ppl_diff.sum() / n_seq,
        "mismatch_log_ppl_abs_diff": log_ppl_diff.abs().sum() / n_seq,
        "mismatch_log_ppl_diff_max": _masked_max(log_ppl_diff, seq_valid > 0),
        "mismatch_log_ppl_diff_min": _masked_min(log_ppl_diff, seq_valid > 0),
        "mismatch_ppl_ratio": (torch.exp(log_ppl_diff) * seq_valid).sum() / n_seq,
    }


def merge_rollout_is_metrics(per_batch: list[dict]) -> dict:
    """Per-micro-batch IS / mismatch metric dicts -> one logging dict:
    max-named keys take the max, min-named the min, the rest the mean over
    the batches whose "valid" flag is set (absent: valid). Takes floats,
    numpy or torch scalars."""
    if not per_batch:
        return {}
    valids = [bool(float(m.get("valid", True))) for m in per_batch]
    keys = [k for k in per_batch[0] if k != "valid"]
    out = {}
    n = sum(valids)
    for k in keys:
        vals = [float(m[k]) for m, ok in zip(per_batch, valids) if ok]
        if not vals:
            out[k] = 0.0
        elif "max" in k:
            out[k] = max(vals)
        elif "min" in k:
            out[k] = min(vals)
        else:
            out[k] = sum(vals) / n
    return out
