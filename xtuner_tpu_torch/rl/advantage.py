"""Advantage estimators (counterpart: `xtuner_tpu/rl/advantage.py`, a copy:
that module imports no JAX).

Group-normalized GRPO, Dr.GRPO, RLOO, OPO and pass@k, on the host in numpy
over one prompt group's rewards.
"""

from __future__ import annotations

import numpy as np


def grpo_advantage(rewards: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """rewards: (G,) for one prompt group -> group-normalized advantages."""
    mean = rewards.mean()
    std = rewards.std()
    return (rewards - mean) / (std + eps)


def dr_grpo_advantage(rewards: np.ndarray, **_) -> np.ndarray:
    """Dr.GRPO: mean-centered only (no std division — removes length bias)."""
    return rewards - rewards.mean()


def rloo_advantage(rewards: np.ndarray, **_) -> np.ndarray:
    """Leave-one-out baseline."""
    g = len(rewards)
    if g < 2:
        return rewards - rewards.mean()
    total = rewards.sum()
    baseline = (total - rewards) / (g - 1)
    return rewards - baseline


def opo_advantage(rewards: np.ndarray, lengths: np.ndarray | None = None, **_) -> np.ndarray:
    """OPO: optimal length-weighted baseline."""
    if lengths is None:
        return rewards - rewards.mean()
    w = lengths / np.maximum(lengths.sum(), 1)
    return rewards - (rewards * w).sum()


def passk_advantage(rewards: np.ndarray, k: int = 4, eps: float = 1e-6, **_) -> np.ndarray:
    """Pass@k advantages (reference rl/advantage/passk.py; arXiv 2508.10751).

    Rewards are binarized (reward > 0 = correct). With c of n completions
    correct, the group's empirical pass@k rate is
    ``rho = 1 - C(n-c, k)/C(n, k)`` (probability a random size-k subset
    contains a correct one). Correct completions get ``(1-rho)/sigma``;
    incorrect ones ``(1-rho - C(n-c-1, k-1)/C(n-1, k-1))/sigma`` where the
    combinatorial term is the chance a k-subset through this (incorrect)
    completion still passes; ``sigma = sqrt(rho*(1-rho)) + eps``.
    """
    from math import comb

    def c_(n_, r_):
        return float(comb(n_, r_)) if 0 <= r_ <= n_ else 0.0

    n = len(rewards)
    binary = (rewards > 0).astype(np.float32)
    c = int(binary.sum())
    if n < k:
        rho = c / max(n, 1)
    else:
        rho = 1.0 - c_(n - c, k) / max(c_(n, k), 1e-10)
    sigma = float(np.sqrt(rho * (1.0 - rho))) + eps

    adv = np.zeros(n, np.float32)
    adv[binary > 0] = (1.0 - rho) / sigma
    if c > 0 and n > 1:
        cond = c_(n - c - 1, k - 1) / max(c_(n - 1, k - 1), 1e-10)
        adv[binary == 0] = (1.0 - rho - cond) / sigma
    else:
        adv[binary == 0] = -1.0 / sigma
    return adv


_ESTIMATORS = {
    "grpo": grpo_advantage,
    "dr_grpo": dr_grpo_advantage,
    "rloo": rloo_advantage,
    "opo": opo_advantage,
    "passk": passk_advantage,
}


def compute_advantage(rewards: np.ndarray, estimator: str = "grpo", **kw) -> np.ndarray:
    if estimator not in _ESTIMATORS:
        raise KeyError(f"Unknown advantage estimator {estimator!r}; known {sorted(_ESTIMATORS)}")
    return _ESTIMATORS[estimator](np.asarray(rewards, np.float32), **kw)
