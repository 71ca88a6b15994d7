"""Optimizer and LR schedule (counterpart: `xtuner_tpu/config/optim.py`).

`AdamWConfig`, `LRConfig` and `build_lr_schedule` with the JAX package's
fields and defaults, and `AdamW`, an in-place AdamW with optax's
semantics, which `torch.optim.AdamW` does not share:

- the update is `-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`: eps outside
  the square root, decay scaled by lr and added to the Adam direction;
- weight decay applies only to >= 2-D params (`_decay_mask`);
- buffers (`is_buffer`: the noaux router's correction bias) are not
  optimizer params at all: no moments, no decay. JAX hands the stacked
  (L, E) bias to optax like any other leaf, so its AdamW decays it by
  lr x wd each step (a fault of the reference, ROADMAP.md);
- the schedule is evaluated at the count of updates made so far, starting
  from 0, so the first update uses `schedule(0)` (0 under a warmup); a
  skipped step does not advance the count.

The schedules are optax's, written out as plain functions of the step.
`AdamW.state_dict` / `load_state_dict` carry the moments and the count
for checkpoints. `MuonConfig` exists so configs translate; an engine
built with it raises ([muon], Queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Literal, Optional

import torch

from .. import not_ported


@dataclass
class AdamWConfig:
    type: Literal["adamw"] = "adamw"
    lr: float = 1e-5
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    # skip the step if the grad norm exceeds this; None = only non-finite skip
    skip_grad_norm_threshold: Optional[float] = None


@dataclass
class MuonConfig:
    """The JAX MuonConfig's fields, so configs translate; building an
    engine with it raises ([muon])."""

    type: Literal["muon"] = "muon"
    lr: float = 0.02
    momentum: float = 0.95
    nesterov: bool = True
    ns_steps: int = 5
    adjust_lr: Literal["rms_norm", "spectral_norm", "none"] = "rms_norm"
    adamw_lr: float = 1e-5
    adamw_betas: tuple[float, float] = (0.9, 0.999)
    adamw_eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    skip_grad_norm_threshold: Optional[float] = None


@dataclass
class LRConfig:
    lr_type: Literal["cosine", "linear", "constant"] = "cosine"
    warmup_ratio: float = 0.03
    warmup_steps: Optional[int] = None  # overrides ratio if set
    lr_min: float = 1e-6


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (transition_begin 0)."""
    if steps <= 0:
        return lambda _: init

    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule (exponent 1)."""
    if decay_steps <= 0:
        return lambda _: init

    def f(count: int) -> float:
        c = min(count, decay_steps)
        cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cos + alpha)
    return f


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def build_lr_schedule(optim_cfg, lr_cfg: LRConfig, total_steps: int) -> Callable[[int], float]:
    """The JAX package's schedule as a function of the (0-based) count."""
    warmup = lr_cfg.warmup_steps if lr_cfg.warmup_steps is not None else int(
        lr_cfg.warmup_ratio * total_steps)
    peak = optim_cfg.lr
    if lr_cfg.lr_type == "cosine":
        alpha = 0.0 if peak == 0 else lr_cfg.lr_min / peak
        decay = max(total_steps, warmup + 1)
        return _join(_linear(0.0, peak, warmup), _cosine(peak, decay - warmup, alpha), warmup)
    if lr_cfg.lr_type == "linear":
        return _join(_linear(0.0, peak, max(warmup, 1)),
                     _linear(peak, lr_cfg.lr_min, max(total_steps - warmup, 1)), warmup)
    if lr_cfg.lr_type == "constant":
        return _join(_linear(0.0, peak, max(warmup, 1)), lambda _: peak, warmup)
    raise ValueError(f"Unknown lr_type {lr_cfg.lr_type}")


def _decay_mask(p: torch.Tensor) -> bool:
    """Weight decay only on >= 2-D params (norm scales / biases excluded).
    Stacked layer params count by their per-layer dims plus the layer dim,
    as in the JAX tree."""
    return p.dim() >= 2


def is_buffer(name: str) -> bool:
    """A leaf that no gradient or optimizer update touches: the noaux
    router's correction bias, which only the engine's post-step bias
    update moves (DeepSeek-V3 keeps it as a buffer)."""
    return name == "e_score_correction_bias"


class AdamW:
    """optax.adamw over a list of (param, decay) pairs, in place.

    `params` are the master tensors (or views into them: a stacked layer
    param is updated one layer at a time through its views); `m` and `v`
    are f32 buffers of the same shapes. `step(grads)` applies one update
    with `lr = schedule(count)` and advances the count."""

    def __init__(self, params: list[torch.Tensor], decay: list[bool], cfg: AdamWConfig,
                 schedule: Callable[[int], float]):
        if cfg.type != "adamw":
            raise not_ported(f"optimizer {cfg.type!r}", "muon")
        self.params, self.decay, self.cfg, self.schedule = params, decay, cfg, schedule
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> float:
        """Apply one update; returns the lr it used."""
        b1, b2 = self.cfg.betas
        lr = float(self.schedule(self.count))
        t = self.count + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        wd = self.cfg.weight_decay
        for p, g, m, v, dec in zip(self.params, grads, self.m, self.v, self.decay):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            # u = m_hat / (sqrt(v_hat) + eps) (+ wd * p); p -= lr * u
            denom = (v / bc2).sqrt_().add_(self.cfg.eps)
            u = (m / bc1).div_(denom)
            if dec and wd:
                u.add_(p, alpha=wd)
            p.add_(u, alpha=-lr)
        self.count = t
        return lr

    def state_dict(self) -> dict:
        """The optimizer state (optax's `count`, `mu`, `nu`): the moment
        buffers themselves, not copies."""
        return {"count": self.count, "m": list(self.m), "v": list(self.v)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict()` in place (shapes must match)."""
        for name in ("m", "v"):
            if len(state[name]) != len(self.params):
                raise ValueError(f"optimizer state {name!r} has {len(state[name])} "
                                 f"buffers, the model {len(self.params)}")
            for dst, src in zip(getattr(self, name), state[name]):
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"optimizer state {name!r}: shape {tuple(src.shape)} "
                                     f"!= {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])
