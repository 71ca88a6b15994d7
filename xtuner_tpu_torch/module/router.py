"""MoE routers (counterpart: `xtuner_tpu/module/router.py`).

`GreedyRouterConfig` and `greedy_route` (softmax or sigmoid scoring, top-k,
`norm_topk_prob`, routed scaling), with the router math in fp32;
`NoAuxRouterConfig` and `noaux_route`, DeepSeek's aux-free router (sigmoid
scores, the `e_score_correction_bias` added for selection only,
group-limited top-k), and `update_noaux_bias`, its post-step bias update
(the engine calls it). The noaux selection takes ties as `jax.lax.top_k`
does, the lowest index first (`topk_lowest_first`). `route` takes
rollout-routing replay (R3): forced expert ids where an entry is 0 or
more, their combine weights re-gathered from the training router's
probabilities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, NamedTuple

import torch

from .params import ParamSpec


class RouterOutput(NamedTuple):
    topk_weights: torch.Tensor  # (N, K) fp32 combine weights
    topk_idx: torch.Tensor  # (N, K) int64 expert ids
    logits: torch.Tensor  # (N, E) fp32 raw router logits (z-loss)
    probs: torch.Tensor  # (N, E) fp32 full routing probabilities (balancing loss)


@dataclass
class GreedyRouterConfig:
    router_type: Literal["greedy"] = "greedy"
    scoring_func: Literal["softmax", "sigmoid"] = "softmax"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    router_bias: bool = False


@dataclass
class NoAuxRouterConfig:
    """Same fields as the JAX config."""

    router_type: Literal["noaux"] = "noaux"
    scoring_func: Literal["sigmoid"] = "sigmoid"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    router_bias: bool = False
    bias_update_speed: float = 0.001


RouterConfig = GreedyRouterConfig | NoAuxRouterConfig


def router_param_specs(cfg: RouterConfig, hidden_size: int, num_experts: int) -> dict:
    specs = {"w": ParamSpec((hidden_size, num_experts), scale=0.02)}
    if cfg.router_bias:
        specs["b"] = ParamSpec((num_experts,), init="zeros")
    if cfg.router_type == "noaux":
        specs["e_score_correction_bias"] = ParamSpec((num_experts,), init="zeros")
    return specs


def greedy_route(p: dict, cfg: GreedyRouterConfig, x: torch.Tensor, top_k: int) -> RouterOutput:
    """x: (N, H) -> top-k routing. Router math in fp32 (parity-critical)."""
    logits = x.float() @ p["w"].float()
    if "b" in p:
        logits = logits + p["b"].float()
    if cfg.scoring_func == "softmax":
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.sigmoid(logits)
    topk_weights, topk_idx = torch.topk(probs, top_k, dim=-1)
    if cfg.norm_topk_prob:
        topk_weights = topk_weights / topk_weights.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    topk_weights = topk_weights * cfg.routed_scaling_factor
    return RouterOutput(topk_weights, topk_idx, logits, probs)


def topk_lowest_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last dim: the k largest values in
    descending order, equal values taken lowest index first. A stable
    descending sort keeps that order; `torch.topk` promises none among
    equals."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def noaux_route(p: dict, cfg: NoAuxRouterConfig, x: torch.Tensor, top_k: int) -> RouterOutput:
    """DeepSeek's aux-free router (JAX `noaux_route`): experts are selected
    on sigmoid scores plus the correction bias (a buffer: no gradient
    reaches it), within the `topk_group` best of `n_group` groups, a
    group's score being the sum of its top-2 biased scores; the combine
    weights are the unbiased scores of the selected experts, normalised,
    times `routed_scaling_factor`. `probs` are the sigmoid scores."""
    logits = x.float() @ p["w"].float()
    if "b" in p:
        logits = logits + p["b"].float()
    scores = torch.sigmoid(logits)
    biased = scores + p["e_score_correction_bias"].detach().float()[None, :]
    n, e = biased.shape
    if cfg.n_group > 1:
        grouped = biased.reshape(n, cfg.n_group, e // cfg.n_group)
        top2 = topk_lowest_first(grouped, 2)[0].sum(dim=-1)  # (N, n_group)
        keep = topk_lowest_first(top2, cfg.topk_group)[1]
        group_mask = torch.zeros((n, cfg.n_group), dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, keep, True)
        biased = biased.masked_fill(
            ~group_mask.repeat_interleave(e // cfg.n_group, dim=1), float("-inf"))
    topk_idx = topk_lowest_first(biased, top_k)[1]
    topk_weights = torch.gather(scores, 1, topk_idx)
    if cfg.norm_topk_prob:
        topk_weights = topk_weights / topk_weights.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    topk_weights = topk_weights * cfg.routed_scaling_factor
    return RouterOutput(topk_weights, topk_idx, logits, scores)


def route(p: dict, cfg: RouterConfig, x: torch.Tensor, top_k: int,
          forced_idx=None) -> RouterOutput:
    """The router `cfg` names (JAX `route`). `forced_idx` (N, K) int or
    None: rollout-routing replay (R3). An entry of 0 or more replaces the
    fresh top-k id, and its combine weight becomes the training router's
    probability there, normalised under `norm_topk_prob` over the row's
    ids, times `routed_scaling_factor`; an entry below 0 keeps the fresh
    id and weight (JAX's per-entry `where`). Logits and probs are the
    fresh ones."""
    out = greedy_route(p, cfg, x, top_k) if cfg.router_type == "greedy" \
        else noaux_route(p, cfg, x, top_k)
    if forced_idx is None:
        return out
    if tuple(forced_idx.shape) != tuple(out.topk_idx.shape):
        raise ValueError(f"forced_idx {tuple(forced_idx.shape)}: want (N, K) = "
                         f"{tuple(out.topk_idx.shape)}")
    forced = forced_idx.to(device=out.topk_idx.device, dtype=out.topk_idx.dtype)
    use = forced >= 0
    idx = torch.where(use, forced, out.topk_idx)
    w = torch.gather(out.probs, 1, idx)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    w = w * cfg.routed_scaling_factor
    return RouterOutput(torch.where(use, w, out.topk_weights), idx, out.logits, out.probs)


@torch.no_grad()
def update_noaux_bias(bias: torch.Tensor, expert_load: torch.Tensor,
                      update_speed: float) -> None:
    """The post-step correction-bias update (JAX `update_noaux_bias`), in
    place: each entry moves by `update_speed` toward uniform load, up where
    its expert took fewer tokens than the layer's mean, down where more.
    bias, expert_load: (..., E), e.g. stacked (L, E); the mean is per row."""
    load = expert_load.float()
    err = load.mean(dim=-1, keepdim=True) - load
    bias.copy_((bias.float() + update_speed * torch.sign(err)).to(bias.dtype))
