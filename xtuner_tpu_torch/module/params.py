"""Parameter specs, init and the weight bridge (counterpart:
`xtuner_tpu/module/params.py`).

Parameters are plain nested dicts of tensors with the JAX package's tree
paths and layouts: linear weights are `(in, out)`, decoder layers are
stacked with a leading L dim. Sharding axes are dropped (one card).
`params_from_numpy` takes the JAX tree as numpy arrays, so both packages
compute the same function from the same weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02  # stddev for normal init


def tree_map(fn: Callable, tree):
    """Map `fn` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def stack_specs(specs, n: int):
    """Add a leading stacked dim (the layer axis) to every spec leaf."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), s.init, s.scale), specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in tree_paths(specs))


def init_params(specs, generator: torch.Generator, device, dtype=torch.float32):
    """Initialize a param tree from a spec tree with one seeded generator on
    `device` (the JAX package folds one key per leaf; torch's generator
    advances instead, so the values differ but the distribution is the
    same). Stacked matrices are drawn one layer at a time so the f32
    temporary never exceeds one layer."""

    def init(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init != "normal":
            raise ValueError(f"Unknown init {spec.init!r}")
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        parts = out if len(spec.shape) >= 3 else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator, device=device,
                                   dtype=torch.float32) * spec.scale)
        return out

    return tree_map(init, specs)


def cast_tree(params, dtype: torch.dtype):
    """Cast float leaves to the compute dtype (a no-op view when they
    already are)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def params_from_numpy(np_tree, cfg, device, dtype=torch.float32):
    """The weight bridge: the JAX param tree as numpy arrays -> the port's
    params on `device` in `dtype`.

    The tree must have exactly the paths and shapes of
    `cfg.build().param_specs()`: embed.w (V, H), final_norm, the untied
    lm_head.w (H, V), and the layer stacks with a leading L dim (`layers`
    of a dense model; `dense_layers` and `moe_layers` of an MoE model, with
    `router.w` (H, E) and `experts.{gate,up,down}_proj` (E, in, out); an
    attention's optional q/k/v/o biases `b` and per-head `sinks`, as
    gpt-oss has them; a hybrid's `pattern.p{i}` stacks, one per pattern
    slot with a leading dim of periods, GatedDeltaNet or attention and its
    MLP or MoE block; Qwen3-VL's `vision`, `projector` and `language`
    trees, with the stacked `blocks` and `deepstack_mergers`); linear
    weights are (in, out). Raises ValueError naming the first path that
    differs."""
    specs = dict(tree_paths(cfg.build().param_specs()))
    got = dict(tree_paths(np_tree))
    if sorted(specs) != sorted(got):
        missing = sorted(set(specs) - set(got))
        extra = sorted(set(got) - set(specs))
        raise ValueError(f"param tree paths differ: missing {missing}, extra {extra}")
    for path, spec in specs.items():
        if tuple(np.shape(got[path])) != tuple(spec.shape):
            raise ValueError(f"param {'.'.join(path)}: shape {np.shape(got[path])} "
                             f"!= spec {spec.shape}")
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32)).to(
            device=device, dtype=dtype), np_tree)
