"""Generation config, the dense cached forward, sampling and the dense batch
`generate` (counterpart: `xtuner_tpu/model/generate.py`).

`GenerateConfig` keeps the JAX fields and defaults. `_forward_cached` is the
cached forward of a chunk of rows, the prefill (cache_len 0: the flash
forward, #1 on a card) and the decode step (cache_len > 0: the plain
cached attention of `module/attention.py`): a Python loop over the layers
where the JAX package scans, dense and MoE layers (the routed experts of
`module/moe_layer.py` and the shared expert), each with its sliding window
(`layer_windows`, JAX `_layer_windows_py`: gpt-oss's `layer_window_pattern`
over the MoE stack, or `sliding_window`), and with `record_routing` the
(B, C, nL_moe, K) expert ids of every MoE layer, as JAX returns them.
`_sample` / `_filter_logits` draw from a `torch.Generator` (JAX keys
become generators, so sampled ids differ from `jax.random`; greedy ids do
not).

`generate` is JAX's dense batch generation, the rollout of the GRPO
trainer (`rl/trainer.py`): left-padded prompts, positions from the mask's
cumsum, a fresh dense cache per call; the prompts prefilled once per
unique prompt with `prompt_group_size`, then the caches, last logits and
routing repeated across the group; one decode step per new token, each
unmasking only the generated slots; the raw log-softmax of each sampled
token; stop ids, after which a row emits eos. The forward runs on
`compute_copy` of the params, cast once per call where JAX casts each
layer inside its jitted step (the same values). Not ported yet
([serve-rest]): penalties, min_tokens, logit_bias and top_logprobs, the
hybrid's `forward_cached`, MLA and DSA caches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import not_ported
from ..loss.ce_loss import lm_logits
from ..module.attention import MHAConfig, mha_cached_forward
from ..module.mlp import mlp_forward
from ..module.moe_layer import moe_mlp_forward, shared_experts_forward
from ..module.params import cast_tree, tree_map
from ..module.rope import _rope_dim, rope_cos_sin
from ..ops.rms_norm import rms_norm


@dataclass
class GenerateConfig:
    """Sampling + engine config; same fields and defaults as the JAX one."""

    max_new_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    do_sample: bool = True
    eos_token_id: Optional[int] = None
    max_length: int = 2048  # cache size (prompt + generation)
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_tokens: int = 0
    stop_token_ids: list[int] = field(default_factory=list)
    logit_bias: dict[int, float] = field(default_factory=dict)
    top_logprobs: int = 0
    engine: str = "auto"  # auto | dense | paged
    prefix_cache: bool = True
    paged_max_batch: int = 8
    paged_block_size: int = 128
    prefill_chunk: int = 0
    kv_cache_dtype: str = "bf16"  # bf16 | int8
    mtp_speculative: bool = False


def penalties_active(gen_cfg: GenerateConfig) -> bool:
    return (gen_cfg.repetition_penalty != 1.0 or gen_cfg.presence_penalty != 0.0
            or gen_cfg.frequency_penalty != 0.0)


def _stacks(model, params):
    """[(stack_name, layer_params_stacked), ...] in forward order."""
    out = [(key, params[key]) for key in ("dense_layers", "layers", "moe_layers")
           if key in params]
    if not out:
        raise ValueError(f"{type(model).__name__} has no recognized layer stacks "
                         f"(params keys: {sorted(params)})")
    return out


def layer_slices(stack: dict, n: int) -> list[dict]:
    """Per-layer views of a stacked layer tree (the scan's xs)."""
    return [tree_map(lambda a, _i=i: a[_i], stack) for i in range(n)]


def init_cache(model, batch_size: int, max_length: int, dtype, device):
    """[(cache_k, cache_v)] per layer stack, each (n, B, S, Hkv, D) zeros
    in `dtype` on `device`."""
    attn = model.cfg.attention
    shape = (batch_size, max_length, attn.num_key_value_heads, attn.head_dim)
    caches = []
    for _name, stack in _stacks(model, model.param_specs()):
        n = stack["input_norm"].shape[0]
        caches.append((torch.zeros((n, *shape), dtype=dtype, device=device),
                       torch.zeros((n, *shape), dtype=dtype, device=device)))
    return caches


def layer_windows(cfg, stack_name: str, n_layers: int) -> list[int]:
    """Per-layer sliding window as python ints, 0 = full attention (JAX
    `_layer_windows_py`): a `layer_window_pattern` (gpt-oss) alternates
    over the MoE stack; otherwise every layer takes `sliding_window` when
    `use_sliding_window` is set."""
    pattern = getattr(cfg, "layer_window_pattern", None)
    if stack_name == "moe_layers" and pattern:
        return [int(pattern[i % len(pattern)] or 0) for i in range(n_layers)]
    w = cfg.sliding_window if cfg.use_sliding_window else None
    return [0 if w is None else int(w)] * n_layers


def mlp_or_moe(lp, cfg, h, compute_dtype):
    """The layer's MLP after the post-attention norm: the routed experts
    (+ the shared expert, times sigmoid(h @ shared_expert_gate.w) where the
    layer has that gate, Qwen3.5's) of an MoE layer, else the dense MLP.
    Returns (out (B, C, H), the MoE layer's (B, C, K) expert ids or
    None)."""
    if "experts" not in lp:
        return mlp_forward(lp["mlp"], h, cfg.hidden_act), None
    out, r, _ = moe_mlp_forward(
        lp["experts"], lp["router"], cfg.router, h, num_experts=cfg.n_routed_experts,
        top_k=cfg.num_experts_per_tok, act=cfg.hidden_act, compute_dtype=compute_dtype)
    shared = shared_experts_forward(lp, h, cfg.hidden_act)
    if shared is not None:
        out = out + shared
    return out, r.topk_idx.reshape(h.shape[0], h.shape[1], -1)


def _layer_cached(model, lp, cfg, x, cos, sin, cache_k, cache_v, cache_len,
                  compute_dtype, kv_mask=None, window=None):
    """One decoder layer over a prefill chunk; cache_k/v are this layer's
    (B, S, Hkv, D) views, written in place. Returns (x, cache_k, cache_v,
    the MoE layer's (B, C, K) expert ids or None)."""
    lp = cast_tree(lp, compute_dtype)
    zc = cfg.rms_norm_type == "zero_centered"
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
    h, cache_k, cache_v = mha_cached_forward(
        lp["attn"], cfg.attention, h, cos, sin, cache_k, cache_v, cache_len,
        window=window, kv_mask=kv_mask)
    x = x + h
    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
    h, routing = mlp_or_moe(lp, cfg, h, compute_dtype)
    return x + h, cache_k, cache_v, routing


def _forward_cached(model, params, ids, positions, caches, cache_len: int,
                    compute_dtype, kv_mask=None, record_routing: bool = False,
                    with_hidden: bool = False):
    """ids: (B, C) -> (logits (B, C, V) f32, caches, routing): routing is
    the (B, C, nL_moe, K) expert ids of the MoE layers with
    `record_routing` (None without it, or without MoE layers). The caches
    are written in place and returned."""
    if with_hidden:
        raise not_ported("MTP trunk hidden (with_hidden)", "serve-rest")
    cfg = model.cfg
    x = params["embed"]["w"][ids].to(compute_dtype)
    cos, sin = rope_cos_sin(positions, _rope_dim(cfg.attention), cfg.rope_theta,
                            cfg.rope_scaling_cfg, cfg.max_position_embeddings)
    routings = []
    for (name, stack), (ck, cv) in zip(_stacks(model, params), caches):
        windows = layer_windows(cfg, name, ck.shape[0])
        for i, lp in enumerate(layer_slices(stack, ck.shape[0])):
            x, _, _, routing = _layer_cached(model, lp, cfg, x, cos, sin, ck[i], cv[i],
                                             cache_len, compute_dtype, kv_mask,
                                             window=windows[i])
            if record_routing and routing is not None:
                routings.append(routing)
    x = rms_norm(x, params["final_norm"].float(), cfg.rms_norm_eps,
                 cfg.rms_norm_type == "zero_centered")
    logits = lm_logits(x.to(compute_dtype), model.lm_head_weight(params).to(compute_dtype))
    return logits, caches, torch.stack(routings, dim=2) if routings else None


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Row-wise draw from softmax(logits) by the Gumbel-max trick, as
    `jax.random.categorical` does; -inf logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _filter_logits(logits: torch.Tensor, gen_cfg: GenerateConfig) -> torch.Tensor:
    """Temperature/top-k/top-p filtered logits: the log of the
    (unnormalized) sampling distribution."""
    logits = logits / gen_cfg.temperature
    if gen_cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -gen_cfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen_cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits: torch.Tensor, generator: torch.Generator,
            gen_cfg: GenerateConfig) -> torch.Tensor:
    """logits (B, V) fp32 -> token ids (B,) int64."""
    if gen_cfg.logit_bias or penalties_active(gen_cfg) or gen_cfg.min_tokens > 0:
        raise not_ported("logit_bias / penalties / min_tokens", "serve-rest")
    if not gen_cfg.do_sample or gen_cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return categorical(_filter_logits(logits, gen_cfg), generator)


def compute_copy(params: dict, dtype: torch.dtype, copy: bool = True) -> dict:
    """The params as the forwards read them: the layer stacks (keys ending
    in "layers"), the embedding and an untied head in `dtype`, every other
    leaf (the final norm, read in f32) as it is. Every forward casts those
    leaves to the compute dtype before it uses them, so this tree gives
    the same values as `params`. With `copy` every leaf is a new tensor
    (a frozen snapshot); without, leaves already in their dtype are
    shared."""
    def leaf(x, cast):
        return x.detach().to(dtype if cast and x.is_floating_point() else x.dtype, copy=copy)

    return {k: tree_map(lambda x, c=k.endswith("layers") or k in ("embed", "lm_head"):
                        leaf(x, c), v) for k, v in params.items()}


def _check_generate(model, gen_cfg: GenerateConfig) -> None:
    if hasattr(model, "forward_cached"):
        raise not_ported(f"generate on {type(model).__name__} (its forward_cached hook)",
                         "serve-rest")
    if not isinstance(model.cfg.attention, MHAConfig):
        raise not_ported(f"the dense decode of {type(model.cfg.attention).__name__} "
                         "attention", "serve-rest")
    if gen_cfg.top_logprobs > 0:
        raise not_ported("top_logprobs", "serve-rest")


@torch.no_grad()
def generate(model, params, prompt_ids, gen_cfg: GenerateConfig,
             generator: Optional[torch.Generator] = None, compute_dtype=torch.bfloat16,
             pad_token_id: int = 0, return_logprobs: bool = False,
             record_routing: bool = False, prompt_group_size: int = 1) -> dict:
    """prompt_ids: (B, P) ints, left-padded with `pad_token_id`; runs on
    the params' device. Returns numpy `sequences` (B, P + N), `generated`
    (B, N), `num_generated` N, with `return_logprobs` the (B, N) f32
    log-softmax of each sampled token under the raw logits, and with
    `record_routing` on an MoE model `routed_experts` (B, N, nL_moe, K):
    the routing of the forward that sampled each token, i.e. of input
    position P + j - 1 for response token j, the position token j takes
    as a training input (R3 replay). Rows come in groups of
    `prompt_group_size` identical prompts."""
    _check_generate(model, gen_cfg)
    cfg = model.cfg
    dev = params["embed"]["w"].device
    generator = generator or torch.Generator(device=dev).manual_seed(0)
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64, device=dev)
    b, p = prompt.shape
    n_new = gen_cfg.max_new_tokens
    max_len = p + n_new
    eos = gen_cfg.eos_token_id if gen_cfg.eos_token_id is not None else cfg.eos_token_id
    g = max(prompt_group_size, 1)
    if b % g:
        raise ValueError(f"generate: {b} rows are not groups of {g}")
    stop_ids = sorted({eos, *gen_cfg.stop_token_ids} - {None})
    params = compute_copy(params, compute_dtype, copy=False)

    prompt_mask = prompt != pad_token_id
    positions = (prompt_mask.cumsum(dim=1) - 1).clamp(min=0)
    kv_mask0 = torch.cat([prompt_mask, torch.zeros((b, n_new), dtype=torch.bool, device=dev)],
                         dim=1)
    caches = init_cache(model, b // g, max_len, compute_dtype, dev)
    logits, caches, routing = _forward_cached(
        model, params, prompt[::g], positions[::g], caches, 0, compute_dtype, kv_mask0[::g],
        record_routing)
    last = logits[:, -1]
    rout = routing[:, -1] if routing is not None else None  # (B / g, nL, K)
    if g > 1:  # the shared prompt's KV, last logits and routing across the group
        caches = [(ck.repeat_interleave(g, dim=1), cv.repeat_interleave(g, dim=1))
                  for ck, cv in caches]
        last = last.repeat_interleave(g, dim=0)
        rout = rout.repeat_interleave(g, dim=0) if rout is not None else None

    def sample(last):
        tok = _sample(last, generator, gen_cfg)
        lp = torch.log_softmax(last, dim=-1).gather(1, tok[:, None])[:, 0]
        return tok, lp

    tok, lp = sample(last)
    toks, lps, routs = [tok], [lp], [rout]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pos = positions[:, -1]
    slots = torch.arange(max_len, device=dev)[None, :]
    for i in range(n_new - 1):
        cache_len = p + i
        # unmask only the generated slots [p, cache_len]: the left pads stay out
        kv_mask = kv_mask0 | ((slots >= p) & (slots < cache_len + 1))
        logits, caches, routing = _forward_cached(
            model, params, tok[:, None], (pos + 1)[:, None], caches, cache_len, compute_dtype,
            kv_mask, record_routing)
        new_tok, lp = sample(logits[:, -1])
        for t in stop_ids:
            done = done | (tok == t)
        new_tok = torch.where(done, torch.full_like(new_tok, eos), new_tok)
        toks.append(new_tok)
        lps.append(lp)
        routs.append(routing[:, 0] if routing is not None else None)
        tok, pos = new_tok, pos + 1
    gen = torch.stack(toks, dim=1)
    out = {"sequences": torch.cat([prompt, gen], dim=1).cpu().numpy(),
           "generated": gen.cpu().numpy(), "num_generated": n_new}
    if return_logprobs:
        out["logprobs"] = torch.stack(lps, dim=1).float().cpu().numpy()
    if record_routing and routs[0] is not None:
        out["routed_experts"] = torch.stack(routs, dim=1).to(torch.int32).cpu().numpy()
    return out
