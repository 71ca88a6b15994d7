"""Hybrid linear/full attention models, the Qwen3.5 text family
(counterpart: `xtuner_tpu/model/hybrid.py`).

GatedDeltaNet linear attention (`module/gated_deltanet.py`) interleaved with
(gated) full attention in a fixed pattern, e.g. 3 linear : 1 full. The
parameter tree is JAX's: one stack per pattern slot, `pattern.p{i}`, each
with a leading dim of `num_hidden_layers / len(pattern)` periods, so HF
layer `period * len(pattern) + i` is row `period` of `pattern.p{i}`.

Training: `forward` and `loss` (JAX `Hybrid.forward` and
`HybridMoE.forward`, with `MoE.loss`'s CE, balancing and z losses) walk
the sub-layers in HF layer order, period by period and slot by slot. A
linear sub-layer is input norm, `gdn_forward` (its chunked recurrence
differentiated by autograd: JAX has no kernel there either), residual,
post-attention norm and the FFN; a full one is `model/dense.py`'s MHA
layer with the output gate and the flash kernels (#1-#4 at head dim 256),
and the config's sliding window when `use_sliding_window` is set. The
norms are zero-centred as the config says; the rope is the qwen3_vl
type's interleaved MRoPE (`module/rope.py::model_rope_cos_sin`). In the
MoE model every sub-layer's FFN is the routed experts plus the
sigmoid-gated shared expert (`model/moe.py::_moe_ffn`); its balancing
loss, z-loss and expert load come back stacked in HF layer order, as
JAX's (periods, pattern) reshape gives them, and
`seq_ctx.rollout_routed_experts` (B, L, num_hidden_layers, K) forces
sub-layer i's experts to its slice i (entries below 0 route afresh).
JAX's `HybridMoE.forward` never reads that field and so drops the replay
(ROADMAP.md, known faults in the reference); the port applies it.

A VLM's `seq_ctx.inputs_embeds` replace the embedding lookup (Qwen3.5-VL);
`deepstack_embeds` raise: its tower has no deepstack layers, and JAX's
hybrid never reads them.

Remat "none" and "full" are taken ("full" checkpoints each sub-layer,
where JAX checkpoints a whole period inside its scan: the same numbers,
while only one sub-layer's compute-dtype weight copies are alive at a
time); every other policy raises ([train-slice]).

Serving: `param_specs`, `init_decode_cache` and `forward_cached`, the
prefill the paged engine runs at `cache_len` 0
(`model/paged_generate.py`): full slots write their K/V into a dense cache
through the flash forward, linear slots carry (S, conv buffer) from the
prompt. Unlike JAX's `_hybrid_forward_cached`, which returns no routing,
`forward_cached` returns the MoE layers' (B, C, nL, K) expert ids with
`record_routing`, in HF layer order: JAX's engine so starts each hybrid
request with no routing row for the prompt's last position and records
every generated token's experts one token late (ROADMAP.md, known faults
in the reference).

The serving rope is the plain one over the rotary dims
(`module/rope.py::text_rope_scaling`: the qwen3_vl type's frequencies are
the default ones outside the training forward's MRoPE).

Not ported yet: the HF key map ([serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..loss.ce_loss import lm_logits
from ..module.attention import mha_cached_forward, mha_param_specs
from ..module.gated_deltanet import (GatedDeltaNetConfig, gdn_cached_forward, gdn_forward,
                                     gdn_param_specs)
from ..module.mlp import mlp_param_specs
from ..module.moe_layer import expert_mlp_param_specs
from ..module.params import ParamSpec, cast_tree, stack_specs
from ..module.router import router_param_specs
from ..module.rope import _rope_dim, rope_cos_sin, text_rope_scaling
from ..ops.rms_norm import rms_norm
from .dense import Dense, DenseConfig, layer_params
from .generate import layer_slices, mlp_or_moe
from .moe import MoE, MoEConfig

LAYER_KINDS = ("linear", "full")


def _default_pattern() -> list:
    return ["linear", "linear", "linear", "full"]


@dataclass
class HybridConfig(DenseConfig):
    """`layer_types_pattern` repeats over `num_hidden_layers` (which it
    must divide); JAX's fields and defaults."""

    linear_attention: GatedDeltaNetConfig = field(default_factory=GatedDeltaNetConfig)
    layer_types_pattern: list = field(default_factory=_default_pattern)

    def build(self) -> "Hybrid":
        return Hybrid(self)


@dataclass
class HybridMoEConfig(MoEConfig):
    """Qwen3.5's hybrid MoE: GatedDeltaNet and gated full attention, an
    MoE FFN in every layer, a sigmoid gate on the shared expert."""

    linear_attention: GatedDeltaNetConfig = field(default_factory=GatedDeltaNetConfig)
    layer_types_pattern: list = field(default_factory=_default_pattern)
    with_shared_expert_gate: bool = True

    def build(self) -> "HybridMoE":
        return HybridMoE(self)


def n_periods(cfg) -> int:
    return cfg.num_hidden_layers // len(cfg.layer_types_pattern)


class _HybridMixin:
    """What Hybrid and HybridMoE share: the pattern tree, the decode cache
    and the cached forward. The FFN of a sub-layer is `mlp_or_moe`'s."""

    def _check_pattern(self) -> None:
        cfg = self.cfg
        if cfg.num_hidden_layers % len(cfg.layer_types_pattern):
            raise ValueError(f"layer_types_pattern {cfg.layer_types_pattern} does not divide "
                             f"{cfg.num_hidden_layers} layers")
        if any(kind not in LAYER_KINDS for kind in cfg.layer_types_pattern):
            raise ValueError(f"layer kinds must be in {LAYER_KINDS}")
        if cfg.rope_scaling_cfg is not None and cfg.rope_scaling_cfg.use_fope:
            raise not_ported("FoPE in the hybrid", "vlm")

    def _attn_specs(self, kind: str) -> dict:
        cfg = self.cfg
        if kind == "linear":
            return gdn_param_specs(cfg.linear_attention, cfg.hidden_size, cfg.init_scale)
        return mha_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)

    def param_specs(self) -> dict:
        self.check_ported()
        self._check_pattern()
        cfg = self.cfg
        specs: dict = {
            "embed": {"w": ParamSpec((cfg.vocab_size, cfg.hidden_size), scale=cfg.init_scale)},
            "pattern": {f"p{i}": stack_specs(self._sublayer_specs(kind), n_periods(cfg))
                        for i, kind in enumerate(cfg.layer_types_pattern)},
            "final_norm": ParamSpec((cfg.hidden_size,), init="ones"),
        }
        if not cfg.tie_word_embeddings:
            specs["lm_head"] = {"w": ParamSpec((cfg.hidden_size, cfg.vocab_size),
                                               scale=cfg.init_scale)}
        return specs

    # ---------------- training ----------------
    def check_trainable(self, remat: str = "full") -> None:
        """The training forward's refusals: the pattern's, a remat policy
        other than "none" and "full" ([train-slice]) and MTP (the hybrid
        has no MTP layers)."""
        super().check_trainable()
        self._check_pattern()
        if remat not in ("none", "full"):
            raise not_ported(f"remat policy {remat!r} in the hybrid", "train-slice")
        if getattr(self.cfg, "mtp_num_layers", 0):
            raise ValueError("the hybrid has no MTP layers")

    def _sublayers(self, params):
        """(HF layer index, kind, sub-layer params) in HF layer order:
        period j's slot i is layer j * len(pattern) + i."""
        pattern = self.cfg.layer_types_pattern
        for j in range(n_periods(self.cfg)):
            for i, kind in enumerate(pattern):
                yield (j * len(pattern) + i, kind,
                       layer_params(params["pattern"][f"p{i}"], j))

    def _linear_fn(self, ffn, segment_ids, compute_dtype, remat: str):
        """One GatedDeltaNet sub-layer `(x, lp) -> ffn(x + gdn(norm(x)),
        post-attention norm of it, lp)` in the compute dtype, the whole
        sub-layer one checkpoint under remat "full"; `ffn` returns a
        tuple led by x."""
        cfg = self.cfg
        zc = cfg.rms_norm_type == "zero_centered"

        def layer(x, lp):
            lp = cast_tree(lp, compute_dtype)
            h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
            x = x + gdn_forward(lp["attn"], cfg.linear_attention, h, segment_ids)
            h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
            return ffn(x, h, lp)

        if remat == "full":
            return lambda x, lp: checkpoint(layer, x, lp, use_reentrant=False)
        return layer

    def _run_sublayers(self, params, seq_ctx, compute_dtype, remat: str, make_fn):
        """Embedding, rope, then every sub-layer in HF layer order -> (x
        before the final norm, each sub-layer's outputs after x, in that
        order, (cos, sin, segment ids, valid)). `make_fn(kind, layer
        index, cos, sin, segment ids, valid)` gives the sub-layer `(x, lp)
        -> (x, *aux)`."""
        if seq_ctx.deepstack_embeds is not None:
            raise ValueError("the hybrid text model takes no deepstack_embeds (Qwen3.5-VL's "
                             "tower has no deepstack layers)")
        x, cos, sin, seg = self._embed_and_rope(params, seq_ctx, compute_dtype)
        valid = (seg != 0).reshape(-1)
        auxes = []
        for idx, kind, lp in self._sublayers(params):
            x, *aux = make_fn(kind, idx, cos, sin, seg, valid)(x, lp)
            auxes.append(aux)
        return x, auxes, (cos, sin, seg, valid)

    # ---------------- cached generation ----------------
    def init_decode_cache(self, batch_size: int, max_length: int, dtype, device) -> dict:
        """{"p{i}": (S (n, B, Hv, dk, dv) f32, conv (n, B, K-1, ch)) for a
        linear slot, (cache_k, cache_v) (n, B, S, Hkv, D) for a full one},
        zeros; n the number of periods."""
        cfg, n = self.cfg, n_periods(self.cfg)
        la, attn = cfg.linear_attention, cfg.attention
        caches = {}
        for i, kind in enumerate(cfg.layer_types_pattern):
            if kind == "linear":
                caches[f"p{i}"] = (
                    torch.zeros((n, batch_size, la.num_v_heads, la.head_k_dim, la.head_v_dim),
                                dtype=torch.float32, device=device),
                    torch.zeros((n, batch_size, la.conv_kernel_size - 1, la.conv_channels),
                                dtype=dtype, device=device))
            else:
                shape = (n, batch_size, max_length, attn.num_key_value_heads, attn.head_dim)
                caches[f"p{i}"] = (torch.zeros(shape, dtype=dtype, device=device),
                                   torch.zeros(shape, dtype=dtype, device=device))
        return caches

    def cached_sublayer(self, x, lp, kind: str, cos, sin, cache, compute_dtype, kv_mask=None,
                        valid=None, n_valid=None):
        """One sub-layer over a prefill chunk. `cache`: this period's views
        (S, conv) or (cache_k, cache_v); the linear state comes back new,
        the full K/V is written into the views in place. Returns (x, cache,
        the MoE layer's (B, C, K) expert ids or None)."""
        cfg = self.cfg
        lp = cast_tree(lp, compute_dtype)
        zc = cfg.rms_norm_type == "zero_centered"
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
        if kind == "linear":
            h, s_new, conv_new = gdn_cached_forward(lp["attn"], cfg.linear_attention, h,
                                                    cache[0], cache[1], valid, n_valid)
            cache = (s_new, conv_new)
        else:
            h, _, _ = mha_cached_forward(lp["attn"], cfg.attention, h, cos, sin, cache[0],
                                         cache[1], 0, window=self._cfg_window(),
                                         kv_mask=kv_mask)
        x = x + h
        h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
        out, routing = mlp_or_moe(lp, cfg, h, compute_dtype)
        return x + out, cache, routing

    def forward_cached(self, params, ids, positions, caches: dict, cache_len: int,
                       compute_dtype, kv_mask=None, record_routing: bool = False,
                       n_valid=None):
        """ids (B, C) at `cache_len` 0 -> (logits (B, C, V) f32, caches,
        routing): the linear slots' caches hold the state after the chunk
        (after its first n_valid tokens with `n_valid`), the full slots'
        K/V the chunk's; routing is the (B, C, nL_moe, K) expert ids in HF
        layer order with `record_routing`, else None. kv_mask (B, C) bool,
        False = padding: pad tokens never reach a linear state and are
        never attended."""
        if cache_len != 0:
            raise not_ported("the hybrid's cached forward at cache_len > 0", "serve-rest")
        cfg = self.cfg
        c = ids.shape[1]
        x = params["embed"]["w"][ids].to(compute_dtype)
        cos, sin = rope_cos_sin(positions, _rope_dim(cfg.attention), cfg.rope_theta,
                                text_rope_scaling(cfg.rope_scaling_cfg),
                                cfg.max_position_embeddings)
        # the chunk's real tokens (JAX: kv_mask[:, :C] at prefill; a decode
        # step is one real token)
        valid = kv_mask[:, :c] if kv_mask is not None and c > 1 else None
        pattern = cfg.layer_types_pattern
        stacks = [layer_slices(params["pattern"][f"p{i}"], n_periods(cfg))
                  for i in range(len(pattern))]
        # the linear slots' new states; the full slots' K/V is written in place
        states = {f"p{i}": ([], []) for i, kind in enumerate(pattern) if kind == "linear"}
        routings = []
        for j in range(n_periods(cfg)):
            for i, kind in enumerate(pattern):
                key = f"p{i}"
                x, cache, routing = self.cached_sublayer(
                    x, stacks[i][j], kind, cos, sin, (caches[key][0][j], caches[key][1][j]),
                    compute_dtype, kv_mask, valid, n_valid)
                if key in states:
                    states[key][0].append(cache[0])
                    states[key][1].append(cache[1])
                if record_routing and routing is not None:
                    routings.append(routing)
        caches = {**caches, **{key: (torch.stack(s), torch.stack(c))
                               for key, (s, c) in states.items()}}
        x = rms_norm(x, params["final_norm"].float(), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")
        logits = lm_logits(x.to(compute_dtype), self.lm_head_weight(params).to(compute_dtype))
        return logits, caches, torch.stack(routings, dim=2) if routings else None


class Hybrid(_HybridMixin, Dense):
    def __init__(self, cfg: HybridConfig):
        self.cfg = cfg

    def _forward_aux(self, params, seq_ctx, compute_dtype, remat):
        """-> (final hidden states (B, L, H) in compute dtype, None): JAX
        `Hybrid.forward`, each sub-layer's FFN the dense MLP."""
        self.check_trainable(remat)

        def make(kind, idx, cos, sin, seg, valid):
            if kind == "full":
                return self._dense_layer_fn(cos, sin, seg, compute_dtype, remat)
            return self._linear_fn(self._dense_ffn, seg, compute_dtype, remat)

        x, _, _ = self._run_sublayers(params, seq_ctx, compute_dtype, remat, make)
        return self._final_norm(params, x, compute_dtype), None

    def _sublayer_specs(self, kind: str) -> dict:
        cfg = self.cfg
        return {
            "attn": self._attn_specs(kind),
            "mlp": mlp_param_specs(cfg.hidden_size, cfg.intermediate_size, cfg.init_scale,
                                   cfg.mlp_bias),
            "input_norm": ParamSpec((cfg.hidden_size,), init="ones"),
            "post_attn_norm": ParamSpec((cfg.hidden_size,), init="ones"),
        }


class HybridMoE(_HybridMixin, MoE):
    def __init__(self, cfg: HybridMoEConfig):
        self.cfg = cfg
        if cfg.first_k_dense_replace != 0:
            raise ValueError("the hybrid MoE has no dense head layers")

    def _trunk(self, params, seq_ctx, compute_dtype, remat):
        """JAX `HybridMoE.forward` with the replay applied -> (x (B, L, H)
        before the final norm, bal (nL,), z (nL,), load (nL, E) in HF
        layer order, None (no DSA), (cos, sin, segment ids, valid)), as
        `MoE._trunk` returns them for `MoE.loss`."""
        self.check_trainable(remat)
        cfg = self.cfg
        replay = seq_ctx.rollout_routed_experts  # (B, L, nL, K) or None
        n = cfg.num_hidden_layers
        if replay is not None and tuple(replay.shape[:3]) != (*seq_ctx.segment_ids.shape, n):
            raise ValueError(f"rollout_routed_experts {tuple(replay.shape)}: want (B, L, {n} "
                             f"layers, K) for segment ids {tuple(seq_ctx.segment_ids.shape)}")

        def make(kind, idx, cos, sin, seg, valid):
            forced = None if replay is None else replay[:, :, idx].reshape(-1, replay.shape[-1])
            if kind == "full":
                fn = self._moe_layer_fn(cos, sin, seg, valid, compute_dtype, remat,
                                        self._cfg_window(), forced)
                return lambda x, lp: fn(x, lp)[:4]
            return self._linear_fn(
                lambda x, h, lp: self._moe_ffn(x, h, lp, valid, compute_dtype, forced),
                seg, compute_dtype, remat)

        x, aux, ctx = self._run_sublayers(params, seq_ctx, compute_dtype, remat, make)
        bal, zl, load = (torch.stack([a[i] for a in aux]) for i in range(3))
        return x, bal, zl, load, None, ctx

    def _sublayer_specs(self, kind: str) -> dict:
        cfg = self.cfg
        specs = {
            "attn": self._attn_specs(kind),
            "input_norm": ParamSpec((cfg.hidden_size,), init="ones"),
            "post_attn_norm": ParamSpec((cfg.hidden_size,), init="ones"),
            "router": router_param_specs(cfg.router, cfg.hidden_size, cfg.n_routed_experts),
            "experts": expert_mlp_param_specs(cfg.hidden_size, cfg.moe_intermediate_size,
                                              cfg.n_routed_experts, cfg.init_scale),
        }
        if cfg.n_shared_experts > 0:
            specs["shared_experts"] = mlp_param_specs(
                cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
                cfg.init_scale)
            if cfg.with_shared_expert_gate:
                specs["shared_expert_gate"] = {
                    "w": ParamSpec((cfg.hidden_size, 1), scale=cfg.init_scale)}
        return specs


def qwen3_5_moe_35b_a3b() -> HybridMoEConfig:
    """Qwen3.5-35B-A3B (JAX `qwen3_5_moe_35b_a3b`, reference
    moe/qwen3_5_text.py:218-272): 40 layers in 10 periods of 3 GatedDeltaNet
    : 1 gated full attention (16/2 heads of 256, zero-centred qk-norm,
    partial rotary 0.25), 256 experts top-8 of width 512 and a gated shared
    expert, untied vocab 248,320; 34,660,610,688 params."""
    from ..module.attention import MHAConfig
    from ..module.rope import RopeScalingConfig

    return HybridMoEConfig(
        vocab_size=248320,
        max_position_embeddings=262144,
        eos_token_id=248044,
        num_hidden_layers=40,
        hidden_size=2048,
        intermediate_size=0,  # unused: every FFN is MoE
        rms_norm_type="zero_centered",
        rope_theta=10000000.0,
        rope_scaling_cfg=RopeScalingConfig(rope_type="qwen3_vl", mrope_section=[11, 11, 10]),
        attention=MHAConfig(num_attention_heads=16, num_key_value_heads=2, head_dim=256,
                            qk_norm=True, with_gate=True, rms_norm_type="zero_centered",
                            partial_rotary_factor=0.25),
        linear_attention=GatedDeltaNetConfig(num_v_heads=32, num_k_heads=16, head_k_dim=128,
                                             head_v_dim=128, conv_kernel_size=4),
        n_routed_experts=256,
        n_shared_experts=1,
        num_experts_per_tok=8,
        moe_intermediate_size=512,
        balancing_loss_coef=0.001,
    )
