"""Dropless MoE transformer (counterpart: `xtuner_tpu/model/moe.py`).

`MoEConfig`, `MoE.param_specs`, the MoE layer forward (attention, then the
routed expert MLP of `module/moe_layer.py` behind the greedy or the noaux
router, plus shared experts), the training `forward` and `loss` with the
balancing and z losses, the `first_k_dense_replace` dense stack,
multi-token prediction (`_mtp_loss`, `module/mtp.py`) and the Qwen3-MoE
presets. Attention is JAX's dispatch, DSA > MLA > MHA, in the dense and
the MoE layers alike; a DSA layer's indexer loss joins `dsa_index_loss`.
Each layer runs under the remat policy of `model/dense.py::remat_wrap`
(a DSA layer: `Dense._dsa_layer_fn`); a tied head reaches the CE as
`embed.T`, which `mode="fused"` reads as the vocab-major embedding it is.

MTP: `mtp_layers` stacks `mtp_num_layers` MoE layers with their fuse
projection and norms (one physical layer under `mtp_share_weights`).
Depth k fuses the hidden state before it (the trunk's before the final
norm, for k = 0) with the embedding of the token k + 1 further on, runs
the layer, and scores the final-normed output against labels shifted
k + 1 within each document; `mtp_loss` is `mtp_loss_coef` times the mean
CE over the depths. Its routers' balancing and z rows follow the trunk's
in the aux means, and their loads come back as `mtp_expert_load` for the
engine's bias update.

`layer_window_pattern` (gpt-oss: a window of 128 on even MoE layers, full
attention on odd ones): MoE layer i takes the window
`model/generate.py::layer_windows` gives it, in training as in serving;
an MHA layer's sinks ride into the flash attention beside q, k and v and
get their gradient there. MLA and DSA layers refuse a window
(`Dense.check_trainable`).

Rollout-routing replay (R3, JAX `model/moe.py:241-260`):
`seq_ctx.rollout_routed_experts` (B, L, nL_moe, K) forces MoE layer i's
expert ids to its slice wherever an entry is 0 or more
(`module/router.py::route`); entries below 0 keep fresh routing. The
port applies it with or without a window pattern: JAX tests the pattern
first (`model/moe.py:219`) and so drops the replay for gpt-oss, the one
model whose routing its serving engine records (ROADMAP.md, known faults
in the reference).

Deepstack injection (Qwen3-VL-30B-A3's text model): as `Dense`'s, after
each of the first n_ds MoE layers; like JAX, a model with dense layers
first or a window pattern refuses it. JAX's replay branch drops the
deepstack features (`model/moe.py:241-260` never reads them); the port
adds them with or without replay.

Not ported yet: HF interop ([serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..loss.ce_loss import ce_loss
from ..loss.moe_loss import balancing_loss, z_loss
from ..module.attention import MHAConfig
from ..module.mlp import mlp_param_specs
from ..module.moe_layer import expert_mlp_param_specs, moe_mlp_forward, shared_experts_forward
from ..module.mtp import mtp_extra_param_specs, mtp_fuse, shift_for_mtp
from ..module.params import ParamSpec, cast_tree, stack_specs
from ..module.router import GreedyRouterConfig, RouterConfig, router_param_specs
from .base import ModelOutputs
from .dense import (Dense, DenseConfig, _attn_param_specs, _is_dsa, add_deepstack,
                    embed_tokens, layer_params, num_layers)
from .generate import layer_windows

MTP_EXTRAS = ("proj", "hidden_norm", "embed_norm")


@dataclass
class MoEConfig(DenseConfig):
    """Field names and defaults of the JAX MoEConfig. `intermediate_size`
    is the dense layer / shared-expert width."""

    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 1024
    first_k_dense_replace: int = 0
    n_shared_experts: int = 0
    router: RouterConfig = field(default_factory=GreedyRouterConfig)
    balancing_loss_coef: float = 0.0
    z_loss_coef: float = 0.0
    layer_window_pattern: Optional[list] = None
    dispatcher: str = "gspmd"
    mtp_num_layers: int = 0
    mtp_loss_coef: float = 0.3
    # one physical MTP layer reused by every depth
    mtp_share_weights: bool = False

    def build(self) -> "MoE":
        return MoE(self)


class MoE(Dense):
    def __init__(self, cfg: MoEConfig):
        self.cfg = cfg

    def moe_windows(self, n: int) -> list:
        """The window of each of the n MoE layers (None: full): the
        pattern's or the config's (`layer_windows`)."""
        return [w or None for w in layer_windows(self.cfg, "moe_layers", n)]

    def moe_layer_param_specs(self) -> dict:
        cfg = self.cfg
        specs = {
            "attn": _attn_param_specs(cfg),
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
        return specs

    def param_specs(self) -> dict:
        self.check_ported()
        cfg = self.cfg
        specs: dict = {
            "embed": {"w": ParamSpec((cfg.vocab_size, cfg.hidden_size), scale=cfg.init_scale)},
            "final_norm": ParamSpec((cfg.hidden_size,), init="ones"),
        }
        if cfg.first_k_dense_replace > 0:
            specs["dense_layers"] = stack_specs(self.layer_param_specs(),
                                                cfg.first_k_dense_replace)
        specs["moe_layers"] = stack_specs(self.moe_layer_param_specs(),
                                          cfg.num_hidden_layers - cfg.first_k_dense_replace)
        if cfg.mtp_num_layers > 0:
            mtp = {**self.moe_layer_param_specs(),
                   **mtp_extra_param_specs(cfg.hidden_size, cfg.init_scale)}
            specs["mtp_layers"] = stack_specs(
                mtp, 1 if cfg.mtp_share_weights else cfg.mtp_num_layers)
        if not cfg.tie_word_embeddings:
            specs["lm_head"] = {"w": ParamSpec((cfg.hidden_size, cfg.vocab_size),
                                               scale=cfg.init_scale)}
        return specs

    # ------------------------------------------------------------------
    def _moe_ffn(self, x, h, lp, valid, compute_dtype, forced=None):
        """The MoE block after the post-attention norm: routed experts (+
        shared, times sigmoid(h @ shared_expert_gate.w) where the layer has
        that gate) -> (x, balancing loss, z loss, expert load (E,)); `lp`
        already in the compute dtype; `forced` (B L, K) the replayed expert
        ids (entries below 0 route afresh) or None."""
        cfg = self.cfg
        moe_out, r, load = moe_mlp_forward(
            lp["experts"], lp["router"], cfg.router, h,
            num_experts=cfg.n_routed_experts, top_k=cfg.num_experts_per_tok,
            act=cfg.hidden_act, compute_dtype=compute_dtype,
            dispatcher=cfg.dispatcher, forced_topk_idx=forced, fp8_cfg=cfg.float8_cfg)
        shared = shared_experts_forward(lp, h, cfg.hidden_act)
        if shared is not None:
            moe_out = moe_out + shared
        bal, _ = balancing_loss(r.probs, r.topk_idx, valid, cfg.n_routed_experts,
                                cfg.num_experts_per_tok)
        return x + moe_out, bal, z_loss(r.logits, valid), load

    def _moe_post(self, x, o, lp, gate, valid, compute_dtype, forced=None):
        """The MoE layer after the flash kernel: the output gate (None:
        none), o-proj, residual, norm, then `_moe_ffn`."""
        lp = cast_tree(lp, compute_dtype)
        x, h = self._attn_out(x, o, lp, gate)
        return self._moe_ffn(x, h, lp, valid, compute_dtype, forced)

    def _moe_layer_fn(self, cos, sin, segment_ids, valid, compute_dtype, remat: str,
                      window=None, forced=None):
        """One MoE decoder layer `(x, lp) -> (x, bal, z, load, indexer loss
        or None)` under the remat policy, its attention with the sliding
        `window` (None: full), its router replaying `forced` (None: fresh
        routing)."""
        if _is_dsa(self.cfg.attention):
            return self._dsa_layer_fn(
                lambda x, h, lp: self._moe_ffn(x, h, lp, valid, compute_dtype, forced),
                cos, sin, segment_ids, compute_dtype, remat)
        fn = self._layer_fn(
            lambda x, o, lp, gate: self._moe_post(x, o, lp, gate, valid, compute_dtype, forced),
            cos, sin, segment_ids, compute_dtype, remat, window)
        return lambda x, lp: (*fn(x, lp), None)

    def _trunk(self, params, seq_ctx, compute_dtype, remat):
        """The dense and MoE stacks -> (x (B, L, H) before the final norm,
        bal (L_moe,), z (L_moe,), load (L_moe, E), the indexer losses'
        sum (None without DSA), (cos, sin, segment ids, valid))."""
        self.check_trainable()
        cfg = self.cfg
        ds = seq_ctx.deepstack_embeds
        if ds is not None and (cfg.first_k_dense_replace > 0 or cfg.layer_window_pattern):
            raise NotImplementedError(
                "deepstack injection assumes the first n_ds layers are plain MoE layers "
                "(Qwen3-VL MoE shape: first_k_dense_replace=0, no window pattern)")
        x, cos, sin, seg = self._embed_and_rope(params, seq_ctx, compute_dtype)
        valid = (seg != 0).reshape(-1)
        idx = []
        if "dense_layers" in params:
            dense_fn = self._dense_layer_fn(cos, sin, seg, compute_dtype, remat)
            for i in range(num_layers(params["dense_layers"])):
                x, idx_loss = dense_fn(x, layer_params(params["dense_layers"], i))
                idx.append(idx_loss)
        bals, zls, loads = [], [], []
        stack = params["moe_layers"]
        n = num_layers(stack)
        replay = seq_ctx.rollout_routed_experts  # (B, L, n, K) or None
        if replay is not None and tuple(replay.shape[:3]) != (*seg.shape, n):
            raise ValueError(f"rollout_routed_experts {tuple(replay.shape)}: want (B, L, "
                             f"{n} MoE layers, K) for segment ids {tuple(seg.shape)}")
        for i, window in enumerate(self.moe_windows(n)):
            forced = None if replay is None else replay[:, :, i].reshape(-1, replay.shape[-1])
            moe_fn = self._moe_layer_fn(cos, sin, seg, valid, compute_dtype, remat, window,
                                        forced)
            x, bal, zl, load, idx_loss = moe_fn(x, layer_params(stack, i))
            x = add_deepstack(x, ds, i)
            bals.append(bal)
            zls.append(zl)
            loads.append(load)
            idx.append(idx_loss)
        idx_sum = torch.stack(idx).sum() if _is_dsa(self.cfg.attention) else None
        return (x, torch.stack(bals), torch.stack(zls), torch.stack(loads), idx_sum,
                (cos, sin, seg, valid))

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        x = self._trunk(params, seq_ctx, compute_dtype, remat)[0]
        return self._final_norm(params, x, compute_dtype)

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full") -> ModelOutputs:
        cfg = self.cfg
        x, bal, zl, load, idx_loss, ctx = self._trunk(params, seq_ctx, compute_dtype, remat)
        hidden = self._final_norm(params, x, compute_dtype)
        w = self.lm_head_weight(params).to(compute_dtype)
        lm, sum_ce, num_tokens = ce_loss(hidden, w, shifted_labels, loss_weights,
                                         global_denom, cfg.lm_loss_cfg)
        out = ModelOutputs(loss=lm, sum_ce=sum_ce, num_tokens=num_tokens, expert_load=load)
        if cfg.mtp_num_layers > 0:
            mtp, mtp_bal, mtp_zl, mtp_load, mtp_idx = self._mtp_loss(
                params, x, ctx, seq_ctx.input_ids, shifted_labels, loss_weights,
                global_denom, compute_dtype, remat)
            out.mtp_loss = mtp
            out.mtp_expert_load = mtp_load
            bal = torch.cat([bal, mtp_bal])
            zl = torch.cat([zl, mtp_zl])
            if idx_loss is not None:
                idx_loss = idx_loss + mtp_idx
        if idx_loss is not None:
            out.dsa_index_loss = cfg.dsa_index_loss_coef * idx_loss
        if cfg.balancing_loss_coef > 0:
            out.balancing_loss = cfg.balancing_loss_coef * bal.mean()
        if cfg.z_loss_coef > 0:
            out.z_loss = cfg.z_loss_coef * zl.mean()
        return out

    def _mtp_loss(self, params, h, ctx, input_ids, shifted_labels, loss_weights,
                  global_denom, compute_dtype, remat):
        """The MTP depths over the trunk state `h` (before the final norm)
        -> (mtp_loss, bal (depths,), z (depths,), load (depths, E), the
        indexer losses' sum (None without DSA))."""
        cfg = self.cfg
        cos, sin, seg, valid = ctx
        w_head = self.lm_head_weight(params).to(compute_dtype)
        layer_fn = self._moe_layer_fn(cos, sin, seg, valid, compute_dtype, remat,
                                      self._cfg_window())
        stack = params["mtp_layers"]
        n_phys = num_layers(stack)
        ids, labels, weights = input_ids, shifted_labels, loss_weights
        losses, bals, zls, loads, idx = [], [], [], [], []
        for depth in range(cfg.mtp_num_layers):
            lp = layer_params(stack, min(depth, n_phys - 1))
            ids = shift_for_mtp(ids, seg, 0)
            labels = shift_for_mtp(labels, seg, -100)
            weights = shift_for_mtp(weights, seg, 0.0)
            extras = cast_tree({k: lp[k] for k in MTP_EXTRAS}, compute_dtype)
            fused = mtp_fuse(extras, h, embed_tokens(params, ids, compute_dtype),
                             cfg.rms_norm_eps)
            h, bal, zl, load, idx_loss = layer_fn(fused, lp)
            lm, _, _ = ce_loss(self._final_norm(params, h, compute_dtype), w_head, labels,
                               weights, global_denom, cfg.lm_loss_cfg)
            losses.append(lm)
            bals.append(bal)
            zls.append(zl)
            loads.append(load)
            idx.append(idx_loss)
        loss = cfg.mtp_loss_coef * sum(losses) / len(losses)
        idx_sum = torch.stack(idx).sum() if _is_dsa(cfg.attention) else None
        return loss, torch.stack(bals), torch.stack(zls), torch.stack(loads), idx_sum


# ----------------------------------------------------------------------
# Qwen3 MoE presets (the public HF configs, identical to the JAX presets)
# ----------------------------------------------------------------------

@dataclass
class Qwen3MoEConfig(MoEConfig):
    model_type: Optional[str] = "qwen3_moe"


def qwen3_moe_30b_a3() -> Qwen3MoEConfig:
    return Qwen3MoEConfig(
        vocab_size=151936,
        max_position_embeddings=40960,
        eos_token_id=151645,
        pad_token_id=151643,
        num_hidden_layers=48,
        hidden_size=2048,
        intermediate_size=6144,
        moe_intermediate_size=768,
        n_routed_experts=128,
        num_experts_per_tok=8,
        rms_norm_eps=1e-6,
        hidden_act="silu",
        rope_theta=1000000.0,
        balancing_loss_coef=0.001,
        router=GreedyRouterConfig(scoring_func="softmax", norm_topk_prob=True),
        attention=MHAConfig(num_attention_heads=32, num_key_value_heads=4, head_dim=128,
                            qk_norm=True),
    )


def qwen3_moe_235b_a22() -> Qwen3MoEConfig:
    cfg = qwen3_moe_30b_a3()
    cfg.num_hidden_layers = 94
    cfg.hidden_size = 4096
    cfg.intermediate_size = 12288
    cfg.moe_intermediate_size = 1536
    cfg.attention = MHAConfig(num_attention_heads=64, num_key_value_heads=4, head_dim=128,
                              qk_norm=True)
    return cfg
