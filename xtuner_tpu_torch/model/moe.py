"""Dropless MoE transformer (counterpart: `xtuner_tpu/model/moe.py`).

`MoEConfig`, `MoE.param_specs`, the MoE layer forward (attention, then the
routed expert MLP of `module/moe_layer.py`, plus shared experts), the
training `forward` and `loss` with the balancing and z losses, the
`first_k_dense_replace` dense stack, and the Qwen3-MoE presets. Each
layer runs under the remat policy of `model/dense.py::remat_wrap`; a tied
head reaches the CE as `embed.T`, which `mode="fused"` reads as the
vocab-major embedding it is.

Not ported yet: multi-token prediction, the per-layer window pattern,
deepstack injection and routing replay ([moe]), HF interop
([serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import not_ported
from ..loss.ce_loss import ce_loss
from ..loss.moe_loss import balancing_loss, z_loss
from ..module.attention import MHAConfig, mha_param_specs
from ..module.mlp import mlp_forward, mlp_param_specs
from ..module.moe_layer import expert_mlp_param_specs, moe_mlp_forward
from ..module.params import ParamSpec, cast_tree, stack_specs
from ..module.router import GreedyRouterConfig, RouterConfig, router_param_specs
from .base import ModelOutputs
from .dense import Dense, DenseConfig, layer_params, num_layers


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

    def build(self) -> "MoE":
        return MoE(self)


class MoE(Dense):
    def __init__(self, cfg: MoEConfig):
        self.cfg = cfg

    def check_ported(self) -> None:
        super().check_ported()
        cfg = self.cfg
        if cfg.mtp_num_layers > 0:
            raise not_ported("multi-token prediction (mtp_num_layers > 0)", "moe")
        if cfg.layer_window_pattern:
            raise not_ported("a per-layer window pattern", "moe")

    def moe_layer_param_specs(self) -> dict:
        cfg = self.cfg
        specs = {
            "attn": mha_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale),
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
        if not cfg.tie_word_embeddings:
            specs["lm_head"] = {"w": ParamSpec((cfg.hidden_size, cfg.vocab_size),
                                               scale=cfg.init_scale)}
        return specs

    # ------------------------------------------------------------------
    def _moe_post(self, x, o, lp, valid, compute_dtype):
        """The MoE layer after the flash kernel: o-proj, residual, norm,
        routed experts (+ shared) -> (x, balancing loss, z loss, expert
        load (E,))."""
        cfg = self.cfg
        lp = cast_tree(lp, compute_dtype)
        x, h = self._attn_out(x, o, lp)
        moe_out, r, load = moe_mlp_forward(
            lp["experts"], lp["router"], cfg.router, h,
            num_experts=cfg.n_routed_experts, top_k=cfg.num_experts_per_tok,
            act=cfg.hidden_act, compute_dtype=compute_dtype,
            dispatcher=cfg.dispatcher, fp8_cfg=cfg.float8_cfg)
        if "shared_experts" in lp:
            moe_out = moe_out + mlp_forward(lp["shared_experts"], h, cfg.hidden_act)
        x = x + moe_out
        bal, _ = balancing_loss(r.probs, r.topk_idx, valid, cfg.n_routed_experts,
                                cfg.num_experts_per_tok)
        return x, bal, z_loss(r.logits, valid), load

    def _forward_aux(self, params, seq_ctx, compute_dtype, remat):
        """-> (hidden (B, L, H), bal (L_moe,), z (L_moe,), load (L_moe, E))."""
        x, cos, sin, seg = self._embed_and_rope(params, seq_ctx, compute_dtype)
        valid = (seg != 0).reshape(-1)
        if "dense_layers" in params:
            dense_fn = self._layer_fn(
                lambda x, o, lp: self._dense_post(x, o, lp, compute_dtype),
                cos, sin, seg, compute_dtype, remat)
            for i in range(num_layers(params["dense_layers"])):
                x = dense_fn(x, layer_params(params["dense_layers"], i))

        moe_fn = self._layer_fn(
            lambda x, o, lp: self._moe_post(x, o, lp, valid, compute_dtype),
            cos, sin, seg, compute_dtype, remat)
        bals, zls, loads = [], [], []
        stack = params["moe_layers"]
        for i in range(num_layers(stack)):
            x, bal, zl, load = moe_fn(x, layer_params(stack, i))
            bals.append(bal)
            zls.append(zl)
            loads.append(load)
        x = self._final_norm(params, x, compute_dtype)
        return x, torch.stack(bals), torch.stack(zls), torch.stack(loads)

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        return self._forward_aux(params, seq_ctx, compute_dtype, remat)[0]

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full") -> ModelOutputs:
        cfg = self.cfg
        hidden, bal, zl, load = self._forward_aux(params, seq_ctx, compute_dtype, remat)
        w = self.lm_head_weight(params).to(compute_dtype)
        lm, sum_ce, num_tokens = ce_loss(hidden, w, shifted_labels, loss_weights,
                                         global_denom, cfg.lm_loss_cfg)
        out = ModelOutputs(loss=lm, sum_ce=sum_ce, num_tokens=num_tokens, expert_load=load)
        if cfg.balancing_loss_coef > 0:
            out.balancing_loss = cfg.balancing_loss_coef * bal.mean()
        if cfg.z_loss_coef > 0:
            out.z_loss = cfg.z_loss_coef * zl.mean()
        return out


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
