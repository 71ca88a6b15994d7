"""Dense decoder-only transformer (counterpart: `xtuner_tpu/model/dense.py`).

The parameter tree (`param_specs`), `lm_head_weight`, and the training
`forward`/`loss`. Decoder layers are stored stacked with a leading L dim,
as in the JAX tree; a layer stack may also be given as a list of per-layer
dicts (what the engine trains on, so each layer's gradient is its own
tensor). Remat "full", "none" and "save_attn_residuals" are ported
(`remat_wrap`); the other selective policies raise ([train-slice]).
The serving layer loop lives in `model/generate.py` and
`model/paged_generate.py`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..loss.ce_loss import ce_loss
from ..module.attention import MHAConfig, mha_attend, mha_out, mha_param_specs, mha_qkv
from ..module.mlp import mlp_forward, mlp_param_specs
from ..module.params import ParamSpec, cast_tree, stack_specs, tree_map
from ..module.rope import _rope_dim, rope_cos_sin
from ..ops.rms_norm import rms_norm
from .base import ModelOutputs, TransformerConfig


def remat_wrap(pre, attend, post, remat: str):
    """A decoder layer `(x, lp) -> post(x, attend(*pre(x, lp)), lp)` under
    the remat policy `remat` (JAX `model/dense.py::_remat_policy`).

    `pre` is norm, projections, qk-norm and rope, returning (q, k, v,
    max_logit); `attend` is the flash attention; `post` is the output
    projection, residual, norm and the MLP or MoE block.

    - "none": plain autograd;
    - "full": the whole layer under `torch.utils.checkpoint`, recomputed in
      the backward (flash forward included), as `jax.checkpoint` around the
      scanned layer;
    - "save_attn_residuals": `pre` and `post` are two checkpoint regions and
      the flash autograd Function runs between them, outside both, so it
      keeps its residuals (q, k, v, out, lse) and the backward never re-runs
      the flash forward; everything else is recomputed. JAX saves the same
      names (attn_q/k/v, attn_res_out, attn_lse, attn_out).

    The other named policies raise ([train-slice])."""
    def layer(x, lp):
        return post(x, attend(*pre(x, lp)), lp)

    if remat == "none":
        return layer
    if remat == "full":
        return lambda x, lp: checkpoint(layer, x, lp, use_reentrant=False)
    if remat == "save_attn_residuals":
        def split(x, lp):
            qkv = checkpoint(pre, x, lp, use_reentrant=False)
            return checkpoint(post, x, attend(*qkv), lp, use_reentrant=False)
        return split
    raise not_ported(f"remat policy {remat!r}", "train-slice")


def layer_params(stack, i: int):
    """Layer i of a stack: a list of per-layer dicts, or stacked leaves."""
    if isinstance(stack, (list, tuple)):
        return stack[i]
    return tree_map(lambda a: a[i], stack)


def num_layers(stack) -> int:
    if isinstance(stack, (list, tuple)):
        return len(stack)
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


def embed_tokens(params, input_ids: torch.Tensor, dtype) -> torch.Tensor:
    w = params["embed"]["w"]
    b, l = input_ids.shape
    return w.index_select(0, input_ids.reshape(-1).long()).reshape(b, l, -1).to(dtype)


class DenseConfig(TransformerConfig):
    def build(self) -> "Dense":
        return Dense(self)


class Dense:
    """Pure-function model: `param_specs()` + `forward()` + `loss()`."""

    def __init__(self, cfg: DenseConfig):
        self.cfg = cfg

    def check_ported(self) -> None:
        cfg = self.cfg
        if not isinstance(cfg.attention, MHAConfig):
            raise not_ported(f"attention {type(cfg.attention).__name__}", "mla")
        if cfg.lora_cfg is not None:
            raise not_ported("LoRA", "lora")

    def layer_param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "attn": mha_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale),
            "mlp": mlp_param_specs(cfg.hidden_size, cfg.intermediate_size,
                                   cfg.init_scale, cfg.mlp_bias),
            "input_norm": ParamSpec((cfg.hidden_size,), init="ones"),
            "post_attn_norm": ParamSpec((cfg.hidden_size,), init="ones"),
        }

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs: dict = {
            "embed": {"w": ParamSpec((cfg.vocab_size, cfg.hidden_size), scale=cfg.init_scale)},
            "layers": stack_specs(self.layer_param_specs(), cfg.num_hidden_layers),
            "final_norm": ParamSpec((cfg.hidden_size,), init="ones"),
        }
        if not cfg.tie_word_embeddings:
            specs["lm_head"] = {"w": ParamSpec((cfg.hidden_size, cfg.vocab_size),
                                               scale=cfg.init_scale)}
        return specs

    def lm_head_weight(self, params):
        """(H, V): the untied head, or the tied embedding transposed (a view)."""
        if self.cfg.tie_word_embeddings:
            return params["embed"]["w"].T
        return params["lm_head"]["w"]

    # ------------------------------------------------------------------
    def _window(self):
        cfg = self.cfg
        return cfg.sliding_window if cfg.use_sliding_window else None

    def _attn_in(self, x, lp, cos, sin, compute_dtype):
        """The layer up to the flash kernel: input norm, projections,
        qk-norm, rope -> (q, k, v, max_logit)."""
        cfg = self.cfg
        h = rms_norm(x, lp["input_norm"].to(compute_dtype), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")
        return mha_qkv(cast_tree(lp["attn"], compute_dtype), cfg.attention, h, cos, sin,
                       window=self._window(), fp8_cfg=cfg.float8_cfg)

    def _attn_out(self, x, o, lp):
        """o-proj -> residual -> norm; `lp` already in the compute dtype.
        Returns (x, normed h)."""
        cfg = self.cfg
        x = x + mha_out(lp["attn"], cfg.attention, o, cfg.float8_cfg)
        return x, rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps,
                           cfg.rms_norm_type == "zero_centered")

    def _dense_post(self, x, o, lp, compute_dtype):
        lp = cast_tree(lp, compute_dtype)
        x, h = self._attn_out(x, o, lp)
        return x + mlp_forward(lp["mlp"], h, self.cfg.hidden_act, self.cfg.float8_cfg)

    def _layer_fn(self, post, cos, sin, segment_ids, compute_dtype, remat: str):
        """One decoder layer `(x, lp) -> post(x, attention out, lp)` under
        the remat policy."""
        def pre(x, lp):
            return self._attn_in(x, lp, cos, sin, compute_dtype)

        def attend(q, k, v, max_logit):
            return mha_attend(self.cfg.attention, q, k, v, segment_ids, max_logit)

        return remat_wrap(pre, attend, post, remat)

    def _embed_and_rope(self, params, seq_ctx, compute_dtype):
        self.check_ported()
        cfg = self.cfg
        x = embed_tokens(params, seq_ctx.input_ids, compute_dtype)
        cos, sin = rope_cos_sin(seq_ctx.position_ids, _rope_dim(cfg.attention),
                                cfg.rope_theta, cfg.rope_scaling_cfg,
                                cfg.max_position_embeddings)
        return x, cos, sin, seq_ctx.segment_ids.to(torch.int32).contiguous()

    def _final_norm(self, params, x, compute_dtype):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"].float(), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")
        return x.to(compute_dtype)

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        """-> final hidden states (B, L, H) in compute dtype."""
        x, cos, sin, seg = self._embed_and_rope(params, seq_ctx, compute_dtype)
        layer_fn = self._layer_fn(
            lambda x, o, lp: self._dense_post(x, o, lp, compute_dtype),
            cos, sin, seg, compute_dtype, remat)
        stack = params["layers"]
        for i in range(num_layers(stack)):
            x = layer_fn(x, layer_params(stack, i))
        return self._final_norm(params, x, compute_dtype)

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full") -> ModelOutputs:
        hidden = self.forward(params, seq_ctx, compute_dtype, remat)
        w = self.lm_head_weight(params).to(compute_dtype)
        loss, sum_ce, num_tokens = ce_loss(hidden, w, shifted_labels, loss_weights,
                                           global_denom, self.cfg.lm_loss_cfg)
        return ModelOutputs(loss=loss, sum_ce=sum_ce, num_tokens=num_tokens)
