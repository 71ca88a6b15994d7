"""Dense decoder-only transformer (counterpart: `xtuner_tpu/model/dense.py`).

The parameter tree (`param_specs`), `lm_head_weight`, and the training
`forward`/`loss`. Decoder layers are stored stacked with a leading L dim,
as in the JAX tree; a layer stack may also be given as a list of per-layer
dicts (what the engine trains on, so each layer's gradient is its own
tensor). Remat "full", "none", "save_attn_residuals" and "save_out_lse"
are ported (`remat_wrap`); the other selective policies raise
([train-slice]).
The serving layer loop lives in `model/generate.py` and
`model/paged_generate.py`.

Attention is MHA (`module/attention.py`), plain MLA (`module/mla.py`,
DeepSeek-V3's: `mla_project`, the flash kernels at q/k dim 192 and v dim
128, `mla_out`) or DSA (`module/dsa.py`, GLM-5.2's sparse MLA with the
lightning indexer); the dispatch is JAX's, DSA > MLA > MHA. MHA and MLA
layers run under every ported remat policy (`remat_wrap`), MHA with its
sliding window and GPT-OSS sinks (the flash kernels take both). A window
on MLA or DSA attention raises (`check_trainable`): JAX's `mla_forward`
takes `window` and never passes it to its attention, and its DSA path has
none, so the reference would drop it silently. A DSA layer
returns its indexer loss beside x, and `loss` sets `dsa_index_loss` to
their sum times `dsa_index_loss_coef`. Under remat "full" the whole DSA
layer, indexer included, is one checkpoint; "none" runs it plainly, and
the other policies raise for DSA ([train-slice]).

A VLM hands the text model its input embeddings (`seq_ctx.inputs_embeds`,
which replace the embedding lookup) and Qwen3-VL's deepstack features
(`seq_ctx.deepstack_embeds`, (n_ds, B, L, H), zero away from the image
tokens), added to x after each of the first n_ds layers, outside the
layer's remat region (JAX `model/dense.py:200-215`).
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..loss.ce_loss import ce_loss
from ..module.attention import MHAConfig, mha_out, mha_param_specs, mha_qkv
from ..module.dsa import DSAConfig, dsa_forward, dsa_param_specs
from ..module.mla import MLAConfig, mla_out, mla_param_specs, mla_project, mla_softmax_scale
from ..module.mlp import mlp_forward, mlp_param_specs
from ..module.params import ParamSpec, cast_tree, stack_specs, tree_map
from ..module.rope import _rope_dim, model_rope_cos_sin
from ..ops.attention.flash import flash_attention_saving_out_lse
from ..ops.rms_norm import rms_norm
from .base import ModelOutputs, TransformerConfig


def remat_wrap(pre, attend, post, remat: str):
    """A decoder layer `(x, lp) -> post(x, attention over pre(x, lp), lp)`
    under the remat policy `remat` (JAX `model/dense.py::_remat_policy`).

    `pre` is norm, projections, qk-norm and rope, returning (q, k, v,
    max_logit, sinks, gate); `attend(fn, *inputs)` is the flash attention
    over `(q, k, v, max_logit, sinks) = fn(*inputs)`, which keeps `inputs`,
    out and lse for the backward and re-runs `fn` there; `post(x, o, lp,
    gate)` is the output gate (gated attention; None: none), the output
    projection, residual, norm and the MLP or MoE block. Every policy
    carries the sinks into the attention as a differentiable input, and
    `attend` carries the layer's window.

    - "none": plain autograd; the attention keeps q, k and v;
    - "full": the whole layer under `torch.utils.checkpoint`, recomputed in
      the backward (flash forward included), as `jax.checkpoint` around the
      scanned layer;
    - "save_attn_residuals": `pre` and `post` are two checkpoint regions and
      the attention runs between them, outside both, so it keeps q, k, v,
      out and lse and the backward never re-runs the flash forward;
      everything else is recomputed. JAX saves the same names (attn_q/k/v,
      attn_res_out, attn_lse, attn_out);
    - "save_out_lse": the attention runs over `pre` itself, so it keeps the
      layer input, out and lse (JAX's attn_res_out and attn_lse); its
      backward re-runs `pre` (q, k and v are recomputed, never saved) and
      never the flash forward. `post` is one checkpoint region, as under
      "save_attn_residuals". A gated attention raises here ([train-slice]):
      its gate would be one more saved or recomputed input of `post`.

    The other named policies raise ([train-slice])."""
    def attend_qkv(q, k, v, max_logit, sinks):
        return attend(lambda q_, k_, v_, *s: (q_, k_, v_, max_logit, s[0] if s else None),
                      *((q, k, v) if sinks is None else (q, k, v, sinks)))

    def layer(x, lp):
        *qkv, gate = pre(x, lp)
        return post(x, attend_qkv(*qkv), lp, gate)

    if remat == "none":
        return layer
    if remat == "full":
        return lambda x, lp: checkpoint(layer, x, lp, use_reentrant=False)
    if remat == "save_attn_residuals":
        def split(x, lp):
            *qkv, gate = checkpoint(pre, x, lp, use_reentrant=False)
            return checkpoint(post, x, attend_qkv(*qkv), lp, gate, use_reentrant=False)
        return split
    if remat == "save_out_lse":
        def ungated(out):
            if out[5] is not None:
                raise not_ported("gated attention under remat 'save_out_lse'", "train-slice")
            return out[:5]

        def saving_out_lse(x, lp):
            leaves, spec = tree_flatten(lp)
            o = attend(lambda x_, *ls: ungated(pre(x_, tree_unflatten(list(ls), spec))), x,
                       *leaves)
            return checkpoint(post, x, o, lp, None, use_reentrant=False)
        return saving_out_lse
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


def add_deepstack(x: torch.Tensor, ds, i: int) -> torch.Tensor:
    """x plus deepstack row i after text layer i, for i < n_ds (ds: (n_ds,
    B, L, H) or None)."""
    if ds is None or i >= ds.shape[0]:
        return x
    return x + ds[i].to(x.dtype)


def embed_tokens(params, input_ids: torch.Tensor, dtype) -> torch.Tensor:
    w = params["embed"]["w"]
    b, l = input_ids.shape
    return w.index_select(0, input_ids.reshape(-1).long()).reshape(b, l, -1).to(dtype)


def _is_dsa(attn_cfg) -> bool:
    return isinstance(attn_cfg, DSAConfig)


def _attn_param_specs(cfg) -> dict:
    """Attention spec dispatch, JAX's order: DSA > MLA > MHA."""
    if _is_dsa(cfg.attention):
        return dsa_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)
    if isinstance(cfg.attention, MLAConfig):
        return mla_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)
    return mha_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)


class DenseConfig(TransformerConfig):
    def build(self) -> "Dense":
        return Dense(self)


class Dense:
    """Pure-function model: `param_specs()` + `forward()` + `loss()`."""

    def __init__(self, cfg: DenseConfig):
        self.cfg = cfg

    def check_ported(self) -> None:
        cfg = self.cfg
        if not isinstance(cfg.attention, (MHAConfig, MLAConfig)):
            raise not_ported(f"attention {type(cfg.attention).__name__}", "hybrid")
        if cfg.lora_cfg is not None:
            raise not_ported("LoRA", "lora")

    def layer_param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "attn": _attn_param_specs(cfg),
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
    def check_trainable(self) -> None:
        """The training forward's refusals beyond `check_ported`: a
        sliding window or window pattern on MLA or DSA attention, whose
        JAX paths take none (JAX `mla_forward` accepts `window` and never
        passes it on; DSA has no such argument) and would drop it."""
        cfg = self.cfg
        if not isinstance(cfg.attention, MHAConfig) and (
                cfg.use_sliding_window or getattr(cfg, "layer_window_pattern", None)):
            raise not_ported(f"a sliding window or window pattern on "
                             f"{type(cfg.attention).__name__} (MLA or DSA) attention", "moe")

    def _cfg_window(self):
        """The window of a layer without a pattern (JAX `_layer_forward`):
        the config's sliding window, or None."""
        cfg = self.cfg
        return cfg.sliding_window if cfg.use_sliding_window else None

    def _attn_in(self, x, lp, cos, sin, compute_dtype):
        """The layer up to the flash kernel: input norm, projections,
        qk-norm, rope -> (q, k, v, max_logit, sinks, gate); MLA has no
        qk-norm, so its max_logit is None (the running-max forward), no
        sinks and no gate."""
        cfg = self.cfg
        h = rms_norm(x, lp["input_norm"].to(compute_dtype), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")
        p = cast_tree(lp["attn"], compute_dtype)
        if isinstance(cfg.attention, MLAConfig):
            return (*mla_project(p, cfg.attention, h, cos, sin), None, None, None)
        return mha_qkv(p, cfg.attention, h, cos, sin, fp8_cfg=cfg.float8_cfg)

    def _attn_out(self, x, o, lp, gate=None):
        """The output gate (None: none) -> o-proj -> residual -> norm; `lp`
        already in the compute dtype. Returns (x, normed h)."""
        cfg = self.cfg
        if isinstance(cfg.attention, MLAConfig):
            x = x + mla_out(lp["attn"], cfg.attention, o)
        else:
            x = x + mha_out(lp["attn"], cfg.attention, o, cfg.float8_cfg, gate)
        return x, rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps,
                           cfg.rms_norm_type == "zero_centered")

    def _dense_post(self, x, o, lp, gate, compute_dtype):
        lp = cast_tree(lp, compute_dtype)
        x, h = self._attn_out(x, o, lp, gate)
        return x + mlp_forward(lp["mlp"], h, self.cfg.hidden_act, self.cfg.float8_cfg)

    def _layer_fn(self, post, cos, sin, segment_ids, compute_dtype, remat: str, window=None):
        """One decoder layer `(x, lp) -> post(x, attention out, lp, gate)`
        under the remat policy, its attention with the sliding `window`
        (None: full)."""
        def pre(x, lp):
            return self._attn_in(x, lp, cos, sin, compute_dtype)

        attn = self.cfg.attention
        # MLA's head_dim is its rope dim: its scale is on qk_head_dim, with yarn's mscale
        scale = (mla_softmax_scale(attn, self.cfg.rope_scaling_cfg)
                 if isinstance(attn, MLAConfig) else attn.head_dim ** -0.5)

        def attend(qkv_fn, *inputs):
            o, _ = flash_attention_saving_out_lse(qkv_fn, inputs, segment_ids, scale=scale,
                                                  window=window)
            return o

        return remat_wrap(pre, attend, post, remat)

    def _dsa_layer_fn(self, ffn, cos, sin, segment_ids, compute_dtype, remat: str):
        """One DSA decoder layer `(x, lp) -> (*ffn(x, normed h, lp), indexer
        loss)` (JAX `_layer_forward`'s DSA branch) under the remat policy;
        `ffn` is the MLP or MoE block after the post-attention norm, `lp`
        already in the compute dtype, returning a tuple led by x."""
        cfg = self.cfg
        zc = cfg.rms_norm_type == "zero_centered"

        def layer(x, lp):
            lp = cast_tree(lp, compute_dtype)
            h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
            h, _, idx_loss = dsa_forward(lp["attn"], cfg.attention, h, cos, sin, segment_ids,
                                         rope_scaling=cfg.rope_scaling_cfg)
            x = x + h
            h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
            return (*ffn(x, h, lp), idx_loss)

        if remat == "none":
            return layer
        if remat == "full":  # the whole layer, indexer included, as JAX's checkpoint
            return lambda x, lp: checkpoint(layer, x, lp, use_reentrant=False)
        raise not_ported(f"remat policy {remat!r} with DSA attention", "train-slice")

    def _dense_ffn(self, x, h, lp):
        return (x + mlp_forward(lp["mlp"], h, self.cfg.hidden_act, self.cfg.float8_cfg),)

    def _dense_layer_fn(self, cos, sin, segment_ids, compute_dtype, remat: str):
        """One dense decoder layer `(x, lp) -> (x, indexer loss or None)`."""
        if _is_dsa(self.cfg.attention):
            return self._dsa_layer_fn(self._dense_ffn, cos, sin, segment_ids, compute_dtype,
                                      remat)
        fn = self._layer_fn(lambda x, o, lp, gate: self._dense_post(x, o, lp, gate,
                                                                    compute_dtype),
                            cos, sin, segment_ids, compute_dtype, remat, self._cfg_window())
        return lambda x, lp: (fn(x, lp), None)

    def _embed_and_rope(self, params, seq_ctx, compute_dtype):
        self.check_ported()
        cfg = self.cfg
        if seq_ctx.inputs_embeds is not None:
            x = seq_ctx.inputs_embeds.to(compute_dtype)
        else:
            x = embed_tokens(params, seq_ctx.input_ids, compute_dtype)
        cos, sin = model_rope_cos_sin(seq_ctx, _rope_dim(cfg.attention), cfg.rope_theta,
                                      cfg.rope_scaling_cfg, cfg.max_position_embeddings)
        return x, cos, sin, seq_ctx.segment_ids.to(torch.int32).contiguous()

    def _final_norm(self, params, x, compute_dtype):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"].float(), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")
        return x.to(compute_dtype)

    def _forward_aux(self, params, seq_ctx, compute_dtype, remat):
        """-> (final hidden states (B, L, H) in compute dtype, the summed
        indexer loss (None without DSA))."""
        self.check_trainable()
        x, cos, sin, seg = self._embed_and_rope(params, seq_ctx, compute_dtype)
        stack = params["layers"]
        layer_fn = self._dense_layer_fn(cos, sin, seg, compute_dtype, remat)
        idx_losses = []
        for i in range(num_layers(stack)):
            x, idx_loss = layer_fn(x, layer_params(stack, i))
            x = add_deepstack(x, seq_ctx.deepstack_embeds, i)
            idx_losses.append(idx_loss)
        idx = torch.stack(idx_losses).sum() if _is_dsa(self.cfg.attention) else None
        return self._final_norm(params, x, compute_dtype), idx

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        """-> final hidden states (B, L, H) in compute dtype."""
        return self._forward_aux(params, seq_ctx, compute_dtype, remat)[0]

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full") -> ModelOutputs:
        hidden, idx_loss = self._forward_aux(params, seq_ctx, compute_dtype, remat)
        w = self.lm_head_weight(params).to(compute_dtype)
        loss, sum_ce, num_tokens = ce_loss(hidden, w, shifted_labels, loss_weights,
                                           global_denom, self.cfg.lm_loss_cfg)
        out = ModelOutputs(loss=loss, sum_ce=sum_ce, num_tokens=num_tokens)
        if idx_loss is not None:
            out.dsa_index_loss = self.cfg.dsa_index_loss_coef * idx_loss
        return out
