"""Dense decoder-only transformer (counterpart: `xtuner_tpu/model/dense.py`).

The parameter tree (`param_specs`), `lm_head_weight`, and the training
`forward`/`loss`. Decoder layers are stored stacked with a leading L dim,
as in the JAX tree; a layer stack may also be given as a list of per-layer
dicts (what the engine trains on, so each layer's gradient is its own
tensor). Remat "full", "none", "save_attn", "save_attn_residuals" and
"save_out_lse" are ported (`remat_wrap`); the other selective policies
raise ([train-slice]).
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

LoRA and QLoRA (`lora_cfg`, `module/lora.py`): adapters on the targeted
MHA projections and MLP projections, applied at alpha / r in the layer
forward (JAX `dense.py:148`); MLA and DSA attention get none, as JAX gives
them none, while their MLP does. `param_labels` freezes everything but the
adapters (and the norms / embedding on request), `hf_key_map` maps the
adapters to `<random>` and a QLoRA base to `nf4_pack` / `nf4_scale` of its
HF weight, and `merge_lora` folds the adapters in for a plain export.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..checkpoint.spec import HFKey
from ..loss.ce_loss import ce_loss
from ..module.attention import MHAConfig, mha_out, mha_param_specs, mha_qkv
from ..module.lora import lora_param_labels, lora_scaling, merge_lora
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
      its gate would be one more saved or recomputed input of `post`;
    - "save_attn": the layer's input and the attention's output before the
      o-projection (JAX saves only `attn_out`, `module/attention.py:144`);
      `pre` with the attention is one checkpoint region and `post` another.
      The backward re-runs `pre` and the flash forward (#1, for lse), then
      the backward kernels, then `post` from x and the saved out. JAX's
      checkpoint re-runs its forward kernel too: its residuals
      `attn_res_out` / `attn_lse` are not among the saved names (its
      comment at `model/dense.py:36-37` says otherwise). Held per layer: x and out, (B, L, H) and (B, L, Hq Dv)
      in the compute dtype. A gated attention raises ([train-slice]): its
      gate is not among the saved names.

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
    if remat == "save_attn":
        def attn_only(x, lp):
            *qkv, gate = pre(x, lp)
            if gate is not None:
                raise not_ported("gated attention under remat 'save_attn'", "train-slice")
            return attend_qkv(*qkv)

        def saving_attn(x, lp):
            o = checkpoint(attn_only, x, lp, use_reentrant=False)
            return checkpoint(post, x, o, lp, None, use_reentrant=False)
        return saving_attn
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


def _all_train(tree):
    if isinstance(tree, dict):
        return {k: _all_train(v) for k, v in tree.items()}
    return "train"


def embed_tokens(params, input_ids: torch.Tensor, dtype) -> torch.Tensor:
    w = params["embed"]["w"]
    b, l = input_ids.shape
    return w.index_select(0, input_ids.reshape(-1).long()).reshape(b, l, -1).to(dtype)


def _is_dsa(attn_cfg) -> bool:
    return isinstance(attn_cfg, DSAConfig)


def _attn_param_specs(cfg, lora=None) -> dict:
    """Attention spec dispatch, JAX's order: DSA > MLA > MHA (adapters on
    MHA only, as JAX's)."""
    if _is_dsa(cfg.attention):
        return dsa_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)
    if isinstance(cfg.attention, MLAConfig):
        return mla_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale)
    return mha_param_specs(cfg.attention, cfg.hidden_size, cfg.init_scale, lora)


def _lora_keys(proj: dict, name: str, lora) -> None:
    """A projection's HF keys under LoRA (JAX `Dense._mlp_key_map` and the
    MHA map): `<random>` adapters, and under QLoRA the NF4 codes and
    scales read from the dense HF weight in place of `w`."""
    if lora is None or name not in lora.target_modules:
        return
    proj["lora_a"] = HFKey("<random>")
    proj["lora_b"] = HFKey("<random>")
    if lora.qlora:
        tmpl = proj.pop("w").template
        proj["w_q4"] = HFKey(tmpl, "nf4_pack")
        proj["w_absmax"] = HFKey(tmpl, "nf4_scale")


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

    def layer_param_specs(self) -> dict:
        cfg = self.cfg
        return {
            "attn": _attn_param_specs(cfg, cfg.lora_cfg),
            "mlp": mlp_param_specs(cfg.hidden_size, cfg.intermediate_size,
                                   cfg.init_scale, cfg.mlp_bias, cfg.lora_cfg),
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

    def param_labels(self, params_or_specs) -> dict:
        """"train" / "freeze" for every leaf: LoRA freezes all but the
        adapters (JAX `Dense.param_labels`)."""
        if self.cfg.lora_cfg is None:
            return _all_train(params_or_specs)
        return lora_param_labels(params_or_specs, self.cfg.lora_cfg)

    def merge_lora(self, params):
        """The adapters folded into their bases (`module/lora.py::merge_lora`);
        the params themselves without LoRA."""
        if self.cfg.lora_cfg is None:
            return params
        return merge_lora(params, self.cfg.lora_cfg.scaling)

    def plain_config(self):
        """This config without LoRA: the layout of a merged export."""
        return dataclasses.replace(self.cfg, lora_cfg=None)

    # ------------------------------------------------------------------
    def _mlp_key_map(self) -> dict:
        mlp = {name: {"w": HFKey(f"model.layers.{{layer}}.mlp.{name}.weight", "linear")}
               for name in ("gate_proj", "up_proj", "down_proj")}
        for name, proj in mlp.items():
            _lora_keys(proj, name, self.cfg.lora_cfg)
        return mlp

    def _mla_key_map(self) -> dict:
        attn: dict = {
            "kv_a_proj": {"w": HFKey("model.layers.{layer}.self_attn.kv_a_proj_with_mqa.weight",
                                     "linear")},
            "kv_a_norm": HFKey("model.layers.{layer}.self_attn.kv_a_layernorm.weight"),
            "kv_b_proj": {"w": HFKey("model.layers.{layer}.self_attn.kv_b_proj.weight", "linear")},
            "o_proj": {"w": HFKey("model.layers.{layer}.self_attn.o_proj.weight", "linear")},
        }
        if self.cfg.attention.q_lora_rank is not None:
            attn["q_a_proj"] = {"w": HFKey("model.layers.{layer}.self_attn.q_a_proj.weight",
                                           "linear")}
            attn["q_a_norm"] = HFKey("model.layers.{layer}.self_attn.q_a_layernorm.weight")
            attn["q_b_proj"] = {"w": HFKey("model.layers.{layer}.self_attn.q_b_proj.weight",
                                           "linear")}
        else:
            attn["q_proj"] = {"w": HFKey("model.layers.{layer}.self_attn.q_proj.weight",
                                         "linear")}
        return attn

    def _mha_key_map(self) -> dict:
        a = self.cfg.attention
        attn: dict = {name: {"w": HFKey(f"model.layers.{{layer}}.self_attn.{name}.weight",
                                        "linear")}
                      for name in ("q_proj", "k_proj", "v_proj", "o_proj")}
        for name, proj in attn.items():
            _lora_keys(proj, name, self.cfg.lora_cfg)
        if a.qkv_bias:
            for name in ("q_proj", "k_proj", "v_proj"):
                attn[name]["b"] = HFKey(f"model.layers.{{layer}}.self_attn.{name}.bias")
        if a.o_bias:
            attn["o_proj"]["b"] = HFKey("model.layers.{layer}.self_attn.o_proj.bias")
        if a.qk_norm:
            attn["q_norm"] = HFKey("model.layers.{layer}.self_attn.q_norm.weight")
            attn["k_norm"] = HFKey("model.layers.{layer}.self_attn.k_norm.weight")
        if a.with_sinks:
            attn["sinks"] = HFKey("model.layers.{layer}.self_attn.sinks")
        return attn

    def _attn_key_map(self) -> dict:
        """JAX's dispatch: MLA's keys, else MHA's; DSA's indexer has none
        in JAX's map, so DSA raises."""
        if _is_dsa(self.cfg.attention):
            raise not_ported("HF keys of DSA attention", "serve-rest")
        if isinstance(self.cfg.attention, MLAConfig):
            return self._mla_key_map()
        return self._mha_key_map()

    def hf_key_map(self) -> dict:
        """The HF key of every param leaf (JAX `Dense.hf_key_map`, the MHA
        and MLA branches; `checkpoint/spec.py::HFKey`)."""
        cfg = self.cfg
        self.check_ported()
        if cfg.rope_scaling_cfg is not None and cfg.rope_scaling_cfg.use_fope:
            raise not_ported("FoPE's HF keys", "vlm")
        mlp = self._mlp_key_map()
        if cfg.mlp_bias:
            for name in mlp:
                mlp[name]["b"] = HFKey(f"model.layers.{{layer}}.mlp.{name}.bias")
        keymap: dict = {
            "embed": {"w": HFKey("model.embed_tokens.weight")},
            "layers": {
                "attn": self._attn_key_map(),
                "mlp": mlp,
                "input_norm": HFKey("model.layers.{layer}.input_layernorm.weight"),
                "post_attn_norm": HFKey("model.layers.{layer}.post_attention_layernorm.weight"),
            },
            "final_norm": HFKey("model.norm.weight"),
        }
        if not cfg.tie_word_embeddings:
            keymap["lm_head"] = {"w": HFKey("lm_head.weight", "linear")}
        return keymap

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
        return mha_qkv(p, cfg.attention, h, cos, sin, lora_scaling(self.cfg), cfg.float8_cfg)

    def _attn_out(self, x, o, lp, gate=None):
        """The output gate (None: none) -> o-proj -> residual -> norm; `lp`
        already in the compute dtype. Returns (x, normed h)."""
        cfg = self.cfg
        if isinstance(cfg.attention, MLAConfig):
            x = x + mla_out(lp["attn"], cfg.attention, o)
        else:
            x = x + mha_out(lp["attn"], cfg.attention, o, cfg.float8_cfg, gate,
                            lora_scaling(self.cfg))
        return x, rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps,
                           cfg.rms_norm_type == "zero_centered")

    def _dense_post(self, x, o, lp, gate, compute_dtype):
        lp = cast_tree(lp, compute_dtype)
        x, h = self._attn_out(x, o, lp, gate)
        return x + mlp_forward(lp["mlp"], h, self.cfg.hidden_act, self.cfg.float8_cfg,
                               lora_scaling(self.cfg))

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
        return (x + mlp_forward(lp["mlp"], h, self.cfg.hidden_act, self.cfg.float8_cfg,
                                lora_scaling(self.cfg)),)

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
