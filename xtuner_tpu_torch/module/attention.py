"""Multi-head (GQA) attention (counterpart: `xtuner_tpu/module/attention.py`).

The training attention over packed rows (JAX `mha_forward`) is `mha_qkv`,
the differentiable flash attention of `ops/attention/flash.py` (the Hopper
kernels on a card) and `mha_out` in a row: projections, qk-norm with its
proven max-logit bound (which lets the flash forward run its max-free
variant), partial rotary, the GPT-OSS sinks and the output gate; the
attention, with the layer's sliding window; the gate and the output
projection. The model calls the three itself
(`model/dense.py::remat_wrap`), so that each remat policy can checkpoint
them apart or, under "save_out_lse", run the attention over `mha_qkv` and
keep only the flash output and lse.

`mha_cached_forward` at `cache_len = 0` is the prefill of a fresh cache
(the paged engine's right-padded prompts, the dense `generate`'s
left-padded ones). Its attention is causal over one segment with the
padding masked out, which is what the flash forward computes with
`segment_ids = kv_mask`, with the layer's sliding window and GPT-OSS sinks
(JAX `mha_cached_forward`'s mask and sink softmax) passed to it. Query
rows at padding get zeros there where the JAX einsum gives unused values;
real rows agree. At `cache_len > 0` (the dense decode of
`model/generate.py`) C new rows attend the whole dense cache in plain
PyTorch, as JAX does it in `jnp.einsum` with no Pallas kernel: GQA by head
groups with no repeat of the cache, f32 logits from the cache-dtype
operands, the causal, window and `kv_mask` masks, the sinks in the softmax
denominator, probabilities cast to the cache dtype before the value
product.

Gated attention (`with_gate`, Qwen3.5 / Qwen3-Next): `q_proj` emits each
head's q and its output gate side by side, (q_h | gate_h) per head, as JAX
reshapes it to (B, L, Hq, 2D) and splits the last axis; the attention
output is multiplied by sigmoid(gate) (taken in f32, cast to the output's
dtype, as JAX does) before `o_proj`. `project_qkv` and `mha_qkv` return
the gate, `mha_out` and `mha_cached_forward` apply it, and so does the
paged engine's decode layer. In training the gate multiplies the flash
output after the point JAX names `attn_out` for its remat policies, as
JAX's `mha_forward` does.

The training projections run in fp8 when the model's `float8_cfg` is
enabled (`module/mlp.py::linear` -> `ops/float8.py::fp8_matmul`), as JAX's
`lora_linear` does; the serving prefill stays in the compute dtype, as in
JAX.

Not ported yet: LoRA ([lora]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import not_ported
from ..ops.attention.flash import flash_attention
from ..ops.rms_norm import rms_norm
from ..ops.rotary import apply_rotary_emb
from .mlp import linear
from .params import ParamSpec


@dataclass
class MHAConfig:
    """Same fields and defaults as the JAX MHAConfig."""

    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    o_bias: bool = False
    sliding_window: Optional[int] = None
    with_sinks: bool = False
    rms_norm_eps: float = 1e-6
    rms_norm_type: str = "default"  # default | zero_centered
    with_gate: bool = False
    partial_rotary_factor: float = 1.0

    @property
    def rope_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim


def mha_param_specs(cfg: MHAConfig, hidden_size: int, init_scale: float = 0.02) -> dict:
    q_out = cfg.q_dim() * (2 if cfg.with_gate else 1)
    specs: dict = {
        "q_proj": {"w": ParamSpec((hidden_size, q_out), scale=init_scale)},
        "k_proj": {"w": ParamSpec((hidden_size, cfg.kv_dim()), scale=init_scale)},
        "v_proj": {"w": ParamSpec((hidden_size, cfg.kv_dim()), scale=init_scale)},
        "o_proj": {"w": ParamSpec((cfg.q_dim(), hidden_size), scale=init_scale)},
    }
    if cfg.qkv_bias:
        specs["q_proj"]["b"] = ParamSpec((cfg.q_dim(),), init="zeros")
        specs["k_proj"]["b"] = ParamSpec((cfg.kv_dim(),), init="zeros")
        specs["v_proj"]["b"] = ParamSpec((cfg.kv_dim(),), init="zeros")
    if cfg.o_bias:
        specs["o_proj"]["b"] = ParamSpec((hidden_size,), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((cfg.head_dim,), init="ones")
        specs["k_norm"] = ParamSpec((cfg.head_dim,), init="ones")
    if cfg.with_sinks:
        specs["sinks"] = ParamSpec((cfg.num_attention_heads,), init="zeros")
    return specs


def apply_partial_rotary(q, k, cos, sin, rope_dim: int):
    """Rotate only the first `rope_dim` dims of each head; cos/sin are
    (B, L, rope_dim)."""
    if rope_dim == q.shape[-1]:
        return apply_rotary_emb(q, k, cos, sin)
    q_rot, k_rot = apply_rotary_emb(q[..., :rope_dim], k[..., :rope_dim], cos, sin)
    return (torch.cat([q_rot, q[..., rope_dim:]], dim=-1),
            torch.cat([k_rot, k[..., rope_dim:]], dim=-1))


def project_qkv(p: dict, cfg: MHAConfig, x, cos, sin, fp8_cfg=None):
    """Projections, qk-norm and rope: x (B, C, H) -> q (B, C, Hq, D),
    k, v (B, C, Hkv, D), in x's dtype, and the output gate (B, C, Hq, D)
    with `with_gate` (else None)."""
    b, c, _ = x.shape
    gate = None
    if cfg.with_gate:  # (q_h | gate_h) per head
        qg = linear(x, p["q_proj"], fp8_cfg).reshape(b, c, cfg.num_attention_heads,
                                                      2 * cfg.head_dim)
        q, gate = qg[..., :cfg.head_dim], qg[..., cfg.head_dim:]
    else:
        q = linear(x, p["q_proj"], fp8_cfg).reshape(b, c, cfg.num_attention_heads,
                                                    cfg.head_dim)
    k = linear(x, p["k_proj"], fp8_cfg).reshape(b, c, cfg.num_key_value_heads, cfg.head_dim)
    v = linear(x, p["v_proj"], fp8_cfg).reshape(b, c, cfg.num_key_value_heads, cfg.head_dim)
    if cfg.qk_norm:
        zc = cfg.rms_norm_type == "zero_centered"
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps, zc)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps, zc)
    q, k = apply_partial_rotary(q, k, cos, sin, cfg.rope_dim)
    return q, k, v, gate


def apply_gate(o, gate):
    """o (B, C, Hq D) times sigmoid(gate (B, C, Hq, D)), the sigmoid in f32
    cast to o's dtype (JAX `mha_forward`); o itself without a gate."""
    if gate is None:
        return o
    return o * torch.sigmoid(gate.float()).to(o.dtype).reshape(o.shape)


def mha_qkv(p: dict, cfg: MHAConfig, x, cos, sin, lora_scaling: float = 1.0, fp8_cfg=None):
    """The training attention before the flash kernel: x (B, L, hidden) ->
    contiguous q (B, L, Hq, D), k, v (B, L, Hkv, D), the max-logit bound
    (None without qk-norm), the per-head sinks `p["sinks"]` (Hq,) (None
    without `with_sinks`), which the flash attention folds in and
    differentiates, as JAX `mha_forward` passes them, and the output gate
    (B, L, Hq, D) that `mha_out` applies (None without `with_gate`)."""
    if lora_scaling != 1.0 or any(k.startswith("lora") for k in p["q_proj"]):
        raise not_ported("LoRA projections", "lora")
    q, k, v, gate = project_qkv(p, cfg, x, cos, sin, fp8_cfg)
    max_logit = None
    if cfg.qk_norm:
        # provable |scaled logit| bound: normed rows have ||x|| = sqrt(d), so
        # |q.k|/sqrt(d) <= sqrt(d) * max|g_q| * max|g_k|; rope keeps norms.
        # It stays on the device: the flash kernel reads it there.
        gq, gk = p["q_norm"].detach().float(), p["k_norm"].detach().float()
        if cfg.rms_norm_type == "zero_centered":
            gq, gk = 1.0 + gq, 1.0 + gk
        max_logit = cfg.head_dim ** 0.5 * gq.abs().max() * gk.abs().max()
    sinks = p["sinks"] if cfg.with_sinks else None
    return q.contiguous(), k.contiguous(), v.contiguous(), max_logit, sinks, gate


def mha_out(p: dict, cfg: MHAConfig, o, fp8_cfg=None, gate=None):
    """o (B, L, Hq, D) -> the output projection (B, L, hidden), after the
    output gate (`project_qkv`'s, with `with_gate`)."""
    b, l = o.shape[:2]
    return linear(apply_gate(o.reshape(b, l, cfg.q_dim()), gate), p["o_proj"], fp8_cfg)


def mha_cached_forward(p: dict, cfg: MHAConfig, x, cos, sin, cache_k, cache_v,
                       cache_len: int, window: Optional[int] = None,
                       kv_mask: Optional[torch.Tensor] = None):
    """Incremental attention. x: (B, C, H) the new rows at cache slots
    [cache_len, cache_len + C); cache_k/v: (B, S_max, Hkv, D); kv_mask
    (B, S_max) bool, False = padding slot, never attended; window: a
    sliding window (None or <= 0: full); the sinks are `p["sinks"]` when
    present. Writes the chunk's K/V into cache[:, cache_len:cache_len + C]
    IN PLACE (the JAX function returns an updated copy) and returns (out
    (B, C, H), cache_k, cache_v)."""
    b, c, _ = x.shape
    q, k, v, gate = project_qkv(p, cfg, x, cos, sin)
    cache_k[:, cache_len:cache_len + c] = k
    cache_v[:, cache_len:cache_len + c] = v
    win = window if window and window > 0 else None
    if cache_len == 0:
        if kv_mask is None:
            seg = torch.ones((b, c), dtype=torch.int32, device=x.device)
        else:
            seg = kv_mask[:, :c].to(torch.int32).contiguous()
        # at cache_len 0 causality keeps every slot past C out of reach, so
        # attending the chunk's own K/V (in the cache dtype) is attending the cache
        o, _ = flash_attention(q.to(cache_k.dtype), k.to(cache_k.dtype),
                               v.to(cache_v.dtype), seg, scale=cfg.head_dim ** -0.5,
                               window=win, sinks=p.get("sinks"))
        return mha_out(p, cfg, o.to(x.dtype), gate=gate), cache_k, cache_v
    o = cached_attention(q, cache_k, cache_v, cache_len, cfg.head_dim ** -0.5, win,
                         kv_mask, p.get("sinks"))
    return mha_out(p, cfg, o.to(x.dtype), gate=gate), cache_k, cache_v


def cached_attention(q, cache_k, cache_v, cache_len: int, scale: float,
                     window: Optional[int] = None, kv_mask=None, sinks=None):
    """q (B, C, Hq, D) at slots [cache_len, cache_len + C) over the whole
    cache (B, S, Hkv, D) -> (B, C, Hq, D) f32 (JAX `mha_cached_forward`'s
    einsum attention). The q heads of a group share their kv head, with no
    repeat of the cache; the bf16 products are exact in f32, so the f32
    operands give the f32-accumulated logits JAX asks for."""
    b, c, hq, d = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, c, hkv, rep, d).to(cache_k.dtype).float()
    logits = torch.einsum("bcgrd,bsgd->bgrcs", qg, cache_k.float()) * scale
    logits = logits.reshape(b, hq, c, s_max)
    dev = q.device
    kpos = torch.arange(s_max, device=dev)[None, :]
    qpos = cache_len + torch.arange(c, device=dev)[:, None]
    mask = kpos <= qpos  # causal over the cache
    if window:
        mask = mask & (qpos - kpos < window)
    mask = mask[None, None]  # (1, 1, C, S)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :].bool()
    logits = logits.masked_fill(~mask, -1e30)
    if sinks is not None:
        sink = sinks.float()[None, :, None, None]
        m = torch.maximum(logits.amax(dim=-1, keepdim=True), sink)
        probs = torch.exp(logits - m)
        probs = probs / (probs.sum(dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        probs = torch.softmax(logits, dim=-1)
    pg = probs.reshape(b, hkv, rep, c, s_max).to(cache_v.dtype).float()
    return torch.einsum("bgrcs,bsgd->bcgrd", pg, cache_v.float()).reshape(b, c, hq, d)
