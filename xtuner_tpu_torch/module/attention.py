"""Multi-head (GQA) attention (counterpart: `xtuner_tpu/module/attention.py`).

The training attention over packed rows (JAX `mha_forward`) is
`mha_qkv`, `mha_attend` and `mha_out` in a row: projections, qk-norm with
its proven max-logit bound (which lets the flash forward run its max-free
variant), partial rotary; the differentiable flash attention of
`ops/attention/flash.py` (the Hopper kernels on a card); the output
projection. The model calls the three itself, so that the remat policy
"save_attn_residuals" can checkpoint the first and the last apart and
run the flash kernel between them once.

`mha_cached_forward` is ported for the prefill the paged engine runs: a
whole right-padded prompt at `cache_len = 0`. Its attention is causal over
one segment with the padding masked out, which is what the flash forward
computes with `segment_ids = kv_mask`. Query rows at padding get zeros
there where the JAX einsum gives unused values; real rows agree.

The training projections run in fp8 when the model's `float8_cfg` is
enabled (`module/mlp.py::linear` -> `ops/float8.py::fp8_matmul`), as JAX's
`lora_linear` does; the serving prefill stays in the compute dtype, as in
JAX.

Not ported yet: a non-zero `cache_len` (chunked prefill and the dense
decode engine), output gating, sinks and sliding windows ([serve-rest]) and
LoRA ([lora]).
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

    def check_ported(self) -> None:
        """Raise for the variants the port does not run yet."""
        if self.with_gate:
            raise not_ported("gated attention (with_gate)", "serve-rest")
        if self.with_sinks:
            raise not_ported("attention sinks", "serve-rest")


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
    k, v (B, C, Hkv, D), in x's dtype."""
    cfg.check_ported()
    b, c, _ = x.shape
    q = linear(x, p["q_proj"], fp8_cfg).reshape(b, c, cfg.num_attention_heads, cfg.head_dim)
    k = linear(x, p["k_proj"], fp8_cfg).reshape(b, c, cfg.num_key_value_heads, cfg.head_dim)
    v = linear(x, p["v_proj"], fp8_cfg).reshape(b, c, cfg.num_key_value_heads, cfg.head_dim)
    if cfg.qk_norm:
        zc = cfg.rms_norm_type == "zero_centered"
        q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps, zc)
        k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps, zc)
    q, k = apply_partial_rotary(q, k, cos, sin, cfg.rope_dim)
    return q, k, v


def mha_qkv(p: dict, cfg: MHAConfig, x, cos, sin, window: Optional[int] = None,
            lora_scaling: float = 1.0, fp8_cfg=None):
    """The training attention before the flash kernel: x (B, L, hidden) ->
    contiguous q (B, L, Hq, D), k, v (B, L, Hkv, D) and the max-logit
    bound (None without qk-norm)."""
    if window:
        raise not_ported("sliding-window attention", "serve-rest")
    if lora_scaling != 1.0 or any(k.startswith("lora") for k in p["q_proj"]):
        raise not_ported("LoRA projections", "lora")
    q, k, v = project_qkv(p, cfg, x, cos, sin, fp8_cfg)
    max_logit = None
    if cfg.qk_norm:
        # provable |scaled logit| bound: normed rows have ||x|| = sqrt(d), so
        # |q.k|/sqrt(d) <= sqrt(d) * max|g_q| * max|g_k|; rope keeps norms.
        # It stays on the device: the flash kernel reads it there.
        gq, gk = p["q_norm"].detach().float(), p["k_norm"].detach().float()
        if cfg.rms_norm_type == "zero_centered":
            gq, gk = 1.0 + gq, 1.0 + gk
        max_logit = cfg.head_dim ** 0.5 * gq.abs().max() * gk.abs().max()
    return q.contiguous(), k.contiguous(), v.contiguous(), max_logit


def mha_attend(cfg: MHAConfig, q, k, v, segment_ids, max_logit=None):
    """The differentiable flash attention: (B, L, Hq, D) in q.dtype. Its
    autograd Function keeps q, k, v, out and lse for the backward."""
    o, _ = flash_attention(q, k, v, segment_ids, scale=cfg.head_dim ** -0.5,
                           max_logit=max_logit)
    return o


def mha_out(p: dict, cfg: MHAConfig, o, fp8_cfg=None):
    """o (B, L, Hq, D) -> the output projection (B, L, hidden)."""
    b, l = o.shape[:2]
    return linear(o.reshape(b, l, cfg.q_dim()), p["o_proj"], fp8_cfg)


def mha_cached_forward(p: dict, cfg: MHAConfig, x, cos, sin, cache_k, cache_v,
                       cache_len: int, window: Optional[int] = None,
                       kv_mask: Optional[torch.Tensor] = None):
    """Prefill of a fresh cache. x: (B, C, H); cache_k/v: (B, S_max, Hkv, D)
    with C <= S_max; kv_mask (B, S_max) bool, False = padding slot.
    Writes the chunk's K/V into cache[:, :C] IN PLACE (the JAX function
    returns an updated copy) and returns (out (B, C, H), cache_k, cache_v)."""
    if cache_len != 0:
        raise not_ported("attention over a non-empty dense cache (cache_len > 0)",
                         "serve-rest")
    if window:
        raise not_ported("sliding-window attention", "serve-rest")
    b, c, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, cos, sin)
    cache_k[:, :c] = k
    cache_v[:, :c] = v
    if kv_mask is None:
        seg = torch.ones((b, c), dtype=torch.int32, device=x.device)
    else:
        seg = kv_mask[:, :c].to(torch.int32).contiguous()
    # at cache_len 0 causality keeps every slot past C out of reach, so
    # attending the chunk's own K/V (in the cache dtype) is attending the cache
    o, _ = flash_attention(q.to(cache_k.dtype), k.to(cache_k.dtype),
                           v.to(cache_v.dtype), seg, scale=cfg.head_dim ** -0.5)
    o = o.to(x.dtype).reshape(b, c, cfg.q_dim())
    return linear(o, p["o_proj"]), cache_k, cache_v
