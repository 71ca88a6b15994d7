"""Multi-head latent attention, MLA (counterpart: `xtuner_tpu/module/mla.py`).

The config (`MLAConfig`, with its `qk_head_dim`, `num_key_value_heads` and
`head_dim` properties: `head_dim` is the rope dim, which
`module/rope.py::_rope_dim` reads), the parameter specs, the softmax scale
and the rope de-interleave, and `mla_project`: the low-rank q and kv
projections with per-head k and v materialised and rope on the rope split,
which DSA (`module/dsa.py`) trains on.

Not ported yet: plain MLA attention, `mla_forward` (the flash kernels at
q/k dim 192 and v dim 128; the port's flash kernels take head_dim 128 only),
and the compressed-KV decode `mla_cached_forward` ([mla]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import not_ported
from ..ops.rms_norm import rms_norm
from ..ops.rotary import apply_rotary_emb
from .mlp import linear
from .params import ParamSpec


@dataclass
class MLAConfig:
    """Same fields and defaults as the JAX MLAConfig."""

    num_attention_heads: int
    q_lora_rank: Optional[int] = None  # None = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    qk_norm: bool = False
    with_sinks: bool = False
    qkv_bias: bool = False
    o_bias: bool = False
    sliding_window: Optional[int] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    # compat with MHAConfig consumers
    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.qk_rope_head_dim  # rope is applied over this dim


def mla_param_specs(cfg: MLAConfig, hidden_size: int, init_scale: float = 0.02) -> dict:
    h = hidden_size
    nh = cfg.num_attention_heads
    specs: dict = {}
    if cfg.q_lora_rank is not None:
        specs["q_a_proj"] = {"w": ParamSpec((h, cfg.q_lora_rank), scale=init_scale)}
        specs["q_a_norm"] = ParamSpec((cfg.q_lora_rank,), init="ones")
        specs["q_b_proj"] = {"w": ParamSpec((cfg.q_lora_rank, nh * cfg.qk_head_dim),
                                            scale=init_scale)}
    else:
        specs["q_proj"] = {"w": ParamSpec((h, nh * cfg.qk_head_dim), scale=init_scale)}
    specs["kv_a_proj"] = {"w": ParamSpec((h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                                         scale=init_scale)}
    specs["kv_a_norm"] = ParamSpec((cfg.kv_lora_rank,), init="ones")
    specs["kv_b_proj"] = {"w": ParamSpec(
        (cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)), scale=init_scale)}
    specs["o_proj"] = {"w": ParamSpec((nh * cfg.v_head_dim, h), scale=init_scale)}
    return specs


def mla_softmax_scale(cfg: MLAConfig, rope_scaling=None) -> float:
    scale = cfg.qk_head_dim ** -0.5
    if rope_scaling is not None and getattr(rope_scaling, "rope_type", None) == "yarn" \
            and getattr(rope_scaling, "mscale_all_dim", None):
        m = 0.1 * rope_scaling.mscale_all_dim * math.log(rope_scaling.factor) + 1.0
        scale = scale * m * m
    return scale


def _deinterleave_rope(t: torch.Tensor) -> torch.Tensor:
    """(..., d) interleaved pairs (x0,y0,x1,y1,...) -> half-split (x..., y...)."""
    *lead, d = t.shape
    return t.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def mla_project(p: dict, cfg: MLAConfig, x: torch.Tensor, cos, sin):
    """The MLA projections of JAX `mla_forward` / `dsa_forward` up to the
    attention: x (B, L, H) -> q_full, k_full (B, L, nh, qk_head_dim) and
    v (B, L, nh, v_head_dim), contiguous, in x's dtype. k's rope part is
    shared by every head (broadcast, then materialised by the concat)."""
    b, l, _ = x.shape
    nh = cfg.num_attention_heads
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank is not None:
        q = linear(x, p["q_a_proj"])
        q = rms_norm(q, p["q_a_norm"], cfg.rms_norm_eps)
        q = linear(q, p["q_b_proj"])
    else:
        q = linear(x, p["q_proj"])
    q = q.reshape(b, l, nh, cfg.qk_head_dim)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv = linear(x, p["kv_a_proj"])
    kv_c, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    kv_c = rms_norm(kv_c, p["kv_a_norm"], cfg.rms_norm_eps)
    kv = linear(kv_c, p["kv_b_proj"]).reshape(b, l, nh, dn + cfg.v_head_dim)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    # HF DeepSeek checkpoints store the rope dims interleaved: de-interleave
    # to the half-split layout before rotate-half rope (JAX mla.py:190-198)
    k_rope = _deinterleave_rope(k_rope[:, :, None, :])
    q_rope = _deinterleave_rope(q_rope)
    q_rope, k_rope = apply_rotary_emb(q_rope, k_rope, cos, sin)
    k_rope = k_rope.expand(b, l, nh, cfg.qk_rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    return q_full, k_full, v.contiguous()


def mla_forward(p: dict, cfg: MLAConfig, x, cos, sin, segment_ids, rope_scaling=None,
                **_):
    raise not_ported("plain MLA attention (flash at q/k dim 192, v dim 128)", "mla")


def mla_cached_forward(p: dict, cfg: MLAConfig, x, cos, sin, cache_c, cache_r, cache_len,
                       rope_scaling=None, kv_mask=None):
    raise not_ported("compressed-KV MLA decode", "mla")
