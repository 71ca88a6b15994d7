"""GatedDeltaNet module, Qwen3.5's linear attention (counterpart:
`xtuner_tpu/module/gated_deltanet.py`).

The recurrence lives in `ops/gated_deltanet.py`; this module adds the
projections: the fused qkvz and ba in-projections, the short causal
depthwise conv (document-boundary aware), l2-normalised q and k, the
decay (a) and learning-rate (b) gates, and the gated RMSNorm output
`rms_norm(o) * silu(z)`, computed in f32.

`gdn_forward` runs the chunked recurrence over packed rows, as JAX does.
`gdn_cached_forward` is the serving path: a prompt chunk or a C = 1
decode step continued from a per-slot state (S, conv buffer). JAX runs
the sequential scan there; the port runs one `gated_delta_rule_step` for
a decode step and, for a prompt, the chunked form with the initial and
final state (the same function, one Python step per 64 tokens instead of
one per token).

Not ported yet: `gdn_forward`'s Ulysses sequence parallelism (`sc`,
[parallelism]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.gated_deltanet import gated_delta_rule_chunked, gated_delta_rule_step
from .params import ParamSpec


@dataclass
class GatedDeltaNetConfig:
    """Same fields and defaults as the JAX GatedDeltaNetConfig."""

    num_v_heads: int = 8
    num_k_heads: int = 4
    head_k_dim: int = 64
    head_v_dim: int = 64
    conv_kernel_size: int = 4
    rms_norm_eps: float = 1e-6
    chunk_size: int = 64

    @property
    def qk_dim(self) -> int:
        return self.num_k_heads * self.head_k_dim

    @property
    def v_dim(self) -> int:
        return self.num_v_heads * self.head_v_dim

    @property
    def conv_channels(self) -> int:
        return 2 * self.qk_dim + self.v_dim


def gdn_param_specs(cfg: GatedDeltaNetConfig, hidden_size: int,
                    init_scale: float = 0.02) -> dict:
    h = hidden_size
    return {
        "in_proj_qkvz": {"w": ParamSpec((h, 2 * cfg.qk_dim + 2 * cfg.v_dim), scale=init_scale)},
        "in_proj_ba": {"w": ParamSpec((h, 2 * cfg.num_v_heads), scale=init_scale)},
        "conv_w": ParamSpec((cfg.conv_kernel_size, cfg.conv_channels), scale=init_scale),
        "a_log": ParamSpec((cfg.num_v_heads,), init="zeros"),
        "dt_bias": ParamSpec((cfg.num_v_heads,), init="zeros"),
        "norm": ParamSpec((cfg.head_v_dim,), init="ones"),
        "out_proj": {"w": ParamSpec((cfg.v_dim, h), scale=init_scale)},
    }


def _causal_depthwise_conv(x, w, segment_ids=None):
    """x: (B, L, C); w: (K, C). Per-channel causal conv; taps never cross
    document boundaries (packed-varlen semantics)."""
    k, l = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :l]
        if segment_ids is not None:
            seg_shift = F.pad(segment_ids, (i, 0))[:, :l]
            same = (seg_shift == segment_ids) & (segment_ids != 0)
            shifted = torch.where(same[..., None], shifted, torch.zeros_like(shifted))
        out = out + shifted * w[-1 - i]
    return out


def _l2norm(x, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + eps)


def _conv_with_buffer(x, w, buf, n_valid: Optional[torch.Tensor] = None):
    """The causal depthwise conv continued from a rolling buffer of the
    previous K-1 inputs. x: (B, C, ch); buf: (B, K-1, ch). Returns (out
    (B, C, ch), new_buf). `n_valid` (B,) int: a right-padded chunk whose
    first n_valid tokens are real, so the new buffer ends at token
    n_valid - 1, not at the padded tail."""
    k, c = w.shape[0], x.shape[1]
    ext = torch.cat([buf.to(x.dtype), x], dim=1)  # (B, K-1+C, ch)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + ext[:, k - 1 - i: k - 1 - i + c] * w[-1 - i]
    if k <= 1:
        return out, buf
    if n_valid is None:
        return out, ext[:, -(k - 1):]
    idx = n_valid.long()[:, None] + torch.arange(k - 1, device=x.device)[None]
    return out, torch.gather(ext, 1, idx[..., None].expand(-1, -1, ext.shape[-1]))


def _gates(p, cfg: GatedDeltaNetConfig, x):
    """beta (learning rate) and alpha (decay) (B, L, Hv) f32 from x."""
    b_lr, a_in = torch.chunk(x @ p["in_proj_ba"]["w"], 2, dim=-1)
    beta = torch.sigmoid(b_lr.float())
    g = -torch.exp(p["a_log"].float()) * F.softplus(a_in.float() + p["dt_bias"].float())
    return beta, torch.exp(g)


def _qkv(cfg: GatedDeltaNetConfig, qkv, b, l):
    """The conv's silu output split into l2-normed q, k (repeated to the v
    heads) and v."""
    hk, hv = cfg.num_k_heads, cfg.num_v_heads
    q, k, v = torch.split(qkv, [cfg.qk_dim, cfg.qk_dim, cfg.v_dim], dim=-1)
    q = _l2norm(q.reshape(b, l, hk, cfg.head_k_dim))
    k = _l2norm(k.reshape(b, l, hk, cfg.head_k_dim))
    rep = hv // hk
    if rep > 1:
        q = q.repeat_interleave(rep, dim=2)
        k = k.repeat_interleave(rep, dim=2)
    return q, k, v.reshape(b, l, hv, cfg.head_v_dim)


def _gated_out(p, cfg: GatedDeltaNetConfig, o, z, dtype):
    """The gated RMSNorm (FLA FusedRMSNormGated), in f32, then out_proj."""
    b, l = o.shape[:2]
    z = z.reshape(b, l, cfg.num_v_heads, cfg.head_v_dim).float()
    o32 = o.float()
    o32 = o32 * torch.rsqrt(o32.square().mean(dim=-1, keepdim=True) + cfg.rms_norm_eps)
    o32 = o32 * p["norm"].float() * F.silu(z)
    return o32.reshape(b, l, cfg.v_dim).to(dtype) @ p["out_proj"]["w"]


def gdn_cached_forward(p: dict, cfg: GatedDeltaNetConfig, x, state, conv_buf,
                       valid: Optional[torch.Tensor] = None,
                       n_valid: Optional[torch.Tensor] = None):
    """Incremental GDN for generation: x (B, C, H) a prompt chunk or a C = 1
    decode step; state (B, Hv, dk, dv) f32; conv_buf (B, K-1, conv
    channels). Returns (out (B, C, H), state', conv_buf'). `valid` (B, C)
    bool masks pad tokens: their input is zeroed before the conv and their
    update is a no-op (alpha 1, beta 0), so padding never reaches the
    state. `n_valid` (B,): right-padded prompt lengths, so the conv buffer
    ends at the last real token."""
    b, c, _ = x.shape
    if valid is not None:
        x = torch.where(valid[..., None], x, torch.zeros_like(x))
    q, k, v, z = torch.split(x @ p["in_proj_qkvz"]["w"],
                             [cfg.qk_dim, cfg.qk_dim, cfg.v_dim, cfg.v_dim], dim=-1)
    qkv, conv_buf = _conv_with_buffer(torch.cat([q, k, v], dim=-1), p["conv_w"], conv_buf,
                                      n_valid)
    q, k, v = _qkv(cfg, F.silu(qkv), b, c)
    beta, alpha = _gates(p, cfg, x)
    if valid is not None:  # pad tokens: no decay, no write
        alpha = torch.where(valid[..., None], alpha, torch.ones_like(alpha))
        beta = torch.where(valid[..., None], beta, torch.zeros_like(beta))
    if c == 1:
        state, o = gated_delta_rule_step(state, q[:, 0], k[:, 0], v[:, 0], alpha[:, 0],
                                         beta[:, 0])
        o = o[:, None]
    else:
        o, state = gated_delta_rule_chunked(q, k, v, alpha, beta, None, cfg.chunk_size,
                                            initial_state=state, return_state=True)
    return _gated_out(p, cfg, o, z, x.dtype), state, conv_buf


def gdn_forward(p: dict, cfg: GatedDeltaNetConfig, x, segment_ids=None):
    """x: (B, L, H) -> (B, L, H) over packed rows (documents by
    `segment_ids`, 0 = padding)."""
    b, l, _ = x.shape
    q, k, v, z = torch.split(x @ p["in_proj_qkvz"]["w"],
                             [cfg.qk_dim, cfg.qk_dim, cfg.v_dim, cfg.v_dim], dim=-1)
    qkv = F.silu(_causal_depthwise_conv(torch.cat([q, k, v], dim=-1), p["conv_w"], segment_ids))
    q, k, v = _qkv(cfg, qkv, b, l)
    beta, alpha = _gates(p, cfg, x)
    o = gated_delta_rule_chunked(q, k, v, alpha, beta, segment_ids, cfg.chunk_size)
    return _gated_out(p, cfg, o, z, x.dtype)
