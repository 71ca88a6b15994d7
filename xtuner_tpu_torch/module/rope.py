"""Rotary embedding frequencies (counterpart: `xtuner_tpu/module/rope.py`).

`RopeScalingConfig` with the JAX fields and defaults, and
`compute_inv_freq_and_scale` for the rope types default, linear, dynamic,
llama3, yarn (DeepSeek-V3's) and longrope; `rope_cos_sin` multiplies cos
and sin by the type's attention scaling, as JAX does. Like JAX's, it
gives the qwen3_vl type the default frequencies.

Qwen3-VL's interleaved MRoPE (`mrope_cos_sin_interleaved`) is what the
training forward of a qwen3_vl config runs, through `model_rope_cos_sin`,
JAX's model-facing dispatch: the (B, 3, L) `mrope_positions` of the
batch, or its text positions on all three axes, which gives the plain
rope. The serving engines read a qwen3_vl config as plain rope over text
positions, as JAX's do (`text_rope_scaling`). `build_mrope_positions`
makes a sample's (3, L) positions on the host, as the Qwen3-VL tokenize
function asks it to.

Not ported yet: FoPE's learned Fourier mixing (`use_fope`) raises ([vlm]).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import not_ported

ROPE_TYPES = ("default", "linear", "dynamic", "yarn", "longrope", "llama3", "qwen3_vl")


@dataclass
class RopeScalingConfig:
    """Same fields and defaults as the JAX RopeScalingConfig."""

    rope_type: str = "default"
    factor: float = 1.0
    # longrope: per-frequency rescale lists and an optional attention factor
    short_factor: Optional[list] = None
    long_factor: Optional[list] = None
    attention_factor: Optional[float] = None
    # qwen3_vl interleaved MRoPE
    mrope_section: Optional[list] = None
    # FoPE
    use_fope: bool = False
    num_inv_freq: Optional[int] = None
    fope_init_factor: float = 1.0
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    original_max_position_embeddings: Optional[int] = None
    # llama3
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0

    def __post_init__(self):
        if self.rope_type not in ROPE_TYPES:
            raise ValueError(f"rope_type {self.rope_type!r} not in {ROPE_TYPES}")


def text_rope_scaling(scaling: Optional[RopeScalingConfig]) -> Optional[RopeScalingConfig]:
    """The scaling the serving engines' rope takes: JAX's `rope_cos_sin`
    gives the qwen3_vl type the default frequencies (its interleaved MRoPE
    lives only in the training forward's `model_rope_cos_sin`, and with
    text positions on all three axes it is the plain rope), so it maps to
    None; every other scaling is kept."""
    if scaling is not None and scaling.rope_type == "qwen3_vl" and not scaling.use_fope:
        return None
    return scaling


def _rope_dim(attn_cfg) -> int:
    """Rotary dim of an attention config: MHA partial_rotary_factor aware;
    MLA's `head_dim` property already IS the rope dim."""
    return getattr(attn_cfg, "rope_dim", attn_cfg.head_dim)


def _base_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def _yarn_mscale(scale: float, m: float) -> float:
    if scale <= 1 or m == 0:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def compute_inv_freq_and_scale(head_dim: int, theta: float,
                               scaling: Optional[RopeScalingConfig] = None,
                               max_position_embeddings: int = 4096, device=None):
    """Returns (inv_freq (head_dim // 2,) f32, attention scaling: a float)."""
    inv_freq = _base_inv_freq(head_dim, theta, device)
    kind = "default" if scaling is None else scaling.rope_type
    if scaling is not None and scaling.use_fope:
        raise not_ported("FoPE (learned Fourier rope)", "vlm")
    if kind in ("default", "qwen3_vl"):
        return inv_freq, 1.0
    if kind == "linear":
        return inv_freq / scaling.factor, 1.0
    if kind == "dynamic":  # NTK-aware: theta rescaled for the training max length
        base = theta * (scaling.factor ** (head_dim / (head_dim - 2)))
        return _base_inv_freq(head_dim, base, device), 1.0
    orig = scaling.original_max_position_embeddings or max_position_embeddings
    if kind == "llama3":
        low_wl = orig / scaling.low_freq_factor
        high_wl = orig / scaling.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = ((orig / wavelen - scaling.low_freq_factor)
                  / (scaling.high_freq_factor - scaling.low_freq_factor)).clamp(0.0, 1.0)
        scaled = inv_freq / scaling.factor
        blended = (1 - smooth) * scaled + smooth * inv_freq
        out = torch.where(wavelen > low_wl, scaled,
                          torch.where(wavelen < high_wl, inv_freq, blended))
        return out, 1.0
    if kind == "yarn":
        def find_dim(num_rot):
            return (head_dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

        low = max(math.floor(find_dim(scaling.beta_fast)), 0)
        high = min(math.ceil(find_dim(scaling.beta_slow)), head_dim // 2 - 1)
        ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
                / max(high - low, 1e-3)).clamp(0, 1)
        out = inv_freq / scaling.factor * ramp + inv_freq * (1 - ramp)
        att = _yarn_mscale(scaling.factor, scaling.mscale)
        if scaling.mscale_all_dim:
            att = att / _yarn_mscale(scaling.factor, scaling.mscale_all_dim)
        return out, float(att)
    # longrope (Phi-3): the deployed max length stands in for the runtime
    # length; long_factor past the pretrained window, short_factor inside it
    factor = (max_position_embeddings / orig if scaling.original_max_position_embeddings
              else scaling.factor)
    att = scaling.attention_factor
    if att is None:
        att = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(orig))
    ext = (scaling.long_factor if max_position_embeddings > orig
           else scaling.short_factor) or [1.0]
    return inv_freq / torch.tensor(ext, dtype=torch.float32, device=device), float(att)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[RopeScalingConfig] = None,
                 max_position_embeddings: int = 4096):
    """position_ids (B, L) int -> cos, sin (B, L, head_dim) fp32, each times
    the rope type's attention scaling."""
    inv_freq, att = compute_inv_freq_and_scale(head_dim, theta, scaling,
                                               max_position_embeddings, position_ids.device)
    freqs = position_ids.float()[:, :, None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * att, torch.sin(emb) * att


def mrope_cos_sin_interleaved(position_ids_3d: torch.Tensor, head_dim: int, theta: float,
                              mrope_section=(24, 20, 20)):
    """Qwen3-VL's interleaved MRoPE (JAX `mrope_cos_sin_interleaved`):
    position_ids_3d (3, B, L) int, the (temporal, height, width) position
    of each token -> cos, sin (B, L, head_dim) f32. Frequency i takes its
    position from axis 0, except H owns i = 1, 4, 7, ... < 3 sec_h and W
    owns i = 2, 5, 8, ... < 3 sec_w."""
    inv_freq = _base_inv_freq(head_dim, theta, position_ids_3d.device)
    sel = torch.zeros(head_dim // 2, dtype=torch.long, device=position_ids_3d.device)
    sel[1:mrope_section[1] * 3:3] = 1
    sel[2:mrope_section[2] * 3:3] = 2
    freqs = position_ids_3d.float()[..., None] * inv_freq  # (3, B, L, hd / 2)
    picked = torch.gather(freqs, 0, sel.expand(1, *freqs.shape[1:]))[0]
    emb = torch.cat([picked, picked], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def model_rope_cos_sin(seq_ctx, head_dim: int, theta: float,
                       scaling: Optional[RopeScalingConfig], max_position_embeddings: int):
    """The training forward's rope (JAX `model_rope_cos_sin`): interleaved
    MRoPE for a qwen3_vl config, over `seq_ctx.mrope_positions` (B, 3, L)
    when the batch has them and over `position_ids` on all three axes
    otherwise; `rope_cos_sin` of `position_ids` for every other type."""
    if scaling is not None and scaling.use_fope:
        raise not_ported("FoPE (learned Fourier rope)", "vlm")
    if scaling is not None and scaling.rope_type == "qwen3_vl":
        sec = tuple(scaling.mrope_section or (24, 20, 20))
        if sum(sec) != head_dim // 2:
            raise ValueError(f"mrope_section {sec} must sum to head_dim // 2 = {head_dim // 2}")
        pos3 = seq_ctx.mrope_positions
        if pos3 is None:
            pos = seq_ctx.position_ids
            pos3 = pos[None].expand(3, *pos.shape)
        else:
            pos3 = pos3.transpose(0, 1)  # (B, 3, L) -> (3, B, L)
        return mrope_cos_sin_interleaved(pos3, head_dim, theta, sec)
    return rope_cos_sin(seq_ctx.position_ids, head_dim, theta, scaling,
                        max_position_embeddings)


def build_mrope_positions(input_ids, image_token_mask, image_grid_thw,
                          spatial_merge: int = 2) -> np.ndarray:
    """A packed sample's 3-D positions on the host (JAX
    `build_mrope_positions`): text tokens advance t, h and w together;
    each image's merged tokens take (cursor + t, cursor + row, cursor +
    col) over its (t, h / merge, w / merge) grid, and the cursor then
    moves by the grid's largest side. input_ids (L,); image_token_mask
    (L,) bool; image_grid_thw (n_images, 3). Returns (3, L) int32."""
    n = len(input_ids)
    pos = np.zeros((3, n), np.int64)
    cursor = img = i = 0
    while i < n:
        if image_token_mask[i]:
            gt, gh, gw = (int(g) for g in image_grid_thw[img])
            gh, gw = gh // spatial_merge, gw // spatial_merge
            m = gt * gh * gw
            pos[0, i:i + m] = cursor + np.repeat(np.arange(gt), gh * gw)
            pos[1, i:i + m] = cursor + np.tile(np.repeat(np.arange(gh), gw), gt)
            pos[2, i:i + m] = cursor + np.tile(np.arange(gw), gt * gh)
            cursor += max(gt, gh, gw)
            img += 1
            i += m
        else:
            pos[:, i] = cursor
            cursor += 1
            i += 1
    return pos.astype(np.int32)
