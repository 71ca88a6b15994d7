"""InternVL's vision tower and projector (counterpart:
`xtuner_tpu/model/vision.py`), and the LayerNorm Qwen3-VL's tower shares.

- `ViTConfig`, `ProjectorConfig`: JAX's fields and defaults, as
  dataclasses; `vit_param_specs` / `projector_param_specs` JAX's tree
  (`patch_embed`, `pos_embed`, the stacked `blocks` with `ls1` / `ls2`,
  `cls_token` when `use_cls_token`; the projector's `norm`, `fc1`, `fc2`).
- `vit_forward`: (T, 3, S, S) tiles -> (T, tokens_per_tile, hidden / r^2):
  patchify as a reshape and a matmul (a stride-P convolution), the cls
  token and the position table, the blocks (LayerNorm, qkv, attention,
  proj times ls1; LayerNorm, fc1, the activation, fc2 times ls2), each
  under `torch.utils.checkpoint` (JAX checkpoints every block), then the
  cls token dropped and the pixel shuffle in JAX's exact reshape /
  transpose order.
- The attention is JAX's `_vit_attention`, softmax attention inside each
  tile in f32, computed as one row of T x (1 + patches) tokens with one
  segment id per tile through `flash_attention(causal=False)`: the plain
  f32 version on a CPU tensor, on the card #1-#4 non-causal at the head
  dim (64 for InternViT-300M's 16 heads of 64; JAX computes it in plain
  jnp, `vision.py:91-101`, so no TPU kernel is replaced). At 48 tiles the
  plain version's f32 logits would be 3.2 GB a layer.
- A tower none of whose inputs needs a gradient (a frozen tower on
  pixels) records no autograd graph, so it has no backward and its
  checkpoints keep nothing.
- `projector_forward`: LayerNorm (eps 1e-6), fc1, the activation, fc2.

JAX's "gelu" is the tanh form (`ops/act_fn.py`), so InternViT's MLP and
the projector take that form here too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..module.params import ParamSpec, cast_tree, stack_specs
from ..ops.act_fn import get_act_fn
from ..ops.attention.flash import flash_attention
from .dense import layer_params, num_layers


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim as JAX's: f32 mean and population
    variance, times rsqrt(var + eps), then the affine in f32, cast back to
    x's dtype (`F.layer_norm` on f32: the same function in one pass)."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps).to(x.dtype)


@dataclass
class ViTConfig:
    """JAX's ViTConfig (InternViT-300M's defaults)."""

    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    use_cls_token: bool = True
    downsample_ratio: float = 0.5  # pixel shuffle factor

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def tokens_per_tile(self) -> int:
        g = int(self.grid * self.downsample_ratio)
        return g * g

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _affine(n: int) -> dict:
    return {"w": ParamSpec((n,), init="ones"), "b": ParamSpec((n,), init="zeros")}


def _linear(n_in: int, n_out: int, scale: float) -> dict:
    return {"w": ParamSpec((n_in, n_out), scale=scale), "b": ParamSpec((n_out,), init="zeros")}


def vit_param_specs(cfg: ViTConfig, init_scale: float = 0.02) -> dict:
    h, f = cfg.hidden_size, cfg.intermediate_size
    layer = {
        "norm1": _affine(h),
        "attn": {"qkv": _linear(h, 3 * h, init_scale), "proj": _linear(h, h, init_scale)},
        "norm2": _affine(h),
        "mlp": {"fc1": _linear(h, f, init_scale), "fc2": _linear(f, h, init_scale)},
        "ls1": ParamSpec((h,), init="ones"),
        "ls2": ParamSpec((h,), init="ones"),
    }
    specs: dict = {
        "patch_embed": _linear(3 * cfg.patch_size ** 2, h, init_scale),
        "pos_embed": ParamSpec((cfg.num_patches + int(cfg.use_cls_token), h), scale=init_scale),
        "blocks": stack_specs(layer, cfg.num_hidden_layers),
    }
    if cfg.use_cls_token:
        specs["cls_token"] = ParamSpec((1, h), scale=init_scale)
    return specs


def tile_segments(t: int, n: int, device) -> torch.Tensor:
    """(1, t n) int32: tile i's n tokens in segment i + 1."""
    return torch.arange(1, t + 1, dtype=torch.int32, device=device).repeat_interleave(n)[None]


def _vit_attention(p, cfg: ViTConfig, x: torch.Tensor, segment_ids: torch.Tensor):
    """Attention inside each tile (JAX `_vit_attention`): x (T, n, H), `p`
    in the compute dtype; the tiles as segments of one row."""
    t, n, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    qkv = (x @ p["qkv"]["w"] + p["qkv"]["b"]).reshape(1, t * n, 3, nh, d)
    # the kernels read q, k and v by TMA: one contiguous copy each
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    o, _ = flash_attention(q, k, v, segment_ids, causal=False)
    return o.reshape(t, n, h) @ p["proj"]["w"] + p["proj"]["b"]


def _vit_block(lp, cfg: ViTConfig, x, segment_ids, compute_dtype):
    lp = cast_tree(lp, compute_dtype)
    h1 = layer_norm(x, lp["norm1"]["w"], lp["norm1"]["b"], cfg.layer_norm_eps)
    x = x + _vit_attention(lp["attn"], cfg, h1, segment_ids) * lp["ls1"]
    h2 = layer_norm(x, lp["norm2"]["w"], lp["norm2"]["b"], cfg.layer_norm_eps)
    h2 = get_act_fn(cfg.hidden_act)(h2 @ lp["mlp"]["fc1"]["w"] + lp["mlp"]["fc1"]["b"])
    h2 = h2 @ lp["mlp"]["fc2"]["w"] + lp["mlp"]["fc2"]["b"]
    return x + h2 * lp["ls2"]


def pixel_shuffle(x: torch.Tensor, grid: int, ratio: float) -> torch.Tensor:
    """(T, g g, H) -> (T, (g / s)^2, H s^2), s = 1 / ratio, in JAX's
    reshape and transpose order (InternVL's pixel shuffle)."""
    if ratio == 1.0:
        return x
    t, _, h = x.shape
    s, g = int(1 / ratio), grid
    x = x.reshape(t, g, g // s, h * s).transpose(1, 2)
    x = x.reshape(t, g // s, g // s, h * s * s).transpose(1, 2)
    return x.reshape(t, (g // s) * (g // s), h * s * s)


def vit_forward(params, cfg: ViTConfig, pixel_values: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """pixel_values (T, 3, S, S) tiles -> (T, tokens_per_tile, H / r^2)
    in the compute dtype."""
    cd = compute_dtype
    t = pixel_values.shape[0]
    g, ps = cfg.grid, cfg.patch_size
    x = pixel_values.to(cd).reshape(t, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(t, g * g, 3 * ps * ps)
    x = x @ params["patch_embed"]["w"].to(cd) + params["patch_embed"]["b"].to(cd)
    if cfg.use_cls_token:
        x = torch.cat([params["cls_token"].to(cd).expand(t, 1, cfg.hidden_size), x], dim=1)
    x = x + params["pos_embed"].to(cd)[None]
    seg = tile_segments(t, x.shape[1], x.device)
    blocks = params["blocks"]
    for i in range(num_layers(blocks)):
        x = checkpoint(_vit_block, layer_params(blocks, i), cfg, x, seg, cd,
                       use_reentrant=False)
    if cfg.use_cls_token:
        x = x[:, 1:]
    return pixel_shuffle(x, g, cfg.downsample_ratio)


@dataclass
class ProjectorConfig:
    """JAX's ProjectorConfig: the pixel-shuffled ViT width to the LLM's."""

    in_dim: int
    out_dim: int
    hidden_act: str = "gelu"


def projector_param_specs(cfg: ProjectorConfig, init_scale: float = 0.02) -> dict:
    return {"norm": _affine(cfg.in_dim), "fc1": _linear(cfg.in_dim, cfg.out_dim, init_scale),
            "fc2": _linear(cfg.out_dim, cfg.out_dim, init_scale)}


def projector_forward(p, cfg: ProjectorConfig, x: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    p = cast_tree(p, compute_dtype)
    x = layer_norm(x, p["norm"]["w"], p["norm"]["b"])
    x = get_act_fn(cfg.hidden_act)(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["fc2"]["w"] + p["fc2"]["b"]
