"""Qwen3-VL: a windowless ViT with deepstack features over an
interleaved-MRoPE text model (counterpart: `xtuner_tpu/model/qwen3_vl.py`).

The configs (`Qwen3VLVisionConfig`, `Qwen3VLProjectorConfig`,
`Qwen3VLConfig`) with JAX's fields and defaults, as dataclasses, and the
four presets. The parameter tree is JAX's: `vision` (patch_embed,
pos_embed, the stacked `blocks`), `projector` (`merger` and the stacked
`deepstack_mergers`) and `language` (the text model's own tree).

The training forward, as JAX's:
- `qwen3vl_vision_forward`: the patch rows times the patch embedding, the
  bilinear position embedding from the host's indices and weights (one
  `embedding_bag` with per-sample weights: the (P, 4, H) f32 gather never
  exists), the 2-D rotary table, then the blocks, each under
  `torch.utils.checkpoint` (JAX checkpoints every `block_fn`), with the
  hidden state kept after each block in `deepstack_visual_indexes`;
- `_vision_block`: LayerNorm, qkv, the f32 rotate-half rotary on q and k,
  bidirectional flash attention within each frame (`flash_attention(...,
  causal=False)` over `vision_segment_ids`: on the card #1-#4 at head dim
  64, the only pair whose kernels take `causal=False`), proj, LayerNorm,
  the MLP;
- `_merger_forward`: the spatial merge as a reshape (patches arrive in
  merge-block order), LayerNorm, fc1, exact gelu, fc2;
- `Qwen3VLModel._prepare_llm_inputs`: the k-th image-token position of
  the batch takes the k-th merged vision token, and the deepstack
  features are scattered the same way to (n_ds, B, L, H), which the text
  model adds after its first n_ds layers (`model/dense.py`,
  `model/moe.py`).

`param_labels` marks the `freeze_*` parts "freeze"; the engine gives those
leaves no gradient and no update (`engine/train_engine.py`).

The host helpers `smart_resize`, `preprocess_image` and `vision_geometry`
are numpy, as JAX's; the bilinear `_resize` is InternVL's
(`datasets/vlm.py`), as in JAX.

Not ported yet: the HF key map and `qwen3vl_config_from_hf`
([serve-rest]).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from ..datasets.vlm import _resize
from ..module.attention import MHAConfig
from ..module.params import ParamSpec, cast_tree, stack_specs, tree_map
from ..module.rope import RopeScalingConfig
from ..ops.act_fn import gelu_exact, get_act_fn
from ..ops.attention.flash import flash_attention
from ..ops.rotary import apply_rotary_emb
from .dense import DenseConfig, embed_tokens, layer_params, num_layers
from .vision import layer_norm


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@dataclass
class Qwen3VLVisionConfig:
    """JAX's Qwen3VLVisionConfig."""

    in_channels: int = 3
    depth: int = 27
    hidden_size: int = 1152
    num_attention_heads: int = 16
    intermediate_size: int = 4304
    hidden_act: str = "gelu_pytorch_tanh"
    patch_size: int = 16
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    num_position_embeddings: int = 2304
    deepstack_visual_indexes: list = field(default_factory=lambda: [8, 16, 24])
    layer_norm_eps: float = 1e-6
    initializer_range: float = 0.02
    attn_impl: Optional[str] = None

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_grid_per_side(self) -> int:
        return int(self.num_position_embeddings ** 0.5)


@dataclass
class Qwen3VLProjectorConfig:
    """JAX's Qwen3VLProjectorConfig."""

    vision_hidden_size: int = 1152
    text_hidden_size: int = 2048
    spatial_merge_size: int = 2
    deepstack_visual_indexes: list = field(default_factory=lambda: [8, 16, 24])

    @property
    def merged_size(self) -> int:
        return self.vision_hidden_size * self.spatial_merge_size ** 2


@dataclass
class Qwen3VLConfig:
    """JAX's Qwen3VLConfig: the vision tower, a text config (Dense, MoE
    or hybrid, with the qwen3_vl rope) and the vision token ids."""

    text_cfg: Any
    vision_cfg: Qwen3VLVisionConfig = field(default_factory=Qwen3VLVisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    freeze_vision: bool = False
    freeze_projector: bool = False
    freeze_language: bool = False

    @property
    def projector_cfg(self) -> Qwen3VLProjectorConfig:
        v = self.vision_cfg
        return Qwen3VLProjectorConfig(
            vision_hidden_size=v.hidden_size, text_hidden_size=self.text_cfg.hidden_size,
            spatial_merge_size=v.spatial_merge_size,
            deepstack_visual_indexes=list(v.deepstack_visual_indexes))

    # the engine's and trainer's view of a model config
    @property
    def lm_loss_cfg(self):
        return self.text_cfg.lm_loss_cfg

    @property
    def router(self):
        return getattr(self.text_cfg, "router", None)

    def build(self) -> "Qwen3VLModel":
        return Qwen3VLModel(self)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------
def qwen3vl_vision_param_specs(cfg: Qwen3VLVisionConfig) -> dict:
    h, f, s = cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range
    ones, zeros = (lambda n: ParamSpec((n,), init="ones")), (lambda n: ParamSpec((n,), "zeros"))
    block = {
        "norm1": {"w": ones(h), "b": zeros(h)},
        "attn": {"qkv": {"w": ParamSpec((h, 3 * h), scale=s), "b": zeros(3 * h)},
                 "proj": {"w": ParamSpec((h, h), scale=s), "b": zeros(h)}},
        "norm2": {"w": ones(h), "b": zeros(h)},
        "mlp": {"fc1": {"w": ParamSpec((h, f), scale=s), "b": zeros(f)},
                "fc2": {"w": ParamSpec((f, h), scale=s), "b": zeros(h)}},
    }
    return {
        "patch_embed": {"w": ParamSpec((cfg.patch_dim, h), scale=s), "b": zeros(h)},
        "pos_embed": ParamSpec((cfg.num_position_embeddings, h), scale=s),
        "blocks": stack_specs(block, cfg.depth),
    }


def _vision_block(lp, cfg: Qwen3VLVisionConfig, x, cos, sin, segment_ids):
    """One ViT block (JAX `_vision_block`), `lp` in the compute dtype:
    x (P, H) -> x (P, H)."""
    n, nh, d = x.shape[0], cfg.num_attention_heads, cfg.head_dim
    a = lp["attn"]
    hs = layer_norm(x, lp["norm1"]["w"], lp["norm1"]["b"], cfg.layer_norm_eps)
    qkv = (hs @ a["qkv"]["w"] + a["qkv"]["b"]).reshape(n, 3, nh, d)
    q, k = apply_rotary_emb(qkv[:, 0][None], qkv[:, 1][None], cos[None], sin[None])
    # the kernels read q, k and v by TMA: one contiguous copy of v (the
    # rotary already wrote q and k out)
    o, _ = flash_attention(q, k, qkv[:, 2][None].contiguous(), segment_ids[None],
                           causal=False)
    x = x + (o.reshape(n, nh * d) @ a["proj"]["w"] + a["proj"]["b"])
    hs = layer_norm(x, lp["norm2"]["w"], lp["norm2"]["b"], cfg.layer_norm_eps)
    hs = get_act_fn(cfg.hidden_act)(hs @ lp["mlp"]["fc1"]["w"] + lp["mlp"]["fc1"]["b"])
    return x + (hs @ lp["mlp"]["fc2"]["w"] + lp["mlp"]["fc2"]["b"])


def vision_rotary(rot_pos: torch.Tensor, head_dim: int):
    """The 2-D rotary table (JAX, from HF's rot_pos_emb): head_dim / 4
    frequencies per (row, col) axis; rot_pos (P, 2) int -> cos, sin (P,
    head_dim) f32."""
    d4 = head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (torch.arange(d4, dtype=torch.float32,
                                               device=rot_pos.device) / d4))
    rot = (rot_pos.float()[:, :, None] * inv_freq).reshape(-1, 2 * d4)
    emb = torch.cat([rot, rot], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def qwen3vl_vision_forward(params, cfg: Qwen3VLVisionConfig, seq_ctx,
                           compute_dtype=torch.bfloat16):
    """Patch rows (P, patch_dim) and the host's geometry -> (final (P, H),
    the deepstack features [(P, H)], taken after the blocks of
    `deepstack_visual_indexes`), in the compute dtype."""
    cd = compute_dtype
    x = seq_ctx.pixel_values.to(cd) @ params["patch_embed"]["w"].to(cd) \
        + params["patch_embed"]["b"].to(cd)
    # bilinear pos-embed: sum_k w_k pos_embed[idx_k] in f32
    pos = F.embedding_bag(seq_ctx.vision_pos_interp_idx.long(), params["pos_embed"].float(),
                          per_sample_weights=seq_ctx.vision_pos_interp_w.float(), mode="sum")
    x = x + pos.to(cd)
    cos, sin = vision_rotary(seq_ctx.vision_rot_pos, cfg.head_dim)
    seg = seq_ctx.vision_segment_ids.to(torch.int32).contiguous()

    def block_fn(x, lp):
        return _vision_block(cast_tree(lp, cd), cfg, x, cos, sin, seg)

    indexes = set(cfg.deepstack_visual_indexes)
    blocks = params["blocks"]
    deepstack = []
    for i in range(num_layers(blocks)):
        x = checkpoint(block_fn, x, layer_params(blocks, i), use_reentrant=False)
        if i in indexes:
            deepstack.append(x)
    return x, deepstack


# ---------------------------------------------------------------------------
# projector (patch merger + deepstack mergers)
# ---------------------------------------------------------------------------
def _merger_specs(cfg: Qwen3VLProjectorConfig, postshuffle: bool) -> dict:
    m, s = cfg.merged_size, 0.02
    norm_dim = m if postshuffle else cfg.vision_hidden_size
    return {
        "norm": {"w": ParamSpec((norm_dim,), init="ones"), "b": ParamSpec((norm_dim,), "zeros")},
        "fc1": {"w": ParamSpec((m, m), scale=s), "b": ParamSpec((m,), "zeros")},
        "fc2": {"w": ParamSpec((m, cfg.text_hidden_size), scale=s),
                "b": ParamSpec((cfg.text_hidden_size,), "zeros")},
    }


def qwen3vl_projector_param_specs(cfg: Qwen3VLProjectorConfig) -> dict:
    return {
        "merger": _merger_specs(cfg, postshuffle=False),
        "deepstack_mergers": stack_specs(_merger_specs(cfg, postshuffle=True),
                                         len(cfg.deepstack_visual_indexes)),
    }


def _merger_forward(p, cfg: Qwen3VLProjectorConfig, x, postshuffle: bool,
                    compute_dtype=torch.bfloat16):
    """(P, Hv) -> (P / merge^2, text hidden): LayerNorm before the spatial
    merge (the main merger) or after it (the deepstack mergers), then fc1,
    exact gelu, fc2."""
    p = cast_tree(p, compute_dtype)
    m = cfg.merged_size
    if postshuffle:
        x = layer_norm(x.reshape(-1, m), p["norm"]["w"], p["norm"]["b"])
    else:
        x = layer_norm(x, p["norm"]["w"], p["norm"]["b"]).reshape(-1, m)
    x = gelu_exact(x @ p["fc1"]["w"] + p["fc1"]["b"])
    return x @ p["fc2"]["w"] + p["fc2"]["b"]


# ---------------------------------------------------------------------------
# compose model
# ---------------------------------------------------------------------------
class Qwen3VLModel:
    def __init__(self, cfg: Qwen3VLConfig):
        if getattr(cfg.text_cfg, "lora_cfg", None) is not None:
            # JAX's Qwen3-VL reports no lora_cfg, freezes by part only and
            # merges nothing ([vlm])
            raise not_ported("LoRA on Qwen3-VL's text model", "lora")
        self.cfg = cfg
        self.language = cfg.text_cfg.build()

    def param_specs(self) -> dict:
        return {
            "vision": qwen3vl_vision_param_specs(self.cfg.vision_cfg),
            "projector": qwen3vl_projector_param_specs(self.cfg.projector_cfg),
            "language": self.language.param_specs(),
        }

    def check_trainable(self) -> None:
        """The text model's refusals, and a vision config the forward takes:
        a known activation, heads that split the width, deepstack indexes
        inside the tower."""
        v = self.cfg.vision_cfg
        get_act_fn(v.hidden_act)
        if v.head_dim * v.num_attention_heads != v.hidden_size:
            raise ValueError(f"vision hidden {v.hidden_size} is not {v.num_attention_heads} "
                             f"heads of {v.head_dim}")
        if any(not 0 <= i < v.depth for i in v.deepstack_visual_indexes):
            raise ValueError(f"deepstack_visual_indexes {v.deepstack_visual_indexes} outside "
                             f"the tower's {v.depth} blocks")
        if hasattr(self.language, "check_trainable"):
            self.language.check_trainable()

    def _prepare_llm_inputs(self, params, seq_ctx, compute_dtype):
        """The text embeddings with the merged vision tokens at the image
        positions, and the deepstack features scattered to (n_ds, B, L, H)
        (None without images or without deepstack layers)."""
        embeds = embed_tokens(params["language"], seq_ctx.input_ids, compute_dtype)
        if seq_ctx.pixel_values is None:
            return embeds, None
        pcfg = self.cfg.projector_cfg
        vis, ds_feats = qwen3vl_vision_forward(params["vision"], self.cfg.vision_cfg, seq_ctx,
                                               compute_dtype)
        main = _merger_forward(params["projector"]["merger"], pcfg, vis, False, compute_dtype)
        mergers = params["projector"]["deepstack_mergers"]
        ds = [_merger_forward(layer_params(mergers, i), pcfg, f, True, compute_dtype)
              for i, f in enumerate(ds_feats)]
        b, l = seq_ctx.input_ids.shape
        if seq_ctx.image_token_mask is not None:
            mask = seq_ctx.image_token_mask.reshape(-1).bool()
        else:
            ids = seq_ctx.input_ids.reshape(-1)
            mask = (ids == self.cfg.image_token_id) | (ids == self.cfg.video_token_id)
        # the k-th visual position takes the k-th merged vision token (the
        # collator lays the patches out in this order, row-major over the batch)
        dest = (torch.cumsum(mask.long(), 0) - 1).clamp(0, main.shape[0] - 1)
        embeds = torch.where(mask[:, None], main[dest], embeds.reshape(b * l, -1))
        embeds = embeds.reshape(b, l, -1)
        if not ds:
            return embeds, None
        zero = torch.zeros((), dtype=main.dtype, device=main.device)
        return embeds, torch.stack([torch.where(mask[:, None], d[dest], zero).reshape(b, l, -1)
                                    for d in ds])

    def _language_ctx(self, params, seq_ctx, compute_dtype):
        self.check_trainable()
        embeds, ds = self._prepare_llm_inputs(params, seq_ctx, compute_dtype)
        return seq_ctx.replace(inputs_embeds=embeds, deepstack_embeds=ds, pixel_values=None)

    def forward(self, params, seq_ctx, compute_dtype=torch.bfloat16, remat: str = "full"):
        lang_ctx = self._language_ctx(params, seq_ctx, compute_dtype)
        return self.language.forward(params["language"], lang_ctx, compute_dtype, remat)

    def lm_head_weight(self, params):
        return self.language.lm_head_weight(params["language"])

    def loss(self, params, seq_ctx, shifted_labels, loss_weights, global_denom,
             compute_dtype=torch.bfloat16, remat: str = "full"):
        lang_ctx = self._language_ctx(params, seq_ctx, compute_dtype)
        return self.language.loss(params["language"], lang_ctx, shifted_labels, loss_weights,
                                  global_denom, compute_dtype, remat)

    def param_labels(self, params_or_specs) -> dict:
        """"freeze" or "train" for every leaf, by part (JAX's labels)."""
        cfg = self.cfg
        frozen = {"vision": cfg.freeze_vision, "projector": cfg.freeze_projector,
                  "language": cfg.freeze_language}
        return {part: tree_map(lambda _, f=f: "freeze" if f else "train",
                               params_or_specs[part]) for part, f in frozen.items()}

    def hf_key_map(self) -> dict:
        raise not_ported("the Qwen3-VL HF key map", "serve-rest")


def qwen3vl_config_from_hf(hf_cfg) -> Qwen3VLConfig:
    raise not_ported("qwen3vl_config_from_hf", "serve-rest")


# ---------------------------------------------------------------------------
# host-side preprocessing (collator / tokenize-fn helpers; numpy only)
# ---------------------------------------------------------------------------
def smart_resize(height: int, width: int, factor: int = 32,
                 min_pixels: int = 65536, max_pixels: int = 16777216):
    """HF qwen-vl smart_resize: round to multiples of `factor` with the
    pixel count kept within [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image: np.ndarray, patch_size: int = 16, merge_size: int = 2,
                     temporal_patch_size: int = 2, min_pixels: int = 65536,
                     max_pixels: int = 16777216):
    """(H, W, 3) uint8 -> (patches (P, C tps ps ps) f32, grid_thw (3,)), in
    the HF Qwen2VL processor's layout: tokens in (t, h block, w block, h
    intra, w intra) order, features (channel, temporal, ph, pw); the resize
    is bilinear."""
    h, w = image.shape[:2]
    h_bar, w_bar = smart_resize(h, w, patch_size * merge_size, min_pixels, max_pixels)
    img = _resize(image, w_bar, h_bar)
    img = (img / 255.0 - CLIP_MEAN) / CLIP_STD
    img = img.transpose(2, 0, 1)  # (C, H, W)
    img = np.tile(img[None], (temporal_patch_size, 1, 1, 1))  # one image: tps frames
    grid_t, grid_h, grid_w = 1, h_bar // patch_size, w_bar // patch_size
    c = img.shape[1]
    patches = img.reshape(grid_t, temporal_patch_size, c, grid_h // merge_size, merge_size,
                          patch_size, grid_w // merge_size, merge_size, patch_size)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8).reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size * patch_size)
    return patches.astype(np.float32), np.asarray([grid_t, grid_h, grid_w], np.int64)


def vision_geometry(grid_thw_list, num_grid_per_side: int, merge_size: int = 2,
                    total_patches: Optional[int] = None) -> dict:
    """The per-patch geometry of the vision forward, on the host: the
    bilinear pos-embed indices and weights, the 2-D rotary (row, col) and
    one segment id per frame, in merge-block order (HF
    fast_pos_embed_interpolate and rot_pos_emb); padded with segment 0 to
    `total_patches` when given."""
    idx_list, w_list, rot_list, seg_list = [], [], [], []
    seg = 1
    side = num_grid_per_side
    for (t, gh, gw) in [tuple(int(v) for v in g) for g in grid_thw_list]:
        m = merge_size
        h_idxs = np.linspace(0, side - 1, gh, dtype=np.float32)
        w_idxs = np.linspace(0, side - 1, gw, dtype=np.float32)
        h_floor, w_floor = h_idxs.astype(np.int64), w_idxs.astype(np.int64)
        h_ceil, w_ceil = np.minimum(h_floor + 1, side - 1), np.minimum(w_floor + 1, side - 1)
        dh_g, dw_g = np.meshgrid(h_idxs - h_floor, w_idxs - w_floor, indexing="ij")
        hf_g, wf_g = np.meshgrid(h_floor, w_floor, indexing="ij")
        hc_g, wc_g = np.meshgrid(h_ceil, w_ceil, indexing="ij")
        w11 = dh_g * dw_g
        w10 = dh_g - w11
        w01 = dw_g - w11
        w00 = 1 - dh_g - w01
        idx4 = np.stack([hf_g * side + wf_g, hf_g * side + wc_g, hc_g * side + wf_g,
                         hc_g * side + wc_g]).reshape(4, -1)
        wt4 = np.stack([w00, w01, w10, w11]).reshape(4, -1)
        perm = (np.arange(gh * gw).reshape(gh // m, m, gw // m, m)
                .transpose(0, 2, 1, 3).reshape(-1))  # row-major -> merge-block order
        idx_list.append(np.tile(idx4[:, perm].T, (t, 1)))
        w_list.append(np.tile(wt4[:, perm].T, (t, 1)))
        br = np.arange(gh // m)[:, None, None, None]
        bc = np.arange(gw // m)[None, :, None, None]
        ir = np.arange(m)[None, None, :, None]
        ic = np.arange(m)[None, None, None, :]
        rows = np.broadcast_to(br * m + ir, (gh // m, gw // m, m, m)).reshape(-1)
        cols = np.broadcast_to(bc * m + ic, (gh // m, gw // m, m, m)).reshape(-1)
        rot_list.append(np.tile(np.stack([rows, cols], axis=-1), (t, 1)))
        seg_list.append(np.repeat(np.arange(seg, seg + t), gh * gw))
        seg += t

    idx = np.concatenate(idx_list).astype(np.int32) if idx_list else np.zeros((0, 4), np.int32)
    wts = np.concatenate(w_list).astype(np.float32) if w_list else np.zeros((0, 4), np.float32)
    rot = np.concatenate(rot_list).astype(np.int32) if rot_list else np.zeros((0, 2), np.int32)
    segs = np.concatenate(seg_list).astype(np.int32) if seg_list else np.zeros((0,), np.int32)
    if total_patches is not None:
        p = idx.shape[0]
        if p > total_patches:
            raise ValueError(f"batch has {p} vision patches > max_patches={total_patches}")
        pad = total_patches - p
        idx = np.pad(idx, ((0, pad), (0, 0)))
        wts = np.pad(wts, ((0, pad), (0, 0)))
        rot = np.pad(rot, ((0, pad), (0, 0)))
        segs = np.pad(segs, (0, pad))  # pad patches: segment 0, masked out
    return {"vision_pos_interp_idx": idx, "vision_pos_interp_w": wts,
            "vision_rot_pos": rot, "vision_segment_ids": segs}


# ---------------------------------------------------------------------------
# presets (JAX's, from the reference qwen3_vl_config.py)
# ---------------------------------------------------------------------------
def _qwen3vl_rope() -> RopeScalingConfig:
    return RopeScalingConfig(rope_type="qwen3_vl", mrope_section=[24, 20, 20])


def _qwen3vl_text_dense(hidden: int, inter: int, layers: int, heads: int, kv_heads: int,
                        tie: bool) -> DenseConfig:
    return DenseConfig(
        vocab_size=151936, hidden_size=hidden, intermediate_size=inter,
        num_hidden_layers=layers, max_position_embeddings=262144, rope_theta=5000000.0,
        rope_scaling_cfg=_qwen3vl_rope(),
        attention=MHAConfig(num_attention_heads=heads, num_key_value_heads=kv_heads,
                            head_dim=128, qk_norm=True),
        tie_word_embeddings=tie, eos_token_id=151645)


def qwen3_vl_4b() -> Qwen3VLConfig:
    """Qwen3-VL-4B: a 24-block tower of 16 heads of 64 over Qwen3-4B's text
    model with interleaved MRoPE."""
    return Qwen3VLConfig(
        vision_cfg=Qwen3VLVisionConfig(depth=24, hidden_size=1024, intermediate_size=4096,
                                       deepstack_visual_indexes=[5, 11, 17]),
        text_cfg=_qwen3vl_text_dense(2560, 9728, 36, 32, 8, tie=True))


def qwen3_vl_8b() -> Qwen3VLConfig:
    return Qwen3VLConfig(text_cfg=_qwen3vl_text_dense(4096, 12288, 36, 32, 8, tie=False))


def qwen3_vl_moe_30b_a3() -> Qwen3VLConfig:
    from .moe import qwen3_moe_30b_a3

    text = dataclasses.replace(qwen3_moe_30b_a3(), max_position_embeddings=262144,
                               rope_theta=5000000.0, rope_scaling_cfg=_qwen3vl_rope())
    return Qwen3VLConfig(text_cfg=text)


def qwen3_5_vl_35b_a3b() -> Qwen3VLConfig:
    """Qwen3.5-VL-35B-A3B: the tower without deepstack layers over the
    hybrid Gated DeltaNet / gated attention MoE text model; its own vision
    token ids."""
    from .hybrid import qwen3_5_moe_35b_a3b

    return Qwen3VLConfig(
        vision_cfg=Qwen3VLVisionConfig(deepstack_visual_indexes=[]),
        text_cfg=qwen3_5_moe_35b_a3b(), image_token_id=248056, video_token_id=248057,
        vision_start_token_id=248053, vision_end_token_id=248054)
