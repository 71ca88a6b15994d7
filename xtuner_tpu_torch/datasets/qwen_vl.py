"""The Qwen3-VL data plane: tokenize function and collator (counterpart:
`xtuner_tpu/datasets/qwen_vl.py`; numpy only).

`Qwen3VLTokenizeFn` expands each image of an OpenAI-format chat into
VISION_START + IMAGE_PAD x (t h w / merge^2) + VISION_END, with the image
preprocessed into patch rows in merge-block order
(`model/qwen3_vl.py::preprocess_image`), and builds the sample's (3, L)
MRoPE positions on the host (`module/rope.py::build_mrope_positions`).
Images are numpy arrays in the item or paths; a `.npy` path is read with
numpy, anything else with PIL. `qwen3vl_collator` collates packs as
`sft_llm_collator` does and adds the patch rows padded to `max_patches`,
the (B, L) image-token mask, the (B, 3, L) MRoPE positions and the ViT
geometry of `vision_geometry`.

The image-pad id is the first id the tokenizer gives IMAGE_PAD, so the
tokenizer must know the three vision specials as single tokens: a
tokenizer that splits IMAGE_PAD makes the placeholder count differ from
the vision tokens and the sample raises. The port's `Trainer` builds its
toy tokenizer with them for a qwen3_vl dataset (`train/trainer.py`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..data_proto.templates import ChatMessages, get_chat_template
from ..model.qwen3_vl import preprocess_image, vision_geometry
from ..module.rope import build_mrope_positions
from .collator import sft_llm_collator
from .tokenize_fns import _tokenizer_fingerprint

VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"
IMG_TOKEN = "<image>"
VL_SPECIALS = [VISION_START, IMAGE_PAD, VISION_END]  # the toy tokenizer's vision specials


class Qwen3VLTokenizeFn:
    """OpenAI-format chat -> supervised sample with patch rows: user
    content items of type image / image_url become the placeholder above,
    and so does an `<image>` in a string content when the item has
    "image"."""

    def __init__(self, tokenizer, chat_template: str = "qwen",
                 patch_size: int = 16, merge_size: int = 2, temporal_patch_size: int = 2,
                 min_pixels: int = 65536, max_pixels: int = 16777216,
                 max_length: Optional[int] = None):
        self.tokenizer = tokenizer
        self.chat_template = get_chat_template(chat_template)
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.temporal_patch_size = temporal_patch_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.max_length = max_length
        self.image_pad_id = tokenizer.encode(IMAGE_PAD, add_special_tokens=False)[0]

    def _load_image(self, ref) -> np.ndarray:
        if isinstance(ref, np.ndarray):
            return ref
        path = Path(ref)
        if path.suffix == ".npy":
            return np.load(path)
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))

    def _process(self, img: np.ndarray):
        return preprocess_image(img, patch_size=self.patch_size, merge_size=self.merge_size,
                                temporal_patch_size=self.temporal_patch_size,
                                min_pixels=self.min_pixels, max_pixels=self.max_pixels)

    def _placeholder(self, grid) -> str:
        return VISION_START + IMAGE_PAD * (int(np.prod(grid)) // self.merge_size ** 2) \
            + VISION_END

    def __call__(self, item: dict[str, Any]) -> dict:
        patch_list, grid_list, messages = [], [], []
        for msg in item["messages"]:
            content = msg.get("content", "")
            if isinstance(content, list):
                parts = []
                for part in content:
                    if part.get("type") in ("image_url", "image"):
                        patches, grid = self._process(
                            self._load_image(part.get("image_url", part.get("image"))))
                        patch_list.append(patches)
                        grid_list.append(grid)
                        parts.append(self._placeholder(grid))
                    else:
                        parts.append(part.get("text", ""))
                content = "".join(parts)
            elif IMG_TOKEN in content and "image" in item:
                patches, grid = self._process(self._load_image(item["image"]))
                patch_list.append(patches)
                grid_list.append(grid)
                content = content.replace(IMG_TOKEN, self._placeholder(grid), 1)
            messages.append({**msg, "content": content})

        out = ChatMessages(messages=messages).tokenize(self.tokenizer, self.chat_template)
        ids = np.asarray(out["input_ids"], np.int64)
        mask = ids == self.image_pad_id
        n_img_tokens = sum(int(np.prod(g)) // self.merge_size ** 2 for g in grid_list)
        if int(mask.sum()) != n_img_tokens:
            raise ValueError(
                f"image token count mismatch: {int(mask.sum())} placeholders vs "
                f"{n_img_tokens} vision tokens (template swallowed a special token?)")
        if self.max_length is not None and out["num_tokens"] > self.max_length:
            if mask[self.max_length:].any():
                # a cut through the image tokens would desync them from the patches
                raise ValueError("truncation would cut image tokens; discard sample")
            ids, mask = ids[:self.max_length], mask[:self.max_length]
            out["input_ids"] = out["input_ids"][:self.max_length]
            out["labels"] = out["labels"][:self.max_length]
            out["num_tokens"] = self.max_length
        if grid_list:
            grids = np.stack(grid_list)
            out["pixel_values"] = np.concatenate(patch_list)
            out["image_grid_thw"] = grids
            out["mrope_positions"] = build_mrope_positions(ids, mask, grids,
                                                           spatial_merge=self.merge_size)
            out["image_token_mask"] = mask
        return out

    def hash(self) -> str:
        key = json.dumps(["qwen3vl", _tokenizer_fingerprint(self.tokenizer), self.patch_size,
                          self.merge_size, self.temporal_patch_size, self.min_pixels,
                          self.max_pixels, dataclasses.asdict(self.chat_template),
                          self.max_length], sort_keys=True, default=str)
        return hashlib.sha256(key.encode()).hexdigest()[:16]


def qwen3vl_collator(packs: list[list[dict]], pack_max_length: int,
                     loss_reduction: str = "token", max_patches: int = 0,
                     num_grid_per_side: int = 48, merge_size: int = 2,
                     pad_token_id: int = 0) -> dict:
    """`sft_llm_collator`'s (B, L) arrays plus the patch rows padded to
    `max_patches` (P, patch_dim), the image-token mask (B, L), the MRoPE
    positions (B, 3, L) (text-only samples count t = h = w from 0) and the
    ViT geometry. Raises when the patches exceed `max_patches` or the
    image tokens do not match the merged vision tokens."""
    batch = sft_llm_collator(packs, pack_max_length, loss_reduction, pad_token_id=pad_token_id)
    b, l = batch["input_ids"].shape
    mrope = np.zeros((b, 3, l), np.int32)
    img_mask = np.zeros((b, l), bool)
    patch_arrs, grids = [], []
    for bi, pack in enumerate(packs):
        offset = 0
        for sample in pack:
            n = min(int(sample["num_tokens"]), l - offset)
            if n <= 0:
                break
            if "mrope_positions" in sample:
                mrope[bi, :, offset:offset + n] = sample["mrope_positions"][:, :n]
            else:
                mrope[bi, :, offset:offset + n] = np.arange(n)
            if "image_token_mask" in sample:
                img_mask[bi, offset:offset + n] = sample["image_token_mask"][:n]
            if "pixel_values" in sample:
                patch_arrs.append(sample["pixel_values"])
                grids.extend(list(sample["image_grid_thw"]))
            offset += n

    if not patch_arrs:
        batch["mrope_positions"] = mrope
        return batch
    pixels = np.concatenate(patch_arrs)
    p = pixels.shape[0]
    if max_patches and p > max_patches:
        raise ValueError(f"micro-batch has {p} vision patches > max_patches={max_patches}; "
                         f"raise DataloaderConfig.max_patches or lower max_pixels")
    total = max_patches or p
    if p < total:
        pixels = np.concatenate([pixels, np.zeros((total - p, pixels.shape[1]), pixels.dtype)])
    geo = vision_geometry(grids, num_grid_per_side, merge_size, total_patches=total)
    n_merged = p // merge_size ** 2
    if int(img_mask.sum()) != n_merged:
        raise ValueError(f"image-context tokens ({int(img_mask.sum())}) != merged vision "
                         f"tokens ({n_merged}): a truncated sample desynced the vision scatter")
    batch.update({"pixel_values": pixels, "image_token_mask": img_mask,
                  "mrope_positions": mrope, **geo})
    return batch
