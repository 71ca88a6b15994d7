"""InternVL's data plane: dynamic image tiling and the image-context
tokenization (counterpart: `xtuner_tpu/datasets/vlm.py`; numpy only).

- Video frames: `get_frame_indices` (one frame per uniform interval,
  "rand" seeded or "middle"; "fpsX"), `_stable_int` (a per-item int from
  a sha256 of the item, stable between the token count and the load),
  `load_video_frames` (a (T, H, W, 3) array, a `.npy` clip, a directory of
  frames, a `.gif`; PIL is imported only for image files, as JAX does) and
  `preprocess_frame` (one 448 tile a frame, no tiling);
- tiling: `find_closest_aspect_ratio` (ties go to the later grid when the
  image's area is over half the grid's), `_resize` (bilinear, the one copy
  of the port: `model/qwen3_vl.py` imports it), `dynamic_preprocess`
  ((T, 3, S, S) ImageNet-normalized f32 tiles, plus a thumbnail when there
  is more than one) and `dynamic_num_patch` (the tile count alone);
- `InternVLTokenizeFn`: each image becomes IMG_START + IMG_CONTEXT x
  (tiles x tokens_per_tile) + IMG_END, each video frame
  "Frame-k: " + the same with one tile, the sample's tiles stacked in
  order as `pixel_values`;
- `vlm_collator`: `sft_llm_collator`, then the micro-batch's tiles stacked
  row-major over the packs and padded with zero tiles to `max_tiles`;
  above `max_tiles` it raises, as JAX's does.

Where the port differs from JAX, on purpose (ROADMAP.md, known faults in
the reference; `tests/test_torch_internvl.py` shows both):
- a sample whose `max_length` cut falls before the end of its last
  image-context token is dropped whole (`num_tokens` 0, no ids, no tiles:
  the packer skips it, with a warning). JAX keeps every tile of such a
  sample while cutting its context tokens, and its compose model maps the
  k-th context token to the k-th vision token, so every later image of the
  micro-batch lands on another image's tokens. A cut after the last
  context token keeps the sample, as JAX does;
- `vlm_collator` drops a sample with tiles that its pack row cannot hold
  whole (its tokens and its tiles), where JAX's `sft_llm_collator` cuts
  the sample and keeps its tiles (the same shift). Soft packs hold every
  sample whole unless it is longer than the pack, so this drops only such
  a sample, alone in its row.
Dropping keeps a run going on one long sample, which a raise would end;
both keep every image on its own tokens.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..data_proto.templates import ChatMessages, get_chat_template
from ..utils.logger import get_logger
from .collator import sft_llm_collator
from .tokenize_fns import _tokenizer_fingerprint

logger = get_logger()

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

IMG_TOKEN = "<image>"
VIDEO_TOKEN = "<video>"
IMG_START, IMG_END, IMG_CONTEXT = "<img>", "</img>", "<IMG_CONTEXT>"
IMG_SPECIALS = [IMG_START, IMG_END, IMG_CONTEXT]  # the toy tokenizer's InternVL specials


def get_frame_indices(num_frames: int, vlen: int, sample: str = "rand",
                      seed: Optional[int] = None) -> list[int]:
    """Frame indices from a clip of `vlen` frames: uniform intervals, one
    frame each ("rand" inside it from a generator seeded with `seed`,
    "middle" at its centre); a short clip repeats its last frame. "fpsX"
    takes every 1 / X-th frame (at most num_frames when given)."""
    if sample.startswith("fps"):
        step = max(1.0 / float(sample[3:]), 1.0)
        idx = np.arange(0, vlen, step).astype(int).tolist()
        return idx if not num_frames else idx[:num_frames]
    acc = min(num_frames, vlen)
    intervals = np.linspace(0, vlen, acc + 1).astype(int)
    rng = np.random.default_rng(seed)
    indices: list[int] = []
    for lo, hi in zip(intervals[:-1], intervals[1:]):
        hi = max(hi - 1, lo + 1)
        if sample == "rand":
            indices.append(int(rng.integers(lo, hi)))
        else:  # middle
            indices.append(int((lo + hi - 1) // 2))
    if len(indices) < num_frames:
        indices += [indices[-1]] * (num_frames - len(indices))
    return indices


def _stable_int(key: dict, lo: int, hi: int) -> int:
    """An int in [lo, hi] from the sha256 of `key` (the same in the token
    count and the load)."""
    digest = hashlib.sha256(json.dumps(key, sort_keys=True, default=str).encode())
    return lo + int.from_bytes(digest.digest()[:4], "little") % (hi - lo + 1)


def load_video_frames(ref, num_frames: int, sample: str = "rand",
                      seed: Optional[int] = None,
                      clip: Optional[tuple[float, float]] = None) -> list[np.ndarray]:
    """-> `num_frames` (H, W, 3) frames of a (T, H, W, 3) array, a `.npy`
    clip, a directory of frames (`.npy`, or images read with PIL) or a
    `.gif` (PIL); `clip=(start, end)` fractions restrict the sampling."""
    if isinstance(ref, np.ndarray):
        frames = list(ref)
    else:
        path = Path(ref)
        if path.suffix == ".npy":
            frames = list(np.load(path))
        elif path.is_dir():
            files = sorted(p for p in path.iterdir()
                           if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".npy"))
            frames = [np.load(p) if p.suffix == ".npy" else _read_image_file(p) for p in files]
        elif path.suffix.lower() == ".gif":
            from PIL import Image, ImageSequence

            with Image.open(path) as im:
                frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
        else:
            raise ValueError(
                f"unsupported video source {ref!r}: use a (T,H,W,3) array, "
                f".npy clip, frame directory, or .gif (mp4 decode needs a "
                f"video backend this image doesn't ship)")
    if clip is not None:
        lo = int(clip[0] * len(frames))
        hi = max(int(clip[1] * len(frames)), lo + 1)
        frames = frames[lo:hi]
    idx = get_frame_indices(num_frames, len(frames), sample, seed)
    return [frames[i] for i in idx]


def _read_image_file(path: Path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _normalize(tiles: np.ndarray) -> np.ndarray:
    """(T, S, S, 3) pixels -> (T, 3, S, S) ImageNet-normalized f32."""
    out = (tiles / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return out.transpose(0, 3, 1, 2).astype(np.float32)


def preprocess_frame(frame: np.ndarray, image_size: int = 448) -> np.ndarray:
    """One video frame -> (1, 3, S, S): resized whole, no tiling."""
    return _normalize(_resize(frame, image_size, image_size)[None])


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios, width: int, height: int,
                              image_size: int):
    """The (i, j) tile grid whose aspect ratio is nearest the image's; on a
    tie the later grid when the image's area is over half the grid's."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize (H, W, C) uint8 or float -> (h, w, C) float32."""
    src_h, src_w = img.shape[:2]
    ys = np.linspace(0, src_h - 1, h)
    xs = np.linspace(0, src_w - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, src_h - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _target_ratios(min_num: int, max_num: int) -> list[tuple[int, int]]:
    return sorted({(i, j) for n in range(min_num, max_num + 1)
                   for i in range(1, n + 1) for j in range(1, n + 1)
                   if min_num <= i * j <= max_num}, key=lambda r: r[0] * r[1])


def dynamic_preprocess(image: np.ndarray, image_size: int = 448, max_num: int = 12,
                       min_num: int = 1, use_thumbnail: bool = True) -> np.ndarray:
    """(H, W, 3) -> (T, 3, S, S) normalized f32 tiles, row-major over the
    grid, then the thumbnail when there is more than one tile."""
    h, w = image.shape[:2]
    ti, tj = find_closest_aspect_ratio(w / h, _target_ratios(min_num, max_num), w, h,
                                       image_size)
    resized = _resize(image, image_size * ti, image_size * tj)
    tiles = [resized[row * image_size:(row + 1) * image_size,
                     col * image_size:(col + 1) * image_size]
             for row in range(tj) for col in range(ti)]
    if use_thumbnail and len(tiles) > 1:
        tiles.append(_resize(image, image_size, image_size))
    return _normalize(np.stack(tiles))


def dynamic_num_patch(width: int, height: int, image_size: int = 448, max_num: int = 12,
                      min_num: int = 1, use_thumbnail: bool = True) -> int:
    """`dynamic_preprocess`'s tile count without touching the pixels."""
    ti, tj = find_closest_aspect_ratio(width / height, _target_ratios(min_num, max_num),
                                       width, height, image_size)
    n = ti * tj
    return n + 1 if use_thumbnail and n > 1 else n


class InternVLTokenizeFn:
    """OpenAI-format chat whose user content may hold {"type": "image"} /
    "image_url" and "video" / "video_url" items, or a literal `<image>` /
    `<video>` with the item's "image" / "video": each image becomes
    IMG_START + IMG_CONTEXT x (tiles x tokens_per_tile) + IMG_END, each
    video frame one tile's worth. A sample that `max_length` would cut
    before its last context token is dropped whole (the module's
    docstring)."""

    is_vlm = True

    def __init__(self, tokenizer, chat_template: str = "qwen",
                 image_size: int = 448, max_num: int = 12, tokens_per_tile: int = 256,
                 img_start_token: str = IMG_START, img_end_token: str = IMG_END,
                 img_context_token: str = IMG_CONTEXT,
                 image_root: Optional[str] = None, max_length: Optional[int] = None,
                 min_num_frames: int = 4, max_num_frames: int = 24,
                 video_context_token: Optional[str] = None,
                 frame_sample: str = "rand"):
        self.tokenizer = tokenizer
        self.chat_template = get_chat_template(chat_template)
        self.image_size = image_size
        self.max_num = max_num
        self.tokens_per_tile = tokens_per_tile
        self.img_start = img_start_token
        self.img_end = img_end_token
        self.img_context = img_context_token
        self.image_root = Path(image_root) if image_root else None
        self.max_length = max_length
        self.min_num_frames = min_num_frames
        self.max_num_frames = max_num_frames
        self.video_context = video_context_token or img_context_token
        self.frame_sample = frame_sample
        self.img_context_id = tokenizer.encode(img_context_token, add_special_tokens=False)[0]
        self.video_context_id = tokenizer.encode(self.video_context,
                                                 add_special_tokens=False)[0]

    def _path(self, ref):
        path = Path(ref)
        return self.image_root / path if self.image_root and not path.is_absolute() else path

    def _expand_video(self, ref, item: dict) -> tuple[str, np.ndarray]:
        """The item's frames (count and sampling seeded by the item), one
        tile each, and the "Frame-k: <img>ctx*N</img>" text."""
        key = {"item": item.get("id", item.get("messages", "")), "video": str(ref)}
        n = _stable_int(key, self.min_num_frames, self.max_num_frames)
        src = ref if isinstance(ref, np.ndarray) else self._path(ref)
        frames = load_video_frames(src, n, self.frame_sample,
                                   seed=_stable_int(key, 0, 2**31 - 1), clip=item.get("clip"))
        tiles = np.concatenate([preprocess_frame(f, self.image_size) for f in frames])
        one = self.img_start + self.video_context * self.tokens_per_tile + self.img_end
        return "\n".join(f"Frame-{i + 1}: {one}" for i in range(len(frames))), tiles

    def _load_image(self, ref) -> np.ndarray:
        if isinstance(ref, np.ndarray):
            return ref
        path = self._path(ref)
        return np.load(path) if path.suffix == ".npy" else _read_image_file(path)

    def _image(self, ref) -> tuple[str, np.ndarray]:
        tiles = dynamic_preprocess(self._load_image(ref), self.image_size, self.max_num)
        n_ctx = tiles.shape[0] * self.tokens_per_tile
        return self.img_start + self.img_context * n_ctx + self.img_end, tiles

    def __call__(self, item: dict[str, Any]) -> dict:
        pixel_tiles = []
        messages = []
        for msg in item["messages"]:
            content = msg.get("content", "")
            if isinstance(content, list):
                text_parts = []
                for part in content:
                    if part.get("type") in ("image_url", "image"):
                        text, tiles = self._image(part.get("image_url", part.get("image")))
                    elif part.get("type") in ("video_url", "video"):
                        text, tiles = self._expand_video(
                            part.get("video_url", part.get("video")), item)
                    else:
                        text_parts.append(part.get("text", ""))
                        continue
                    pixel_tiles.append(tiles)
                    text_parts.append(text)
                content = "".join(text_parts)
            elif IMG_TOKEN in content and "image" in item:
                text, tiles = self._image(item["image"])
                pixel_tiles.append(tiles)
                content = content.replace(IMG_TOKEN, text, 1)
            elif VIDEO_TOKEN in content and "video" in item:
                text, tiles = self._expand_video(item["video"], item)
                pixel_tiles.append(tiles)
                content = content.replace(VIDEO_TOKEN, text, 1)
            messages.append({**msg, "content": content})

        out = ChatMessages(messages=messages).tokenize(self.tokenizer, self.chat_template)
        if self.max_length is not None and out["num_tokens"] > self.max_length:
            if pixel_tiles and self._cuts_context(out["input_ids"]):
                logger.warning(f"dropping a sample of {out['num_tokens']} tokens: max_length "
                               f"{self.max_length} would cut its image-context tokens")
                return {"input_ids": [], "labels": [], "num_tokens": 0}
            out["input_ids"] = out["input_ids"][: self.max_length]
            out["labels"] = out["labels"][: self.max_length]
            out["num_tokens"] = self.max_length
        if pixel_tiles:
            out["pixel_values"] = np.concatenate(pixel_tiles)
        return out

    def _cuts_context(self, ids) -> bool:
        """Whether a cut at max_length falls before the last context token."""
        ctx = np.isin(np.asarray(ids), [self.img_context_id, self.video_context_id])
        return bool(ctx[self.max_length:].any())

    def hash(self) -> str:
        key = json.dumps(["internvl", _tokenizer_fingerprint(self.tokenizer), self.image_size,
                          self.max_num, self.tokens_per_tile, self.min_num_frames,
                          self.max_num_frames, self.video_context, self.frame_sample,
                          dataclasses.asdict(self.chat_template), self.max_length],
                         sort_keys=True, default=str)
        return hashlib.sha256(key.encode()).hexdigest()[:16]


def _whole_samples(pack: list[dict], pack_max_length: int) -> list[dict]:
    """The pack without its samples with tiles that the row cannot hold
    whole (a text sample may still be cut, as `sft_llm_collator` cuts it)."""
    kept, offset = [], 0
    for s in pack:
        n = len(s["input_ids"])
        if "pixel_values" in s and offset + n > pack_max_length:
            logger.warning(f"dropping a sample with {len(s['pixel_values'])} image tiles: its "
                           f"{n} tokens do not fit the row's {pack_max_length - offset}")
            continue
        kept.append(s)
        offset += n
    return kept


def vlm_collator(packs: list[list[dict]], pack_max_length: int,
                 loss_reduction: str = "token", max_tiles: Optional[int] = None,
                 pad_token_id: int = 0) -> dict:
    """`sft_llm_collator` over the packs (without samples whose tiles the
    row cannot hold whole) plus `pixel_values`, their tiles stacked in pack
    order and padded with zero tiles to `max_tiles`; more tiles than
    `max_tiles` raises."""
    packs = [_whole_samples(p, pack_max_length) for p in packs]
    batch = sft_llm_collator(packs, pack_max_length, loss_reduction, pad_token_id=pad_token_id)
    tiles = [s["pixel_values"] for pack in packs for s in pack if "pixel_values" in s]
    if tiles:
        pixel_values = np.concatenate(tiles)
        if max_tiles is not None:
            t = pixel_values.shape[0]
            if t > max_tiles:
                # cutting tiles would shift every later image onto other tokens
                raise ValueError(
                    f"micro-batch has {t} image tiles > max_tiles={max_tiles}; "
                    f"raise DataloaderConfig.max_tiles or lower image_max_num")
            if t < max_tiles:
                pad = np.zeros((max_tiles - t, *pixel_values.shape[1:]), pixel_values.dtype)
                pixel_values = np.concatenate([pixel_values, pad])
        batch["pixel_values"] = pixel_values
    return batch
