"""Qwen3-VL-4B in SFT on one card, whole, behind the port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_qwen3_vl_4b.py

`model/qwen3_vl.py::qwen3_vl_4b()` at full width and full depth:
- the vision tower: 24 blocks, hidden 1024, 16 heads of 64 (no GQA), MLP
  4096 with gelu_pytorch_tanh, patch 16, temporal patch 2, merge 2, 2304
  position embeddings (a 48 x 48 grid), deepstack after blocks 5, 11 and
  17, each block's attention bidirectional within its image;
- the projector: the merger and 3 deepstack mergers (4096 -> 4096 ->
  2560);
- the language model: 36 layers, hidden 2560, 32 / 8 heads of 128 with
  qk-norm, MLP 9728, a tied vocab of 151,936, interleaved MRoPE with
  sections [24, 20, 20] and theta 5e6.

4,437,815,808 params: vision 306,242,560, projector 109,105,152,
language 4,022,468,096 (the tied embedding 388,956,160, the 36 layers
3,633,509,376). At 16 B/param (f32 master, gradient, Adam m and v) that
is 71.0 GB (66.1 GiB) of the card's 79.6 GiB. Nothing is cut. The only
change to the preset is the four vision token ids, set to those of the
toy tokenizer below (the batch's image-token mask places the vision
tokens either way).

Training: one packed row of 8192 tokens a step, 4 steps; remat "full"
(each text layer and each vision block one checkpoint); the CE in the
preset's "chunk" mode; bf16 compute; AdamW; random f32 masters from the
seed.

Data: `demo_set` writes, at first use, a demo set under
`work_dirs/qwen3_vl_demo/` (git-ignored): the first `N_ROWS` alpaca demo
rows of `examples/demo_data/alpaca_demo.jsonl`, each with one image
before the instruction, drawn from a seeded numpy generator and saved as
`.npy` (no PIL, no download). The images cycle through three sizes that
`smart_resize` keeps as they are (multiples of 32): 512 x 512 (1024
patches, 256 image tokens), 1024 wide x 768 high (3072 patches, 768
tokens) and 1024 x 1024 (4096 patches, 1024 tokens). `max_patches` is
32768 = 4 x 8192, so no pack of 8192 tokens can exceed it. The tokenizer
is the UTF-8 byte toy with the three vision specials, which the
`Trainer` builds for a qwen3_vl dataset without a `tokenizer_path`. A
row's ~9 images take ~2 s to preprocess on the host, as long as a step
on the card: one prefetch thread (`num_workers=1`) does it during the
step before.

On the card machine a call may write at most 45 GiB, and the final save
(params and Adam state at 12 B/param, ~53 GB) is over it:
`chip_smoke.py`'s vlm_train phase runs this recipe through `fit_recipe`,
which skips the save.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.datasets.qwen_vl import VL_SPECIALS
from xtuner_tpu_torch.model.qwen3_vl import qwen3_vl_4b
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer
from xtuner_tpu_torch.train.trainer import TrainerConfig

_ALPACA = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"
N_ROWS = 48  # ~5 packs of 8192 tokens
SIZES = ((512, 512), (768, 1024), (1024, 1024))  # (height, width)
SEED = 0


def demo_set(root: Path = Path("work_dirs") / "qwen3_vl_demo") -> Path:
    """Write (once) the demo conversations and their images under `root`;
    returns the jsonl's absolute path."""
    path = root.resolve() / "qwen3_vl_demo.jsonl"
    if path.exists():
        return path
    root = path.parent
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    rows = [json.loads(line) for line in _ALPACA.read_text().splitlines()[:N_ROWS]]
    lines = []
    for i, row in enumerate(rows):
        img = root / f"image_{i:03d}.npy"
        np.save(img, rng.integers(0, 256, (*SIZES[i % 3], 3), dtype=np.uint8))
        user, answer = row["messages"][0], row["messages"][1]
        lines.append(json.dumps({"messages": [
            {"role": "user", "content": [{"type": "image", "image": str(img)},
                                         {"type": "text", "text": user["content"]}]},
            {"role": "assistant", "content": answer["content"]}]}))
    tmp = path.with_suffix(".tmp")
    tmp.write_text("\n".join(lines) + "\n")
    tmp.rename(path)  # the jsonl appears only once every image is written
    return path


_tok = UTF8ByteTokenizer(VL_SPECIALS)
_model = qwen3_vl_4b()
model_cfg = dataclasses.replace(
    _model, image_token_id=_tok.special_ids["<|image_pad|>"],
    video_token_id=_tok.special_ids["<|image_pad|>"],
    vision_start_token_id=_tok.special_ids["<|vision_start|>"],
    vision_end_token_id=_tok.special_ids["<|vision_end|>"])

trainer = TrainerConfig(
    model_cfg=model_cfg,
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(demo_set()), class_name="qwen3_vl")],
        pack_max_length=8192,
        tokenize_num_proc=1,  # 48 conversations: no worker processes
        num_workers=1,  # a thread prepares the next row's images during the step
        max_patches=4 * 8192,
        vision_num_grid_per_side=_model.vision_cfg.num_grid_per_side,
    ),
    optim_cfg=AdamWConfig(lr=1e-4),
    lr_cfg=LRConfig(warmup_steps=1),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="full"),
    global_batch_rows=1,
    micro_batch_rows=1,
    total_steps=4,
    work_dir="work_dirs",
    exp_name="sft_qwen3_vl_4b",
)
