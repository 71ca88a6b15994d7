"""BASELINE config 3, InternVL-8B multimodal SFT (dynamic image tiling +
vision-token packing), on one card behind the port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_internvl_8b_vlm.py

`examples/v1/sft_internvl_8b_vlm.py` field for field:
- the ViT: InternViT-300M, tiles of 448 in patches of 14 (1025 tokens
  with the cls token), hidden 1024, MLP 4096, 24 layers of 16 heads of 64,
  pixel shuffle 0.5 (256 tokens a tile of width 4096), frozen;
- the projector 4096 -> 4096 -> 4096;
- the language model `qwen3_8b()`: hidden 4096, 32 / 8 heads of 128 with
  qk-norm, MLP 12288, an untied vocab of 151,936, the CE in its "chunk"
  mode;
- packs of 16384 tokens, 8 rows a step, at most 48 tiles a micro-batch,
  256 tokens a tile, at most 12 tiles an image; AdamW at 2e-5 with a 3%
  warmup; remat "save_attn"; bf16 compute.

What differs, and why:
- `image_context_token_id` is the toy tokenizer's `<IMG_CONTEXT>` (261),
  not 151667: there is no `tokenizer_path` (no published tokenizer in the
  repository), so the `Trainer` builds the UTF-8 byte toy with InternVL's
  three specials;
- the data is `demo_set`'s, written at first use under
  `work_dirs/internvl_demo/` (git-ignored), not `/data/vlm_sft.jsonl`;
- `load_from` is `EXPORT`, the port's own `save_hf_checkpoint` of this
  model's seeded random weights (`write_export`; `chip_smoke.py` writes it
  and deletes it after the run), not a published checkpoint;
- **the language model is cut in depth to `LAYERS` of its 36 layers, at
  full width**: at 16 B a trainable param (f32 master, gradient, Adam m
  and v) the embedding, the head and the projector take 20.0 GB and each
  layer 3.09 GB, and "save_attn" holds each layer's input and attention
  output, 2 x 8 x 16384 x 4096 bf16 = 2.15 GB, beside a layer's backward
  (the MLP's 8 x 16384 x 12288 gate, up and product, ~9.7 GB); on one
  H100 (79.2 GiB) 8 layers ran out of memory at one micro-batch of 8
  rows, and 6 peak at 67.8 GiB (PERF.md);
- 4 steps (`total_steps`), one micro-batch of 8 rows each, as the example.

The demo set (`demo_set`): 144 conversations, conversation i the alpaca
demo rows i, i + 1, ... (mod 128) as `TURNS` user / assistant turns
(2,759-5,163 toy tokens, 3,385 on average), so 4 or 5 fill a pack of
16384; a quarter of them have, before the first question, one image
(seeded `.npy` noise) of `SIZES[i % 16]`: 448 x 448 (1 tile), 448 high x
896 wide (2 tiles + a thumbnail) or 896 high x 1344 wide (6 + a
thumbnail). The 32 packs and their order are fixed by the seed; each
step's micro-batch, as `DataloaderConfig.build` makes it (a CPU run of
this config's data plane), is in `MICRO_BATCHES`: (tokens of the 8 x
16384 positions, real tiles of the 48, image-context tokens) = (125,731,
17, 4,352), (123,783, 19, 4,864), (122,867, 43, 11,008), (115,098, 29,
7,424): fills of 95.9%, 94.4%, 93.7% and 87.8%. No micro-batch exceeds 48
tiles, so the collator never raises.

Params (`PARAMS`, 2,739,925,504): the tower 304,012,288 (frozen), the
projector 33,570,816, the language model 2,402,342,400 (the embedding and
the head 1,244,659,712, 6 layers of 192,946,432, the final norm).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.datasets.vlm import IMG_SPECIALS
from xtuner_tpu_torch.model.compose import ComposeConfig
from xtuner_tpu_torch.model.qwen import qwen3_8b
from xtuner_tpu_torch.model.vision import ViTConfig
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer
from xtuner_tpu_torch.train.trainer import TrainerConfig

_ALPACA = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"
LAYERS = 6  # of qwen3_8b's 36, at full width
N_CONV = 144
TURNS = 15
# (height, width) of conversation i % 16's image, or no image
SIZES = ((448, 448), None, None, None, (448, 896), None, None, None, (448, 448), None, None,
         None, (896, 1344), None, None, None)
SEED = 0
EXPORT = Path("work_dirs") / "internvl_8b_export"
PARAMS = 2_739_925_504
# (tokens, real tiles, image-context tokens) of each step's micro-batch
MICRO_BATCHES = ((125731, 17, 4352), (123783, 19, 4864), (122867, 43, 11008),
                 (115098, 29, 7424))


def demo_set(root: Path = Path("work_dirs") / "internvl_demo") -> Path:
    """Write (once) the demo conversations and their images under `root`;
    returns the jsonl's absolute path."""
    path = root.resolve() / "internvl_demo.jsonl"
    if path.exists():
        return path
    root = path.parent
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    rows = [json.loads(line)["messages"] for line in _ALPACA.read_text().splitlines()]
    lines = []
    for i in range(N_CONV):
        turns = [rows[(i + t) % len(rows)] for t in range(TURNS)]
        messages = [m for pair in turns for m in pair]
        size = SIZES[i % len(SIZES)]
        if size is not None:
            img = root / f"image_{i:03d}.npy"
            np.save(img, rng.integers(0, 256, (*size, 3), dtype=np.uint8))
            messages[0] = {"role": "user", "content": [
                {"type": "image", "image": str(img)},
                {"type": "text", "text": messages[0]["content"]}]}
        lines.append(json.dumps({"messages": messages}))
    tmp = path.with_suffix(".tmp")
    tmp.write_text("\n".join(lines) + "\n")
    tmp.rename(path)  # the jsonl appears only once every image is written
    return path


_tok = UTF8ByteTokenizer(IMG_SPECIALS)
model_cfg = ComposeConfig(
    vision_cfg=ViTConfig(image_size=448, patch_size=14, hidden_size=1024,
                         intermediate_size=4096, num_hidden_layers=24,
                         num_attention_heads=16, downsample_ratio=0.5),
    text_cfg=dataclasses.replace(qwen3_8b(), num_hidden_layers=LAYERS),
    image_context_token_id=_tok.special_ids["<IMG_CONTEXT>"],
    freeze_vision=True,
)


def write_export(seed: int = SEED, path: Path = EXPORT, device=None) -> Path:
    """The model's seeded random weights as an HF checkpoint at `path`
    (the port's `save_hf_checkpoint`), for `load_from`."""
    import torch

    from xtuner_tpu_torch.checkpoint.hf import save_hf_checkpoint
    from xtuner_tpu_torch.engine.train_engine import resolve_device
    from xtuner_tpu_torch.module.params import init_params

    model = model_cfg.build()
    dev = resolve_device(device)
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                         dev, torch.bfloat16)
    save_hf_checkpoint(path, params, model.hf_key_map())
    return path


trainer = TrainerConfig(
    model_cfg=model_cfg,
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(demo_set()), class_name="internvl")],
        pack_max_length=16384,
        max_tiles=48,
        tokens_per_tile=256,
        image_size=448,
        image_max_num=12,
        tokenize_num_proc=1,
        num_workers=1,  # a thread tiles the next micro-batch's images during the step
    ),
    optim_cfg=AdamWConfig(lr=2e-5),
    lr_cfg=LRConfig(warmup_ratio=0.03),
    mesh_cfg=MeshConfig(fsdp_size=-1, remat_policy="save_attn"),
    global_batch_rows=8,
    micro_batch_rows=8,
    total_steps=4,
    load_from=str(EXPORT),
    work_dir="work_dirs",
    exp_name="internvl_8b_vlm",
)
