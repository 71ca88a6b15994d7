"""Qwen3-VL-8B on one card, whole, in the alignment stage: the vision
tower and the mergers train through the frozen language model.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_qwen3_vl_8b_align.py

The registry's "qwen3-vl-8b" (`model/qwen3_vl.py::qwen3_vl_8b()`) at full
width and depth, nothing cut, `freeze_language=True`:
- the vision tower: 27 blocks, hidden 1152, 16 heads of 72 (no GQA), MLP
  4304 with gelu_pytorch_tanh, patch 16, temporal patch 2, merge 2, 2304
  position embeddings, deepstack after blocks 8, 16 and 24; its attention
  bidirectional within each image: #1-#4 non-causal at (72, 72);
- the projector: the merger and 3 deepstack mergers (4608 -> 4608 ->
  4096);
- the language model, frozen: 36 layers, hidden 4096, 32 / 8 heads of 128
  with qk-norm, MLP 12288, an untied vocab of 151,936, interleaved MRoPE
  [24, 20, 20] at theta 5e6.

8,767,123,696 params: vision 415,891,440, projector 160,496,896 (576.4 M
train: 9.2 GB of f32 master, gradient and Adam m and v), language
8,190,735,360 (frozen: its f32 masters 32.8 GB, no gradient, no moments).
The frozen model still runs its backward for the gradient of its input
embeddings, which carry the vision tokens, but computes no weight
gradient. The only change to the preset is the four vision token ids,
set to those of the toy tokenizer (the batch's image-token mask places
the vision tokens either way).

Data and training as `recipes/sft_qwen3_vl_4b.py`, whose demo set this
recipe reuses (its `demo_set`, under `work_dirs/qwen3_vl_demo/`): patch
16, merge 2, one packed row of 8192 tokens a step, `max_patches` 32768;
remat "full"; the CE in the preset's "chunk" mode; bf16 compute; AdamW at
1e-4; 4 steps.

The final save (params and Adam state, ~40 GB) would come near the card
machine's 45 GiB write limit with the run's other files: `chip_smoke.py`'s
vlm8b_align phase runs this recipe through `fit_recipe`, which skips it.
"""

import dataclasses

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.datasets.qwen_vl import VL_SPECIALS
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.recipes.sft_qwen3_vl_4b import demo_set
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer
from xtuner_tpu_torch.train.trainer import TrainerConfig

_tok = UTF8ByteTokenizer(VL_SPECIALS)
_model = get_model_config("qwen3-vl-8b")
model_cfg = dataclasses.replace(
    _model, freeze_language=True,
    image_token_id=_tok.special_ids["<|image_pad|>"],
    video_token_id=_tok.special_ids["<|image_pad|>"],
    vision_start_token_id=_tok.special_ids["<|vision_start|>"],
    vision_end_token_id=_tok.special_ids["<|vision_end|>"])

trainer = TrainerConfig(
    model_cfg=model_cfg,
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(demo_set()), class_name="qwen3_vl")],
        pack_max_length=8192,
        tokenize_num_proc=1,
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
    exp_name="sft_qwen3_vl_8b_align",
)
