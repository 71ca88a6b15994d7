"""gpt-oss-20b in SFT on one card: its first two layers at full width
behind the port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_gpt_oss_20b_head.py

`model/gpt_oss.py::gpt_oss_20b()` with one change: 2 of its 24 layers.
Layer 0 has the sliding window of 128, layer 1 full attention (the
preset's `layer_window_pattern`). Everything else is the preset's: hidden
2880, 64 q / 8 kv heads of 64 with q/k/v and o biases and per-head
sinks, 32 routed experts top-4 of width 2880 with clipped swiglu behind
the softmax router, rms eps 1e-5, rope theta 1.5e5, an untied vocab of
201088. The CE is JAX's default "chunk" mode; remat "full"; bf16
compute; AdamW. One packed row of 8192 tokens per step from the repo's
alpaca demo with the UTF-8 byte toy tokenizer, 4 steps, random weights
from `seed`.

2.804 B params: 579.1 M each for the embedding and the head, 822.9 M a
layer (attention 26.55 M with its biases and sinks, router 0.09 M,
experts 32 x (2880 x 5760 + 2880 x 2880) = 796.3 M). 16 B/param of f32
master, gradient and Adam state is 44.9 GB (41.8 GiB). Cut: depth from
24 layers to 2, because every further pair of layers adds 1.646 B params
(26.3 GB of state): at 4 layers the state alone would be 66.3 GiB of the
card's 79.6, before the activations and the per-layer bf16 weight
copies. Nothing else is cut.
"""

import dataclasses
from pathlib import Path

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.model.gpt_oss import gpt_oss_20b
from xtuner_tpu_torch.train.trainer import TrainerConfig

_DEMO = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"

trainer = TrainerConfig(
    model_cfg=dataclasses.replace(gpt_oss_20b(), num_hidden_layers=2),
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(_DEMO))],
        pack_max_length=8192,
        tokenize_num_proc=1,  # 128 conversations: no worker processes
    ),
    optim_cfg=AdamWConfig(lr=1e-4),
    lr_cfg=LRConfig(warmup_steps=1),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="full"),
    global_batch_rows=1,
    micro_batch_rows=1,
    total_steps=4,
    work_dir="work_dirs",
    exp_name="sft_gpt_oss_20b_head",
)
