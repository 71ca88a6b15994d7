"""GLM-4.5-Air's noaux-routed MoE in SFT on one card: the model's dense
head layer and its first MoE layer at full width behind the port's `sft`
CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_glm45_air_head.py

`model/glm.py::glm_45_air()` with two changes: 2 of its 46 layers
(`first_k_dense_replace=1`: the dense layer, then one MoE layer) and no
MTP. Everything else is the preset's: hidden 4096, 96 q / 8 kv heads of
128 with qkv bias (a q-head group of 12), dense MLP 10944, 128 routed
experts top-8 of width 1408 and one shared expert, the sigmoid noaux
router (no groups, routed scaling 1, bias update speed 1e-3), rms eps
1e-5, rope theta 1e6, an untied vocab of 151552. The CE is JAX's default
"chunk" mode; remat "full"; bf16 compute; AdamW. One packed row of 8192
tokens per step from the repo's alpaca demo with the UTF-8 byte toy
tokenizer, 4 steps, random weights from `seed`.

3.827 B params: 620.8 M each for the embedding and the head, 243.6 M
for the dense layer (attention 109.1 M with its biases, MLP 134.5 M),
2.341 B for the MoE layer (routed experts 128 x 3 x 4096 x 1408 = 2.214
B, attention and router 109.6 M, shared expert 17.3 M). 16 B/param of f32
master, gradient and Adam state is 61.2 GB (57.0 GiB), which fits one
80 GB card. Cut: depth from 46 layers to 2, because every further MoE
layer adds 2.34 B params (37.5 GB of state); MTP from 1 layer to 0,
because its block is another such MoE layer (the state would reach
~99 GB). Nothing else is cut.
"""

import dataclasses
from pathlib import Path

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.model.glm import glm_45_air
from xtuner_tpu_torch.train.trainer import TrainerConfig

_DEMO = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"

trainer = TrainerConfig(
    model_cfg=dataclasses.replace(glm_45_air(), num_hidden_layers=2, mtp_num_layers=0),
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
    exp_name="sft_glm45_air_head",
)
