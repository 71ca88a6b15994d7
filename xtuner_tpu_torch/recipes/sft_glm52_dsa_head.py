"""GLM-5.2's DSA sparse attention in SFT on one card: the model's three
dense head layers at full width behind the port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_glm52_dsa_head.py

A `DenseConfig` built from `model/glm.py::glm_52()`'s fields: hidden 6144,
DSA attention with 64 heads (q_lora 2048, kv_lora 512, qk_nope 192,
qk_rope 64, v_head 256; a lightning indexer of 32 heads x 128, top-k 2048),
dense MLP 12288, an untied vocab of 154880, rms eps 1e-5, rope theta 8e6.
The selection is block-granular (`select_granularity="block"`,
`index_block=256`: the public top-k of 2048 keeps 8 key blocks per q-block),
the path of the block-sparse kernels #14 and #15; the CE is JAX's default
"chunk" mode; remat "full" (each layer, indexer included, is one
checkpoint); bf16 compute; AdamW. One packed row of 16384 tokens per step
from the repo's alpaca demo with the UTF-8 byte toy tokenizer, 4 steps,
random weights from `seed`.

3.156 B params (191.2 M attention and 226.5 M MLP per layer, 0.95 B each
for the embedding and the head): 16 B/param of f32 master, gradient and
Adam state is 50.5 GB (47.0 GiB). Depth is cut from GLM-5.2's 78 layers
to its 3 dense head layers (`first_k_dense_replace=3`), because one MoE
layer (256 experts x 3 x 6144 x 2048) alone needs 155 GB of such state.
Nothing else is cut.
"""

import dataclasses
from pathlib import Path

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.model.dense import DenseConfig
from xtuner_tpu_torch.model.glm import glm_52
from xtuner_tpu_torch.train.trainer import TrainerConfig

_DEMO = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"
_GLM = glm_52()
# every DenseConfig field from the preset, then the three changes: depth,
# the dense class (no experts, router or MTP) and the block granularity
_FIELDS = {f.name: getattr(_GLM, f.name) for f in dataclasses.fields(DenseConfig)}
_FIELDS.update(
    num_hidden_layers=_GLM.first_k_dense_replace,
    attention=dataclasses.replace(_GLM.attention, select_granularity="block",
                                  index_block=256),
)

trainer = TrainerConfig(
    model_cfg=DenseConfig(**_FIELDS),
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(_DEMO))],
        pack_max_length=16384,
        tokenize_num_proc=1,  # 128 conversations: no worker processes
    ),
    optim_cfg=AdamWConfig(lr=1e-4),
    lr_cfg=LRConfig(warmup_steps=1),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="full"),
    global_batch_rows=1,
    micro_batch_rows=1,
    total_steps=4,
    work_dir="work_dirs",
    exp_name="sft_glm52_dsa_head",
)
