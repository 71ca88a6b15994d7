"""Qwen3-30B-A3B's first 4 layers in GRPO with rollout-routing replay (R3),
behind the port's `rl` CLI.

    python -m xtuner_tpu_torch.train.cli.rl --config xtuner_tpu_torch/recipes/rl_qwen3_moe_head_r3.py

`model/moe.py::qwen3_moe_30b_a3()` at full width (hidden 2048, 32 / 4
heads of 128 with qk-norm, 128 experts of 768, top-8, a vocab of 151,936)
cut in depth to 4 of its 48 MoE layers, the cut the port's first MoE
train slice made; about 3.1 B params.

R3: the rollout records, for each sampled token, the expert ids of the
forward that sampled it (`generate(record_routing=True)`); `_pack` lays
them at the token's input position and -1 elsewhere, and the training
forward routes each recorded position to its recorded experts
(`module/router.py::route(forced_idx=)`), the prompt afresh.

Training: 2 prompts x 4 rollouts, prompts up to 128 tokens and 128 new
tokens, so 8 rows of 256; bf16 compute, remat "full"; AdamW lr 1e-6;
GRPO without KL; the prompts and judger of `rl_qwen3_4b_grpo.py`.
"""

import dataclasses

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.model.generate import GenerateConfig
from xtuner_tpu_torch.model.moe import qwen3_moe_30b_a3
from xtuner_tpu_torch.recipes.rl_qwen3_4b_grpo import prompt_set
from xtuner_tpu_torch.rl.grpo_loss import GRPOLossConfig
from xtuner_tpu_torch.rl.trainer import RLTrainerConfig

model_cfg = dataclasses.replace(qwen3_moe_30b_a3(), num_hidden_layers=4)

trainer = RLTrainerConfig(
    model_cfg=model_cfg,
    prompts_path=str(prompt_set()),
    optim_cfg=AdamWConfig(lr=1e-6),
    lr_cfg=LRConfig(lr_type="constant", warmup_ratio=0.0),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="full"),
    loss_cfg=GRPOLossConfig(),
    gen_cfg=GenerateConfig(max_new_tokens=128, temperature=1.0),
    group_size=4,
    prompts_per_step=2,
    total_steps=10,
    max_prompt_length=128,
    rollout_routing_replay=True,
    judger="gsm8k",
    work_dir="work_dirs",
    exp_name="rl_qwen3_moe_head_r3",
)
