"""Qwen3-4B whole in GRPO on one card, behind the port's `rl` CLI.

    python -m xtuner_tpu_torch.train.cli.rl --config xtuner_tpu_torch/recipes/rl_qwen3_4b_grpo.py

The registry's "qwen3-4b" at full width and full depth: 36 layers, hidden
2560, 32 / 8 heads of 128 with qk-norm, MLP 9728, a tied vocab of
151,936; 4,022,468,096 params. Nothing is cut. At 16 B/param (f32
master, gradient, Adam m and v) the trainer holds 64.4 GB, and the frozen
reference of the KL term 8.0 GB more in bf16 (`rl/trainer.py`), of the
card's 79.6 GiB.

Training: `prompts_per_step` 4 prompts x `group_size` 8 rollouts, each
prompt up to `max_prompt_length` 128 tokens and `max_new_tokens` 384, so
the packed step is 32 rows of 512 = 16,384 tokens in one micro-batch;
bf16 compute, remat "full", the CE in the preset's "chunk" mode; AdamW at
lr 1e-6, constant; GRPO with `kl_coef` 0.001 (k3); sampling at
temperature 1.0; random f32 masters from the seed.

Data: `prompt_set` writes, at first use, `N_PROMPTS` seeded synthetic
arithmetic word problems under `work_dirs/rl_arith/` (git-ignored), each
with its answer in GSM8K's `#### n` label format, judged by the "gsm8k"
judger. The tokenizer is the UTF-8 byte toy; each encoded prompt fits in
128 tokens. With random weights no answer is right: every reward is 0
and so is every advantage.
"""

import json
from pathlib import Path

import numpy as np

from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.model.generate import GenerateConfig
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.rl.grpo_loss import GRPOLossConfig
from xtuner_tpu_torch.rl.trainer import RLTrainerConfig

N_PROMPTS = 256
SEED = 0
FORMS = (
    "Tom has {a} apples and buys {b} more. How many apples does he have?",
    "A shop sold {a} pens on Monday and {b} on Tuesday. How many pens in all?",
    "Mia had {a} stickers and gave away {c}. How many stickers are left?",
    "Each box holds {a} eggs. How many eggs are in {d} boxes?",
)


def prompt_set(root: Path = Path("work_dirs") / "rl_arith") -> Path:
    """Write (once) the prompt jsonl under `root`; returns its absolute
    path."""
    path = root.resolve() / "arith_gsm8k_format.jsonl"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    lines = []
    for i in range(N_PROMPTS):
        a, b = (int(x) for x in rng.integers(10, 100, 2))
        c, d = int(rng.integers(1, a)), int(rng.integers(2, 10))
        form = FORMS[i % len(FORMS)]
        answer = (a + b, a + b, a - c, a * d)[i % len(FORMS)]
        lines.append(json.dumps({"prompt": form.format(a=a, b=b, c=c, d=d),
                                 "label": f"#### {answer}"}))
    tmp = path.with_suffix(".tmp")
    tmp.write_text("\n".join(lines) + "\n")
    tmp.rename(path)
    return path


model_cfg = get_model_config("qwen3-4b")

trainer = RLTrainerConfig(
    model_cfg=model_cfg,
    prompts_path=str(prompt_set()),
    optim_cfg=AdamWConfig(lr=1e-6),
    lr_cfg=LRConfig(lr_type="constant", warmup_ratio=0.0),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="full"),
    loss_cfg=GRPOLossConfig(kl_coef=0.001),
    gen_cfg=GenerateConfig(max_new_tokens=384, temperature=1.0),
    group_size=8,
    prompts_per_step=4,
    total_steps=10,
    max_prompt_length=128,
    judger="gsm8k",
    work_dir="work_dirs",
    exp_name="rl_qwen3_4b_grpo",
)
