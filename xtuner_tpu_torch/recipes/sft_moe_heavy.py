"""moe_heavy SFT on one card: `bench.py`'s primary configuration
(`_build_cfg` at its defaults, `bench.py:40-69`, `:174-182`) behind the
port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_moe_heavy.py

10 layers, hidden 1024, 16/8 heads of 128 with qk-norm, 16 experts top-8
of width 768, a tied vocab of 151936 (about 0.6 B params: 16 B/param of
f32 master, grad and Adam state is about 9.5 GB), fused CE, remat
"save_attn_residuals", bf16 compute, 2 packed rows of 8192 per step. Full
width and full depth, nothing cut. Random weights from `seed`, the UTF-8
byte toy tokenizer (ids < 300) and the repo's 128-conversation alpaca demo.
"""

from pathlib import Path

from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.model.moe import MoEConfig
from xtuner_tpu_torch.module.attention import MHAConfig
from xtuner_tpu_torch.module.router import GreedyRouterConfig
from xtuner_tpu_torch.train.trainer import TrainerConfig

_DEMO = Path(__file__).resolve().parents[2] / "examples" / "demo_data" / "alpaca_demo.jsonl"

trainer = TrainerConfig(
    model_cfg=MoEConfig(
        vocab_size=151936,
        num_hidden_layers=10,
        hidden_size=1024,
        intermediate_size=3072,
        moe_intermediate_size=768,
        n_routed_experts=16,
        num_experts_per_tok=8,
        tie_word_embeddings=True,
        rope_theta=1000000.0,
        balancing_loss_coef=0.001,
        router=GreedyRouterConfig(),
        attention=MHAConfig(num_attention_heads=16, num_key_value_heads=8, head_dim=128,
                            qk_norm=True),
        lm_loss_cfg=CELossConfig(chunk_size=2048, mode="fused"),
    ),
    dataloader_cfg=DataloaderConfig(
        datasets=[DatasetConfig(anno_path=str(_DEMO))],
        pack_max_length=8192,
        tokenize_num_proc=1,  # 128 conversations: no worker processes
    ),
    optim_cfg=AdamWConfig(lr=1e-5),
    lr_cfg=LRConfig(warmup_steps=2),
    mesh_cfg=MeshConfig(param_dtype="bfloat16", remat_policy="save_attn_residuals"),
    global_batch_rows=2,
    micro_batch_rows=2,
    total_steps=6,
    work_dir="work_dirs",
    exp_name="sft_moe_heavy",
)
