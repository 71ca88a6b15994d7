"""moe_heavy SFT in tile-wise fp8 on one card: `bench.py`'s fp8 row
(`_build_cfg(layers=10, moe_inter=768, experts=16, topk=8)` under
`BENCH_FP8=e4m3`, `bench.py:209-223`) behind the port's `sft` CLI.

    python -m xtuner_tpu_torch.train.cli.sft --config xtuner_tpu_torch/recipes/sft_moe_heavy_fp8.py

`recipes/sft_moe_heavy.py` with `float8_cfg=Float8Config()`: e4m3,
tile-wise (1 x 128 activation tiles, 128 x 128 weight blocks), bf16
backward for the attention projections. The four attention projections run
through the fp8 GEMM (TPU kernel #11); the three expert GEMMs through the
fp8 grouped GEMMs (#12 forward and dgrad, #13 wgrad), their backward in fp8
too. The router, the embedding and the CE stay bf16. Full width and depth,
nothing cut; random weights from `seed`, the UTF-8 byte toy tokenizer and
the repo's alpaca demo.
"""

from pathlib import Path

from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.model.moe import MoEConfig
from xtuner_tpu_torch.module.attention import MHAConfig
from xtuner_tpu_torch.module.router import GreedyRouterConfig
from xtuner_tpu_torch.ops.float8 import Float8Config
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
        float8_cfg=Float8Config(),
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
    exp_name="sft_moe_heavy_fp8",
)
