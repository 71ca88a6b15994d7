"""bench.py's `longctx_64k` row on one card: `_build_cfg(layers=10,
moe_inter=128, experts=64, topk=4)` (`bench.py:40-69`, `:198-207`), driven
through `TrainEngine.train_step` as `bench.py::_run_shape` drives it
(`:72-107`): AdamW lr 1e-5, 2 warmup steps, 100 total steps, remat
"save_out_lse" (`:84-86`, what `_run_shape` picks above 16384 positions),
one `fake_collator` row of 65536 random tokens (one document) shaped
(1, 1, L).

10 layers, hidden 1024, 16/8 heads of 128 with qk-norm, 64 experts top-4
of width 128, a tied vocab of 151936 (470.8 M params: 16 B/param of f32
master, grad and Adam state is 7.5 GB), fused CE, bf16 compute. Full
width and full depth, nothing cut. bench.py runs it with JAX's two
switches at their defaults; the port's longctx run sets
`XTUNER_ATTN_BWD=two_pass` and `XTUNER_FUSED_MLP=1` (`SWITCHES`), the only
row that takes both kernels.

    from xtuner_tpu_torch.recipes import bench_longctx_64k as r
    engine = TrainEngine(r.model_cfg, r.optim_cfg, r.lr_cfg, r.mesh_cfg, r.TOTAL_STEPS)
    engine.init_random(seed)
    engine.train_step(r.batch(seed), step)
"""

from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets.collator import fake_collator
from xtuner_tpu_torch.model.moe import MoEConfig
from xtuner_tpu_torch.module.attention import MHAConfig
from xtuner_tpu_torch.module.router import GreedyRouterConfig

SEQ = 65536
TOTAL_STEPS = 100
SWITCHES = {"XTUNER_ATTN_BWD": "two_pass", "XTUNER_FUSED_MLP": "1"}

model_cfg = MoEConfig(
    vocab_size=151936,
    num_hidden_layers=10,
    hidden_size=1024,
    intermediate_size=3072,
    moe_intermediate_size=128,
    n_routed_experts=64,
    num_experts_per_tok=4,
    tie_word_embeddings=True,
    rope_theta=1000000.0,
    balancing_loss_coef=0.001,
    router=GreedyRouterConfig(),
    attention=MHAConfig(num_attention_heads=16, num_key_value_heads=8, head_dim=128,
                        qk_norm=True),
    lm_loss_cfg=CELossConfig(chunk_size=2048, mode="fused"),
)
mesh_cfg = MeshConfig(param_dtype="bfloat16", remat_policy="save_out_lse")
optim_cfg = AdamWConfig(lr=1e-5)
lr_cfg = LRConfig(warmup_steps=2)


def batch(seed: int = 0) -> dict:
    """One row of SEQ random tokens (one document), shaped (1, 1, L) as
    `_run_shape` reshapes it."""
    flat = fake_collator(1, SEQ, model_cfg.vocab_size, seed=seed)
    return {k: v.reshape(1, 1, SEQ) for k, v in flat.items()}
