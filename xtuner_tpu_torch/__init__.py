"""PyTorch + CUDA port of `xtuner_tpu` for NVIDIA Hopper (H100).

Each module sits at the same relative path as its JAX counterpart in
`xtuner_tpu/` and names that file in its docstring. The JAX package stays the
reference: the port takes the same numpy inputs and must return the same
values within the tolerance its test states.

The port imports `torch` and never `jax`, and nothing from `xtuner_tpu`.
Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
under `csrc/`, built with `nvcc` on first use (`ops/cuda_lib.py`); beside
each kernel sits its plain PyTorch version, which a wrapper runs only for
tensors on the CPU.

Ported so far: the paged serving path for dense MHA models
(`model/paged_generate.py::PagedGenerator`, with chunked prefill, the
prefix cache and the per-request sampling surface) and its front end (the
serve, chat and convert CLIs in `train/cli/`, the RolloutWorker's HTTP
surface in `rl/worker.py` over `model/async_engine.py`, HF safetensors
load and export in `checkpoint/hf.py`); the MoE SFT train step
(`engine/train_engine.py::TrainEngine` on `model/moe.py::MoE`) and the SFT
entry point (`train/cli/sft.py`, `train/trainer.py::Trainer`), in bf16
and in tile-wise fp8 (`ops/float8.py`); GLM-5.2's DSA sparse attention
(`module/dsa.py`) in `model/dense.py::Dense`, its dense head layers
trained through `recipes/sft_glm52_dsa_head.py`; bench.py's longctx row
(`recipes/bench_longctx_64k.py`) under remat "save_out_lse" with JAX's
two-pass dk/dv and fused expert-MLP switches; DeepSeek-V3's MLA
(`module/mla.py`); the aux-free (noaux) router with its post-step bias
update and multi-token prediction (`module/mtp.py`), with MHA, MLA or DSA
in the MoE layers (`recipes/sft_glm45_air_head.py`,
`recipes/sft_moe_heavy_mtp.py`); the Qwen3.5 hybrid's serving path
(`model/hybrid.py`, GatedDeltaNet in `module/gated_deltanet.py` and
`ops/gated_deltanet.py`, gated attention, the hybrid paged engine) and its
training path (`model/hybrid.py`'s `forward` and `loss` with interleaved
MRoPE, the Gated DeltaNet backward by autograd and #2-#4 at head dim 256;
`recipes/sft_qwen35_35b_a3b_period.py`); Qwen3-VL's training path
(`model/qwen3_vl.py`: the ViT with #1-#4 non-causal at head dim 64, the
deepstack mergers, `inputs_embeds` and deepstack injection in the text
model; the data plane in `datasets/qwen_vl.py`; Qwen3-VL-4B whole through
`recipes/sft_qwen3_vl_4b.py`, Qwen3-VL-8B's tower of heads of 72 with #1-#4
non-causal at (72, 72), Qwen3-VL-8B whole in the alignment stage through
`recipes/sft_qwen3_vl_8b_align.py`); InternVL (BASELINE config 3: the ViT
and projector in `model/vision.py`, the compose model in
`model/compose.py`, the tile data plane in `datasets/vlm.py`, remat
"save_attn"; `recipes/sft_internvl_8b_vlm.py`); GRPO RL (`rl/`, the `rl` CLI, the dense
`model/generate.py::generate` as the rollout, `per_token_logprobs`;
Qwen3-4B whole through `recipes/rl_qwen3_4b_grpo.py`, rollout-routing
replay through `recipes/rl_qwen3_moe_head_r3.py`). Every
TPU kernel of the JAX package has its Hopper kernel. What is not ported raises
`NotImplementedError` naming its ROADMAP.md item.
"""


def not_ported(feature: str, item: str):
    """The error every unported option raises: names the ROADMAP.md item."""
    return NotImplementedError(
        f"{feature} is not ported to xtuner_tpu_torch yet "
        f"(ROADMAP.md, item [{item}])")
