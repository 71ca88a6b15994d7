#!/usr/bin/env python3
"""Drive the PyTorch port's serving path (Qwen3-8B at 12 of its 36 layers,
through the serve CLI from an HF export and through `PagedGenerator`, and
gpt-oss-20b and Qwen3.5-35B-A3B whole),
its MoE SFT train step, its SFT entry point (in bf16, in tile-wise fp8 and
with both kernel switches), bench.py's longctx_64k row, GLM-5.2's DSA head,
DeepSeek-V3's MLA head, GLM-4.5-Air's noaux-routed MoE head, moe_heavy
with MTP, gpt-oss-20b's two-layer head in training (with rollout-routing
replay), Qwen3.5-35B-A3B's first period in training, Qwen3-VL-4B whole
in training, InternVL-8B (BASELINE config 3, its language model cut in
depth) through the sft CLI from its own export and Qwen3-VL-8B whole in
the alignment stage, Qwen3-4B at 12 of 36 layers in GRPO through the rl CLI (with R3 on
Qwen3-30B-A3B's head), Qwen2.5-0.5B LoRA SFT (BASELINE config 1) and its
merged export, a Qwen2.5-0.5B reward model, and Qwen3-8B at 12 of 36 layers under QLoRA
(DPO, ORPO, SFT through the sft CLI, the merged export through the convert
CLI, served), once on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--breakdown]

Phases, each printed on its own line; any failure raises and the script
exits non-zero with no result line:

1. environment: torch / CUDA / triton / nvcc versions, the card, its power
   limit;
2. kernel build (nvcc, one process per source in xtuner_tpu_torch/csrc/,
   all started together), with ptxas's registers, spills and injected
   wgmma waits of each wgmma kernel's instantiations (the block-sparse
   ones' with their shared memory);
3. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes its path gives it and at odd shapes, with times, the
   least time the card could take (`least_ms`) and the time of the one
   PyTorch call that computes the same function, where there is one; each
   flash forward row also prints TFLOP/s, its share of the bound, SDPA's
   time, and the k tiles the kernel walked (and walked unmasked) against
   `fwd_tile_plan`; each grouped GEMM row prints its share of the bound and
   what its CTAs walked against `grouped_plan_counts` (a mismatch fails),
   and the odd shapes add NaN rows past the last group and an expert that
   ends mid-chunk before one with rows 1e3 times larger; the paged decode
   (#5) at the serving shape and at a rollout (32 slots of 4096 cached
   tokens) prints its split count and the wrapper's ms beside the bytes
   bound, and holds two launches to the same bits;
3s. serve_cli: Qwen3-8B at full width and 12 of its 36 layers (`with_depth`;
   random bf16 weights from the seed) exported
   by `save_hf_checkpoint` (GiB, seconds), loaded back by
   `load_hf_checkpoint` into the card (every leaf bit-equal), then served
   through the serve CLI's own code (`build_worker(build_parser().
   parse_args(...))`, defaults: chunked prefill 2048, the prefix cache, 16
   slots) on a free local port. Client threads send 4 short and 4 long
   completions (the long ones share a 2048-token prefix), a chat, a
   stream and a request with a penalty, min_tokens, a stop id and
   top_logprobs, then the long ones again (prefix hits) and one solo long
   prompt; per wave the wall, each request's latency and the engines'
   prefill / chunk / decode calls and seconds; time to first token,
   decode and prefill tokens/s as the client sees them; `/metrics`'s
   chunked prefills and prefix-cached tokens (> 0), the launches of #1
   and #5 (> 0), a long and a short answer's logprobs against a
   teacher-forced forward, each hit's first-token top-5 logprobs against
   its miss's, beside the same reading on 3 more prompts and on gathers
   planted wrong (`serve_cli_hit_floor`: these must fail the check); then
   the literal `python -m xtuner_tpu_torch.train.cli.serve --model <dir>
   --port <p>` answers one request. #1 at a whole 2048-token chunk and #5
   at wave 1's decode are then held to their plain versions (kernel rows
   `serve_cli`). First among the serving phases: its decode loop is
   host-bound;
3a. gpt_oss_kernels: the kernels of gpt-oss-20b's serving path against
   their plain versions at its shapes: #1 at (D, Dv) = (64, 64), B1 L8192
   Hq64/8 on five documents, with the window of 128 and in full (the sinks
   folded in once; the walked k tiles against `fwd_tile_plan` with the
   window; SDPA with the window as a dense mask; the bound on the
   in-window pairs); #5 at D 64 with the window and the sinks at the
   serving shape and a rollout (32 slots of 4096); #6 (nn) at E32 H2880
   F2880 on a decode step's 16 routed rows and a 1000-token prefill's 4000;
3b. serve_gpt_oss: `PagedGenerator.generate` on gpt-oss-20b at full size
   (20.9 B params, 24 layers, bf16, random weights from the seed) with
   `record_routing=True`: 6 requests on 4 slots (prompts up to 1000
   tokens, one GRPO pair), 32 new tokens each; prefill and decode tokens/s,
   ms a decode step, peak memory, the exact launches of #1, #5 and #6,
   `routed_experts`, a teacher-forced re-check of the logprobs beside the
   share of positions whose re-prefill routing equals the recorded one
   (by layer), and what the gate|up concatenation the engine avoids costs.
   These two run before serving: its profile windows slow every later host
   launch, and both decode loops are host-bound;
3c. serve_qwen35: `PagedGenerator.generate` on Qwen3.5-35B-A3B whole
   (34.66 B params, 40 layers: 10 periods of 3 GatedDeltaNet and 1 gated
   full attention, bf16, random weights from the seed, each expert stack's
   gate|up drawn as one buffer) with `record_routing=True`: 6 requests on
   4 slots, one GRPO pair, 32 new tokens each; init time and peak, prefill
   and decode tokens/s, ms a decode step, the serving peak, the exact
   launches of #1, #5 and #6, `routed_experts` (N, 40, 8), and the
   teacher-forced re-check (held where re-prefill routing agrees);
3d. qwen35_kernels: #1 at (256, 256), both variants, at the serving
   prefill and at B1 L8192 Hq16/2 on five documents (SDPA with a dense
   mask as the library time); #5 at D 256 at the serving shape and a
   rollout (32 slots of 4096); #6 (nn) at E256 H2048 F512 on a decode
   step's 32 rows and a 1000-token prefill's 8000;
3e. rl_grpo: `python -m xtuner_tpu_torch.train.cli.rl` (in-process,
   `rl.main`) on `recipes/rl_qwen3_4b_grpo.py`: Qwen3-4B at 12 of its 36
   layers (`with_depth`; whole: 4.02 B
   params), 2 steps of 4 prompts x 8 rollouts of 384 tokens with the
   rollout captured; per step the rollout's, the teacher-forced logprobs'
   and the train step's seconds, rollout tokens/s, pg_loss, ratio_mean,
   clip_frac, kl, grad_norm and the peaks of the rollout and of the rest
   of the step; step 1's ratio_mean within RL_RATIO_TOL of 1 (the bf16
   decode against the training forward); #1 once a layer in each
   rollout's prefill, the backward kernel once a layer in each step;
3f. rl_replay: the capture's advantages rewritten to seeded, zero-mean
   +-1 per group (random weights score every rollout 0) and replayed
   through the CLI: a nonzero gradient and pg_loss, parameters moved;
3g. rl_moe_r3: the CLI on `recipes/rl_qwen3_moe_head_r3.py`
   (Qwen3-30B-A3B's first 4 layers, R3): the training forward's router
   uses the recorded ids wherever they are recorded; the share of
   response tokens whose fresh routing differs; #6 in the rollout, #6/#7
   in the step;
3h. rl_kernels: #1 at the rollout prefill and the packed step, #2-#4 at
   the packed step, `per_token_logprobs(mode="fused")` (#8-#10) against
   the chunk mode at N16384 H2560 V151936 (values, both gradients) and
   each CE kernel against its plain version there, #6/#7 at the R3
   recipe's decode, prefill and step shapes;
4. serving: `PagedGenerator.generate` on Qwen3-8B at full width, 12 of its
   36 layers (`with_depth`),
   with random bf16 weights from the seed; 6 requests on 4 slots (one GRPO
   group of two); launch counters of its kernels; a teacher-forced re-check
   of the decoded logprobs; one sampled run; prefill and decode tokens/s;
   then the paged decode's own device time (torch.profiler) at the shapes
   of 3, beside the bytes bound: only after the serving loop's timings,
   since a profiler window slows the host's later launches;
5. training: `TrainEngine.train_step` on Qwen3-30B-A3B at full width, depth
   cut to 4 layers, random f32 masters from the seed, 4 steps on one packed
   8192-token row of 5 documents; loss, grad norm, lr, step time, tokens/s
   and peak memory per step; launch counters of its kernels against the
   counts the step implies; one profiled step;
6. the fused CE kernels (#8, the statistics sweep and its fold; #9/#10 as
   one backward: a coefficient sweep per row chunk, then the dh and dW
   products) at N = 2 x 8192 and N = 65536, H = 1024, V = 151936, at a
   ragged last row chunk and at odd shapes, with times, #8's parent's time
   (PERF.md), its bound and `torch.mm` over the same product, each
   backward pass's time beside `torch.mm`, two forward launches held to
   the same bits, and peak memory; then flash at B2 with
   16/8 heads and the grouped GEMMs at 16 experts (moe_heavy's shapes);
   then the fp8 kernels (#11-#13) at every moe_heavy fp8 shape and odd ones
   (every expert start offset inside a 128-row tile, 128 aligned rows, M
   below a tile), in both operand-type variants; #11-#13 also print
   the launch alone on operands already in their layout, TFLOP/s, the
   share of the bound and their parent's time, and hold two launches to
   the same bits (#12 and #13 also their walks to `fp8_plan_counts`);
7. sft: the `sft` CLI's `main(["--config", recipes/sft_moe_heavy.py])` in a
   temporary directory: bench.py's moe_heavy config at full width and depth
   (fused CE, remat "save_attn_residuals"), 6 steps through `Trainer.fit`;
   its tracker (6 finite steps, a falling loss, none skipped), its final
   checkpoint (size, save seconds), steady step ms, tokens/s and peak
   memory; the exact launch count of every kernel over the run; one
   profiled step. With `--breakdown`, also where one step's memory and
   time go under the recipe, under remat "full", and with the chunked CE
   in place of the fused one (a diagnostic: off by default);
8. sft_fp8: the same with `recipes/sft_moe_heavy_fp8.py` (bench.py's fp8
   row): step-1 loss within 2% of the bf16 run's, the exact launches of
   the fp8 kernels and none of the bf16 grouped GEMMs, and one profiled
   step with the device time of the quantise passes, the layout copies,
   #11, #12 and #13 apart;
9. longctx_kernels: the one-pass flash backward's two-pass
   instantiation (#2 + #4) against its plain version at moe_heavy's flash
   shapes, and the forward (#1) and both backward instantiations against
   the plain versions in 1024-row chunks at B1 L65536 Hq16/8 (SDPA's
   causal forward and backward as the library times); the fused MoE MLP
   the grouped GEMMs #16's backward runs (#6 nt, #7) at the longctx row's
   M262144 E64 (gate|up K1024 N256, down K128 N1024) against their plain
   versions and `torch._grouped_mm`; #16, forward and backward, against
   its plain version at the longctx row's M262144 E64 F128, moe_heavy's
   M131072 E16 F768, an odd M and F1536, two launches held to the same
   bits and the tiles and chunks its CTAs walked to `fused_mlp_plan_counts`,
   beside its parent's time (PERF.md), the port's decomposed path and
   `torch._grouped_mm` twice;
10. longctx: `recipes/bench_longctx_64k.py` (bench.py's longctx_64k row,
   470.8 M params, nothing cut) through `TrainEngine.train_step`, 3 steps
   on one 65536-token row, remat "save_out_lse", under
   `XTUNER_ATTN_BWD=two_pass` and `XTUNER_FUSED_MLP=1`: CE, grad norm,
   step ms, tokens/s, peak memory, the exact launches (the flash forward
   once per layer: never re-run), the bytes held for the backward beside
   JAX's formula, one profiled step;
11. sft_switched: the sft phase's recipe, seed and data under both
   switches: every step's loss within 2e-2 of the sft run's, the exact
   launches of the two-pass backward and #16, and none of the grouped
   backward or the "nn" grouped GEMM;
12. dsa_kernels: the block-sparse kernels #14 and #15 against their plain
   versions at GLM-5.2's shapes (B1 L16384, 64 heads, D = Dv = 256, blocks
   of 256, 8 slots; five documents and a padded tail; the selection from
   random block maxima through `select_from_blockmax`), two launches of
   each held to the same bits, with times, the bound on the visible pairs,
   and SDPA with the selection as a dense mask;
13. glm52_dsa: `recipes/sft_glm52_dsa_head.py` (GLM-5.2's three dense head
   layers at full width, 3.156 B params, block-granular DSA): its
   `TrainEngine`, built by `Trainer` from the recipe, takes 4
   `train_step`s on the recipe's own 16384-token rows (not `fit`, whose
   final save would write ~38 GB); CE, indexer loss, step ms, tokens/s,
   peak memory, the exact launches of #14 and #15, the indexer's own
   forward and backward ms, and one profiled step (#14's and #15's device
   time apart); the selection and segment ids of that step's first
   block-sparse call (layer 0's forward) then take #14 and #15 through
   the checks and times of 12 again, at the recipe's own selection;
14. deepseek_mla: `recipes/sft_deepseek_v3_mla_head.py` (DeepSeek-V3's
   three dense head layers at full width, 3.604 B params, MLA with q/k dim
   192 and v dim 128, yarn rope) through the `sft` CLI's `main` in a
   temporary directory: 4 steps on the recipe's own 16384-token rows and
   the final checkpoint; CE, step ms, supervised tokens/s, peak memory,
   the exact launches of #1 and the grouped backward (#2 + #3) at 192/128;
   then the recipe at 1 layer under remat "save_out_lse" and
   `XTUNER_ATTN_BWD=two_pass`: the flash forward once per layer and step,
   the two-pass backward (#2 + #4) once; one profiled step of the recipe
   with the flash kernels and AdamW apart;
15. mla_kernels: #1-#4 at 192/128 against their plain versions (in
   1024-row chunks) at B1 L16384 with 128 heads, on five documents and on
   the recipe's own row: errors, two backward launches the same bits, the
   forward's walk against its plan, times, bounds, and SDPA with the
   documents' mask under the backend that takes v's head dim (or with v
   zero-padded).
16. glm45_air_head: `recipes/sft_glm45_air_head.py` (GLM-4.5-Air's dense
   layer and first MoE layer at full width, 3.827 B params: 96/8 heads with
   qkv bias, 128 experts top-8 of width 1408 behind the noaux router, a
   shared expert) through `Trainer.fit` in a temporary directory, 4 steps
   on the recipe's own 8192-token rows, no final save: per step step ms,
   supervised tokens/s, maxvio, the trunk's correction-bias range and peak
   memory; after step 1 each bias entry moved by exactly the update speed
   against its expert's load; a falling CE; the exact launches; one
   profiled step (the flash kernels and AdamW apart); then one step
   under `XTUNER_FUSED_MLP=1`, its step-1 losses within 2e-2 of the first
   run's;
17. glm45_kernels: #1 and the grouped backward (#2 + #3) at B1 L8192 with
   96 q heads over 8 kv heads (a group of 12), on five documents and on
   the recipe's row, against the plain versions in 1024-row chunks; the
   bf16 grouped GEMMs (#6, #7) and #16 at E128 H4096 F1408 with the group
   sizes of the noaux router's own top-8 route, against their plain
   versions, `torch._grouped_mm` and (for #16) the decomposed path;
18. moe_heavy_mtp: `recipes/sft_moe_heavy_mtp.py` (the sft recipe with one
   MTP layer) through `Trainer.fit`, 6 steps, no final save: CE,
   `mtp_loss` and step ms per step; the trunk's step-1 CE equal to the sft
   phase's; the exact launches (the MTP layer's kernels and a second fused
   CE per step);
19. gpt_oss_train: `recipes/sft_gpt_oss_20b_head.py` (gpt-oss-20b's first
   two layers at full width, 2.804 B params: layer 0 a window of 128,
   layer 1 full attention, sinks, q/k/v/o biases, 32 experts top-4 with
   clipped swiglu) through `Trainer.fit`, 4 steps on the recipe's own
   8192-token rows, no final save: CE, grad norm, step ms, supervised
   tokens/s, maxvio, peak memory; a falling CE; the exact launches (#1 at
   64/64 twice a layer and step, the split backward #2 + #3 once, nn 4,
   nt 2, dw 2); then replay on the engine's params: a no-grad forward
   records each layer's top-k ids, one step replays them at the second
   half of each document (its CE within OSS_REPLAY_ATOL of the
   unreplayed forward's; the ids used equal the forced ones), one step
   forces every real position to those ids plus one (used as forced); one
   profiled step (flash and AdamW apart); then 1 step under
   `XTUNER_ATTN_BWD=two_pass` (#2 + #4), its CE within 2e-2 of the
   first run's;
20. gpt_oss_train_kernels: at the recipe's row, B1 L8192 Hq64/8: #1 and
   both backward instantiations at (64, 64) with the window of 128 and in
   full, the lse with random sinks folded in, against the plain versions
   one q-head group at a time (two backward launches the same bits, the
   forward's walk against `fwd_tile_plan`, dsinks against the formula in
   f64), beside SDPA (the window as a dense mask, no sinks) and the bound
   on the in-window pairs; the grouped GEMMs (#6 nn and nt, #7) at E32
   H2880 F2880 on M = 8192 x top-4 rows from the softmax router's own
   route, beside `torch._grouped_mm`;
21. qwen35_train: `recipes/sft_qwen35_35b_a3b_period.py` (Qwen3.5-35B-A3B's
   first period at full width, 4.381 B params: 3 Gated DeltaNet and 1
   gated full attention sub-layer of 16/2 heads of 256 under interleaved
   MRoPE, each with 256 experts top-8 and a gated shared expert) through
   `Trainer.fit`, 4 steps on the recipe's own 8192-token rows, no final
   save: CE, grad norm, step ms, supervised tokens/s, maxvio, peak memory
   beside the card's name and power limit; a falling CE; the exact
   launches (#1 at 256/256 twice a step, #2 + #3 once, per MoE sub-layer
   nn 4, nt 2, dw 2); one Gated DeltaNet sub-layer's forward and backward
   alone (ms, launches, busy share); replay in HF layer order as in 19; one
   profiled step (flash, the Gated DeltaNet forwards and AdamW apart); 1
   step under `XTUNER_ATTN_BWD=two_pass` (#2 + #4), its CE within 2e-2 of
   the first run's;
22. qwen35_train_kernels: B1 L8192 Hq16/2 at (256, 256), on five documents
   and on the recipe's row: #1 and both backward instantiations against
   the plain versions one q-head group at a time (two backward launches
   the same bits), beside SDPA with the documents as a dense mask and the
   bound on the visible pairs; the grouped GEMMs (#6 nn and nt, #7) at
   E256 H2048 F512 on M = 8192 x top-8 rows from the softmax router's own
   route, beside `torch._grouped_mm`;
23. vlm_train: `recipes/sft_qwen3_vl_4b.py` (Qwen3-VL-4B whole, 4.438 B
   params: a 24-block tower of 16 heads of 64 with deepstack, the merger
   and 3 deepstack mergers, 36 text layers under interleaved MRoPE, a tied
   vocab) through `Trainer.fit`, 4 steps on the recipe's own rows (8192
   tokens, 32,768 patch rows: ~8 images of 512 x 512 to 1024 x 1024), no
   final save: CE, grad norm, step ms, supervised tokens/s, each step's
   peak memory and its row's documents, images, patches and image tokens,
   beside the card's name and power limit; a falling CE; the exact
   launches (per step #1 causal at 128/128 72, non-causal at 64/64 48;
   #2 + #3 causal 36, non-causal 24); the tower's forward and backward
   alone (ms, launches, busy share); one profiled step (the vision blocks,
   the text layers' pieces, the flash kernels and AdamW apart); 1 step
   under `XTUNER_ATTN_BWD=two_pass` (#2 + #4 in both), its CE within 2e-2
   of the first run's;
24. vlm_kernels: #1-#4 non-causal at (64, 64), 16 q over 16 kv heads, on
   the recipe's vision row (P32768, the plain versions in 1024-row chunks)
   and on segments of 1, 100 and 4097 patches (P4198): errors, two
   backward launches the same bits, padding rows zero, the forward's walk
   against `fwd_tile_plan(causal=False)`, times, the bound on the visible
   pairs, and SDPA with the block-diagonal mask as a dense mask;
24f. internvl_sft (after 24): BASELINE config 3,
   `recipes/sft_internvl_8b_vlm.py` (InternViT-300M frozen, the
   projector, Qwen3-8B's language model at full width cut to 6 of its 36
   layers: 8 layers do not fit one micro-batch of 8 x 16384), in a
   temporary directory: the recipe's seeded random weights exported by
   `save_hf_checkpoint` (GiB, s), then the literal `python -m
   xtuner_tpu_torch.train.cli.sft --config ...` in-process from that
   export, 4 steps, the final save skipped: CE, grad norm, step ms, tgs,
   pack positions/s, peak; per micro-batch its tokens, real and padded
   tiles and context tokens (the recipe's `MICRO_BATCHES`); every tower
   leaf bit-equal to the export, the projector and text leaves moved; the
   exact launches (per step the tower's #1 non-causal at 64/64 24, no
   backward; the text layers' #1 twice a layer under "save_attn" and #2 +
   #3 once); CE with the tower's tokens against them zeroed and against a
   planted scatter shifted by one tile, each gap over VISION_CE_FLOOR;
   the tower's forward alone; a profiled step; a two-pass step; the
   export deleted;
24g. internvl_kernels: #1 non-causal at 64/64 on the 48 tiles of 1025 as
   segments of one row; #1-#4 at 128/128 (32 / 8 heads) on the first
   micro-batch's 8 rows of 16384 (the plain versions a row and a group at
   a time), beside SDPA and the bound;
24h. vlm8b_align: `recipes/sft_qwen3_vl_8b_align.py` (Qwen3-VL-8B whole,
   8.77 B params, the language model frozen) through `Trainer.fit`, 4
   steps, no final save: per step CE, step ms, tgs, peak, the row's
   images, patches and tokens; every language leaf bit-equal to its init,
   every tower and merger leaf moved, step 1's row's CE lower after
   training; the exact launches (#1 non-causal at 72/72 twice a block and
   #2 + #3 once; the frozen text layers' #1 twice and #2 + #3 once); the
   tower's forward and backward alone; a two-pass step;
24i. vlm8b_kernels: #1-#4 non-causal at 72/72 (16 heads) on the recipe's
   vision row and on segments of 1, 100 and 4097 (P4198), as 24 does at
   64/64;
24a. lora_sft: the sft CLI on `recipes/sft_qwen25_05b_lora.py`
   (`phase_lora_sft`): steps, CE, step time, peak, frozen leaves
   bit-unchanged, `lora_b` moved, then redrawn at a real size, the convert
   CLI's merged export held to the unmerged model's teacher-forced
   log-probs, and a merge without adapters or at scale 1 shown to fail;
24b. reward: `recipes/reward_qwen25_05b.py` (`phase_reward`): loss,
   reward_acc, step time and peak per step;
24c. dpo, orpo, qlora_sft, qlora_serve: Qwen3-8B (12 of its 36 layers,
   `with_depth`) under QLoRA from
   its own HF export (`phase_qlora`): DPO (step 1 at ln 2, margin 0; step
   2 moved) and ORPO, 2 steps each; 4 SFT steps through the sft CLI, the
   codes on the card bit-equal to the host quantizer's, the adapter GEMMs
   timed alone; `lora_b` redrawn at a real size, the merged export through
   the convert CLI, its log-probs against the unmerged model's (a merge
   without adapters or at scale 1 shown to fail), served by
   `PagedGenerator`;
24d. lora_kernels: #1-#4 at (64, 64) with a group of 7 on the LoRA
   recipe's row, #1-#3 at 128/128 on the QLoRA recipe's row and on DPO's
   rows, #8 and #9 at N8192 H4096 V151936 (untied), #5 at the merged
   export's serving shape, each against its plain version;
24e. lora_profile: the LoRA recipe's step with its 8 rows as 8
   micro-batches and as one; one profiled step of the QLoRA recipe (random codes) with the NF4
   dequantize's device time apart;
25. gpt_oss_profile: gpt-oss-20b's engine made again, then torch.profiler
   windows of 4 prefills of 1000 tokens and of 16 decode steps (device
   time by kind: #5, the port's other kernels, cuBLAS, the rest);
26. rl_profile: Qwen3-4B (12 layers) in bf16 made again, then one torch.profiler
   window of the GRPO rollout's `generate` at the recipe's shape (32 rows,
   4 prompts of 128) for 1 + 16 tokens: wall, device-busy share, kernels.
   These two last, since a profiler window slows every later host launch.

Between phases it frees what the last one held and checks that nothing
large stays allocated, so each peak is the phase's own. Then a JSON line
of the kernels, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# kernel vs plain tolerances (see tests/test_torch_kernels.py for why)
FLASH_OUT_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-3
PAGED_ATOL = 2e-4
# teacher-forced re-check: decode (paged kernel, M=4 GEMMs) and a one-pass
# re-prefill (flash kernel, M~1k GEMMs) round activations to bf16 at
# different points (~2^-8 relative each) through 36 layers of random
# weights, so logprobs agree to bf16 accuracy, not bit for bit. The same
# drift shows between two prefills of one sequence at two paddings (the
# noise floor printed beside it).
TF_MAX_ATOL = 0.5
TF_MEAN_ATOL = 0.1
# flash backward and grouped GEMMs (see tests/test_torch_kernels.py): the
# kernels round p, ds and their outputs to bf16 where the plain versions
# keep f32, so the bound is relative to the largest entry of the result
FLASH_GRAD_RTOL = 2e-2
GG_RTOL = 1e-2
DW_RTOL = 1e-4
# train phase: step-1 CE of a random model is ln(V) + sigma^2 / 2 for
# logits of std sigma = 0.02 * sqrt(2048): 11.93 + 0.41 = 12.3
TRAIN_LOSS1 = (11.4, 13.4)
TRAIN_LAYERS = 4
TRAIN_STEPS = 4
SEQ = 8192
# fused CE (see tests/test_torch_kernels.py): lse and label_logit are f32
# sums of the same bf16 products in another order; dh and dw round the
# coefficient and the result to bf16 (GG_RTOL, relative to the largest entry)
CE_STAT_ATOL = 1e-3
# sft phase: the moe_heavy recipe, 2 rows of 8192 per step, 6 steps; the
# step-1 CE of a random model is ln(V) + sigma^2 / 2 for logits of std
# 0.02 * sqrt(1024): 11.93 + 0.20 = 12.1
SFT_RECIPE = "xtuner_tpu_torch/recipes/sft_moe_heavy.py"
SFT_ROWS = 2
SFT_STEPS = 6
SFT_LAYERS = 10
SFT_LOSS1 = (11.4, 13.0)
# sft_fp8 phase: the same run with tile-wise fp8; its step-1 loss within 2%
# of the bf16 run's from the same seed and data (the bound of JAX's
# test_moe_model_level_fp8_parity)
SFT_FP8_RECIPE = "xtuner_tpu_torch/recipes/sft_moe_heavy_fp8.py"
SFT_FP8_LOSS1_RTOL = 0.02
LONGCTX_SEQ = 65536
PLAIN_CHUNK = 1024  # q rows per chunk of the plain flash versions at LONGCTX_SEQ
# fp8 GEMMs vs their plain versions (see tests/test_torch_kernels.py): the
# same exact fp8 products, bf16 outputs rounded once (relative to the
# largest entry), f32 outputs (the wgrad) only in another order; and the
# mean relative error of the fp8 product against the unquantised bf16 one,
# the bound of JAX's fp8 tests
FP8_RTOL = 1e-2
FP8_DW_RTOL = 2e-3
FP8_VS_BF16_MEAN = 0.06
# block-sparse (#14, #15, see tests/test_torch_kernels.py): out, lse and
# the gradients take flash's bounds; the per-slot mass is a ratio of f32
# sums of unrounded p
BS_MASS_ATOL = 1e-3
# dsa_kernels phase: GLM-5.2's attention shapes
DSA_SEQ, DSA_HEADS, DSA_DIM, DSA_BLOCK, DSA_SLOTS = 16384, 64, 256, 256, 8
# glm52_dsa phase: step-1 CE of a random model is ln(V) + sigma^2 / 2 for
# logits of std 0.02 * sqrt(6144): 11.95 + 1.23 = 13.2. The indexer loss
# must be finite and positive; it is not near 3 ln 8: at init the
# indexer's scores are far from uniform (q_idx and k_idx entries of std
# 0.02 * sqrt(6144) = 1.57, so q.k over 128 dims has std ~28 and the
# 32-head weighted sum of its relu std ~100), and the softmax over the
# selected slots is nearly one-hot
GLM_RECIPE = "xtuner_tpu_torch/recipes/sft_glm52_dsa_head.py"
GLM_STEPS = 4
GLM_LOSS1 = (12.4, 14.0)
GLM_PEAK_GIB = 78.0
# deepseek_mla phase (recipes/sft_deepseek_v3_mla_head.py through the sft
# CLI): step-1 CE of a random model is ln(V) + sigma^2 / 2 for logits of
# std 0.02 * sqrt(7168): 11.77 + 1.43 = 13.2; 4 steps of one 16384-token
# row; the final checkpoint (f32 params and Adam state, ~43 GB) is written
# to a temporary directory. The remat "save_out_lse" run: the recipe at 1
# layer, DEEPSEEK_SOL_STEPS train steps under XTUNER_ATTN_BWD=two_pass
DEEPSEEK_RECIPE = "xtuner_tpu_torch/recipes/sft_deepseek_v3_mla_head.py"
DEEPSEEK_STEPS = 4
DEEPSEEK_LOSS1 = (12.4, 14.0)
DEEPSEEK_PEAK_GIB = 78.0
DEEPSEEK_PARAMS = 3_603_815_424
DEEPSEEK_SOL_STEPS = 2
# mla_kernels phase: #1-#4 at MLA's q/k dim 192 and v dim 128, B1 L16384,
# 128 q and kv heads (DeepSeek-V3's), documents of MLA_DOCS tokens, and the
# recipe's own packed row
MLA_SEQ, MLA_HEADS, MLA_D, MLA_DV = 16384, 128, 192, 128
MLA_DOCS = [8192, 4096, 2048, 1024, 1024]
# glm45_air_head phase (recipes/sft_glm45_air_head.py through Trainer.fit):
# step-1 CE of a random model is ln(V) + sigma^2 / 2 for logits of std
# 0.02 * sqrt(4096): 11.93 + 0.82 = 12.75; 4 steps of one 8192-token row
GLM45_RECIPE = "xtuner_tpu_torch/recipes/sft_glm45_air_head.py"
GLM45_STEPS = 4
GLM45_LOSS1 = (12.0, 13.8)
GLM45_PARAMS = 3_826_565_248
# moe_heavy_mtp phase: recipes/sft_moe_heavy_mtp.py; the trunk's step-1 CE
# is the sft phase's (the same trunk weights, seed and data) up to the
# order of an f32 sum
MTP_RECIPE = "xtuner_tpu_torch/recipes/sft_moe_heavy_mtp.py"
MTP_CE1_RTOL = 1e-6
# the longctx row (recipes/bench_longctx_64k.py): step-1 CE of a random
# model is ln(V) + sigma^2 / 2 for logits of std 0.02 * sqrt(1024):
# 11.93 + 0.20 = 12.13; lr is 1e-5 on random labels, so the loss is not
# held to fall. 3 steps of one 65536-token row
LONGCTX_RECIPE = "xtuner_tpu_torch/recipes/bench_longctx_64k.py"
LONGCTX_STEPS = 3
LONGCTX_LOSS1 = (11.6, 12.6)
LONGCTX_PEAK_GIB = 78.0
# sft_switched (the longctx recipe's two switches on the sft recipe) holds
# every step's loss within SWITCHED_LOSS_ATOL of the sft phase's (the same
# recipe, seed and data: the fused MLP rounds where the decomposed path
# does, the two-pass backward sums dk/dv in another order)
SWITCHED_LOSS_ATOL = 2e-2
# serve_cli phase: Qwen3-8B whole, exported in HF safetensors layout and
# served through the serve CLI with its defaults (chunked prefill 2048, the
# prefix cache, 16 slots). Prompts are seeded token ids: short ones of
# SERVE_SHORT tokens, long ones of SERVE_LONG (more than one chunk) that
# share their first SERVE_PREFIX; SERVE_NEW new tokens each, greedy
SERVE_MODEL = "qwen3-8b"
# Depth cuts of earlier paths, made when the InternVL and Qwen3-VL-8B phases
# (~190 s) took the whole script past its 1200 s limit (1,286 s in a run):
# these presets run at full width and at 12 of their 36 layers while their
# phases run (`with_depth`): Qwen3-8B in serve_cli and serve, Qwen3-4B in
# rl_grpo, rl_replay and rl_profile, Qwen3-8B under QLoRA in qlora and
# lora_profile. Their decode loops are host-bound per layer, and their
# exports, loads and seeded inits scale with depth
SERVE_LAYERS = QLORA_LAYERS = RL_LAYERS = 12
SERVE_SHORT, SERVE_LONG, SERVE_PREFIX, SERVE_NEW = 200, 3000, 2048, 32
# a prefix hit's first-token top-5 logprobs against the miss's: the hit
# reads the miss's own bf16 KV for 23 of the prompt's 24 blocks and
# recomputes only the rest, in a 64-row chunk where the miss ran 2048 rows:
# only GEMM shapes differ. The random model's top 5 are near ties (all
# ~-11.9), so the two sets need not be the same: they must share
# SERVE_HIT_SHARED ids, and differ on those by at most SERVE_HIT_ATOL. Over
# 11 prompts (`serve_cli_hit_floor`, 10 seeds, twice) the hit shared 3-5
# ids and differed by up to 0.1027; every gather planted wrong in content
# (zeroed, another prompt's blocks, one block of another prompt's) shared
# 0 ids. A gather rolled by one block is invisible by construction: the
# resumed positions attend the same set of key/value pairs
SERVE_HIT_ATOL = 0.2
SERVE_HIT_SHARED = 2
SERVE_HIT_SEEDS = 3  # prompts whose hit-vs-miss reading shows the floor
# the shapes serve_cli gives #1 and #5: a whole 2048-token chunk, and a
# decode step of wave 1 on the worker's one engine (16 slots, a 64-entry
# table: --max-length 8192): the 4 long prompts and 7 short ones halfway
# through their answers
SERVE_PREFILL_CHUNK = 2048
SERVE_PAGED_SHAPE = ([SERVE_LONG + SERVE_NEW // 2] * 4 + [SERVE_SHORT + SERVE_NEW // 2] * 7
                     + [0] * 5, 64)
SERVE_HEALTH_S = 600  # the CLI's process loads the export before /health
# what may stay allocated between phases (the kernels' small device buffers)
RELEASED_GIB = 1.0
# the least time the card could take (NVIDIA H100 SXM data sheet, dense):
# operations over the peak rate of their type, bytes (each input read once,
# each output written once) over the memory rate; the larger of the two
PEAK_BF16 = 989e12
PEAK_FP8 = 1979e12
HBM_BYTES_S = 3.35e12

MAX_NEW = 32
# gpt-oss-20b (`model/gpt_oss.py`): the serving phase's model and shapes.
# Its prefill attention is #1 at (64, 64) (64 q heads over 8 kv heads), a
# window of 128 on even layers and full attention on odd ones; its decode
# attention #5 at D 64 with the sinks; its expert GEMMs #6 (nn) at E32
# H2880 F2880 (gate|up K2880 N5760, down K2880 N2880)
OSS_MODEL = "gpt-oss-20b"
OSS_PARAMS = 20_908_120_896
OSS_SEQ, OSS_HQ, OSS_HKV, OSS_D, OSS_WINDOW = 8192, 64, 8, 64, 128
OSS_EXPERTS, OSS_TOPK, OSS_H, OSS_F = 32, 4, 2880, 2880
OSS_SLOTS = 4
# the teacher-forced re-check's fallback. A routing flip (a top-4 set that
# differs between decode and the re-prefill) moves every later layer's
# input, so on random weights the flips compound with depth: two prefills
# of one sequence at two paddings (the same kernels, only the GEMM shapes
# differ) route alike in all 24 layers at only ~35% of the generated
# positions, while layer 0 agrees at 99.5-100% (this phase's own figures
# on an NVIDIA H100 80GB HBM3 at 700 W, seed 0). So
# where flips break TF_MAX_ATOL / TF_MEAN_ATOL, the bound holds on the
# positions whose routing agrees in every layer, at least
# OSS_ALL_LAYERS_AGREE_MIN of the positions must be such, and layer 0 (whose
# router reads the decode and prefill attention outputs directly) must
# agree at OSS_ROUTING_AGREE_MIN of the positions
OSS_ROUTING_AGREE_MIN = 0.9
OSS_ALL_LAYERS_AGREE_MIN = 0.1
# gpt_oss_train phase (recipes/sft_gpt_oss_20b_head.py through Trainer.fit):
# step-1 CE of a random model is ln(V) + sigma^2 / 2 for logits of std
# 0.02 * sqrt(2880): 12.21 + 0.58 = 12.79; 4 steps of one 8192-token row.
# The replay step forces the ids a no-grad forward of the same params and
# batch picked, so its CE differs from that forward's only where the
# re-gathered weights round otherwise (bf16 noise)
OSS_RECIPE = "xtuner_tpu_torch/recipes/sft_gpt_oss_20b_head.py"
OSS_STEPS = 4
OSS_LOSS1 = (12.0, 13.6)
OSS_HEAD_PARAMS = 2_804_090_688
OSS_REPLAY_ATOL = 2e-2
# Qwen3.5-35B-A3B (`model/hybrid.py`): the hybrid serving phase's model and
# shapes. Its 10 full-attention layers prefill through #1 at (256, 256)
# (16 q heads over 2 kv heads, gated, causal) and decode through #5 at D
# 256; its 30 GatedDeltaNet layers carry a per-slot state; every layer's
# experts are #6 (nn) at E256 H2048 F512 (gate|up K2048 N1024, down K512
# N2048)
QWEN_MODEL = "qwen3.5-moe-35b-a3b"
QWEN_PARAMS = 34_660_610_688
QWEN_SEQ, QWEN_HQ, QWEN_HKV, QWEN_D = 8192, 16, 2, 256
QWEN_EXPERTS, QWEN_TOPK, QWEN_H, QWEN_F = 256, 8, 2048, 512
QWEN_FULL_LAYERS = 10
QWEN_SLOTS = 4
QWEN_DIMS = (QWEN_HQ, QWEN_HKV, QWEN_D, 128)
QWEN_PAGED_SHAPES = (("qwen35_serve", [1000, 0, 517, 1900], 16),
                     ("qwen35_rollout", [4096] * 32, 64))
# the teacher-forced re-check's fallback, as gpt-oss's (OSS_ROUTING_AGREE_MIN):
# where routing flips break the bound, it holds on the positions whose
# routing agrees in all 40 layers, which must be at least this share. With
# 256 experts, top-8, random bf16 weights route far more chaotically than
# gpt-oss's 32, top-4: two prefills of one sequence at two paddings agree
# in all 40 layers at 50% of the prompts' last positions, decode and a
# re-prefill at 1.6% of all positions and at none of the decode positions
# (by layer 1.00, 0.96, 0.87, 0.76, 0.63, 0.45, ..., 0.02; this phase's
# own figures on an NVIDIA H100 80GB HBM3 at 700 W, seed 0). So the decode
# path is also held layer by layer (`decode_vs_prefill_layers`): each
# sub-layer's output of one decode step against a prefill's at the same
# position, within QWEN_LAYER_RTOL (relative) through the first period (3
# GatedDeltaNet sub-layers and a full one: every kind of decode sub-layer)
# and before the first layer whose routing differs, which must not be
# layer 0. bf16 alone gives ~1e-2 a sub-layer, growing with depth (the
# flash prefill rounds P to bf16, the paged decode does not); a wrong
# state, gate or cache gives O(1)
QWEN_ALL_LAYERS_AGREE_MIN = 0.01
QWEN_LAYER_RTOL = 0.1
# qwen35_train phase (recipes/sft_qwen35_35b_a3b_period.py through
# Trainer.fit): one period (3 GatedDeltaNet and 1 gated full attention
# sub-layer, each with 256 experts top-8 and a gated shared expert). Step-1
# CE of a random model is ln(V) + sigma^2 / 2 for logits of std 2 x 0.02 x
# sqrt(2048) (the zero-centred final norm scales by 1 + 1 at init): 12.42 +
# 1.64 = 14.06. Per step the full sub-layer runs #1 twice (remat "full")
# and the backward once; each of the 4 MoE sub-layers #6 nn 4 times (gate|up
# and down, forward and recompute), nt twice and #7 twice. The replay steps
# as gpt-oss's (OSS_REPLAY_ATOL)
QWEN_TRAIN_RECIPE = "xtuner_tpu_torch/recipes/sft_qwen35_35b_a3b_period.py"
QWEN_TRAIN_STEPS = 4
QWEN_TRAIN_PARAMS = 4_381_469_760
QWEN_TRAIN_LOSS1 = (13.3, 14.8)
QWEN_REPLAY_ATOL = 2e-2
# vlm_train phase (recipes/sft_qwen3_vl_4b.py through Trainer.fit):
# Qwen3-VL-4B whole. Step-1 CE of a random model is ln(V) + sigma^2 / 2 for
# logits of std 0.02 x sqrt(2560) (the tied embedding against an rms-1
# final norm): 11.93 + 0.51 = 12.44. Per step the 36 text layers run #1
# (causal, 128/128, max-free under qk-norm) twice (remat "full") and the
# backward once; the 24 vision blocks #1 non-causal at 64/64 (the running
# max: no bound) twice and its backward once
VLM_RECIPE = "xtuner_tpu_torch/recipes/sft_qwen3_vl_4b.py"
VLM_STEPS = 4
VLM_PARAMS = 4_437_815_808
VLM_LOSS1 = (11.6, 13.4)
VLM_TEXT_LAYERS, VLM_BLOCKS = 36, 24
VLM_HQ, VLM_D = 16, 64  # the tower's heads (no GQA) and head dim
VLM_ODD = [1, 100, 4097]  # vlm_kernels' odd row: P = 4198, not a multiple of 128
# internvl_sft phase (recipes/sft_internvl_8b_vlm.py through the sft CLI):
# InternViT-300M frozen over Qwen3-8B's language model at full width, 6 of
# its 36 layers. Step-1 CE of a random untied head (std 0.02 against an
# rms-1 final norm): ln(V) + sigma^2 / 2, sigma = 0.02 sqrt(4096): 11.93 +
# 0.82 = 12.75. Per step the frozen tower runs #1 non-causal at 64/64 once
# a block and no backward; each text layer #1 twice under "save_attn" and
# #2 + #3 once. VISION_CE_FLOOR: the least |CE with the tower's tokens - CE
# with them zeroed or shifted by a tile| the check accepts as power, in
# nats (the mean CE over the documents that hold an image); two runs of
# the same micro-batch must agree within a tenth of it
INTERNVL_RECIPE = "xtuner_tpu_torch/recipes/sft_internvl_8b_vlm.py"
INTERNVL_STEPS = 4
INTERNVL_LOSS1 = (11.9, 13.6)
INTERNVL_VIT_BLOCKS = 24
INTERNVL_HQ, INTERNVL_D = 16, 64  # InternViT's heads
INTERNVL_LLM_DIMS = (32, 8, 128)  # Qwen3-8B's q heads, kv heads, head dim
VISION_CE_FLOOR = 1e-3
# vlm8b_align phase (recipes/sft_qwen3_vl_8b_align.py through Trainer.fit):
# Qwen3-VL-8B whole, the language model frozen; step-1 CE as above (untied,
# hidden 4096): 12.75. Per step the 27 tower blocks run #1 non-causal at
# 72/72 twice (remat "full") and #2 + #3 once; the 36 frozen text layers #1
# twice and #2 + #3 once
VLM8B_RECIPE = "xtuner_tpu_torch/recipes/sft_qwen3_vl_8b_align.py"
VLM8B_STEPS = 4
VLM8B_PARAMS = 8_767_123_696
VLM8B_LOSS1 = (11.9, 13.6)
VLM8B_TEXT_LAYERS, VLM8B_BLOCKS = 36, 27
VLM8B_HQ, VLM8B_D = 16, 72
# the times of the WMMA, mma.sync and CUDA-core kernels that #8's, #16's,
# #12's, #13's, #5's and #11's redesigns replaced, as PERF.md §6 records them
# (chip_smoke.py runs, NVIDIA H100 80GB HBM3, 700.00 W), printed beside the
# kernels that replaced them
PARENT_MS = {("ce_fwd", "sft"): "34.13-34.26", ("ce_fwd", "longctx"): "118.12-118.26",
             ("fused_moe_mlp", "longctx"): "1.946-2.026",
             ("fused_moe_mlp", "sft_switched"): "6.232-6.269",
             # the mma.sync kernels #12 and #13 replaced: a layer's 6 calls of
             # #12 and 3 of #13 at the sft_fp8 shapes
             ("fp8_grouped_gemm", "sft_fp8"): "7.11-7.43",
             ("fp8_grouped_dw", "sft_fp8"): "6.22",
             # the CUDA-core paged decode #5 replaced, and the mma.sync #11:
             # q + k + v + o at M16384
             ("paged_decode", "serve"): "0.0865-0.0883",
             ("fp8_gemm", "sft_fp8"): "1.16-1.19"}


@contextlib.contextmanager
def cut_depth(name: str, layers: int):
    """While on, the registry's preset `name` has `layers` layers, every
    width kept: a recipe or CLI of this process that resolves `name` builds
    the cut model (an HF export records the cut in its config.json)."""
    from unittest import mock

    from xtuner_tpu_torch.model import registry

    factory = registry.model_mapping[name]
    cut = lambda: dataclasses.replace(factory(), num_hidden_layers=layers)  # noqa: E731
    with mock.patch.dict(registry.model_mapping, {name: cut}):
        yield


def with_depth(name: str, layers: int):
    """A phase decorator: the phase runs inside `cut_depth(name, layers)`."""
    import functools

    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            with cut_depth(name, layers):
                return fn(*a, **kw)
        return run
    return wrap


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_env(torch) -> str:
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    from xtuner_tpu_torch.ops.cuda_lib import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    smi = smi_line()
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, triton=triton_v, nvcc=repr(nvcc),
        device=repr(torch.cuda.get_device_name(0)),
        capability=torch.cuda.get_device_capability(0),
        count=torch.cuda.device_count(), smi=repr(smi))
    return smi


def phase_build() -> None:
    from xtuner_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    so, nvcc_s = cuda_lib.build()
    cuda_lib.load()
    log = so.with_suffix(".log")
    ptxas = []
    for ln in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function" in ln:  # the mangled name, cut to what tells kernels apart
            ptxas.append("kernel " + ln.split("'")[1].split("_cu_")[-1][:100])
        elif "registers" in ln or "spill" in ln or "C75" in ln:
            ptxas.append(ln.strip())
    say("build", library=so.name, nvcc_s=f"{nvcc_s:.3f}",
        total_s=f"{time.perf_counter() - t0:.3f}")
    for ln in ptxas:
        print(f"[build] ptxas {ln}", flush=True)
    # the wgmma flash kernels: registers and spills (ptxas) and the dynamic
    # shared memory of one CTA of each instantiation: the forward <D, Dv>
    # (one kernel, both variants), the one-pass backward <two_pass> at
    # 128/128, and the split dq <D, Dv, window> and dk/dv <D, Dv, two_pass,
    # window> at 192/128 and 64/64
    lib = cuda_lib.load()
    dims = r"(?:Li(\d+)ELi(\d+)E)?"  # the tensors' head dims (72/72 on 128-column tiles)
    flash = {r"flash_fwd(?:64)?_kernelILi(\d+)ELi(\d+)E(?:Lb(\d)E)?" + dims: "fwd",
             r"flash_bwd_kernelILb(\d)E": "bwd",
             r"flash_dq_kernelILi(\d+)ELi(\d+)ELb(\d)E(?:Lb(\d)E)?" + dims: "dq",
             r"flash_dkv_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E(?:Lb(\d)E)?" + dims: "dkv"}
    for i, ln in enumerate(ptxas):
        for pattern, kind in flash.items():
            m = re.search(pattern, ln) if ln.startswith("kernel") else None
            if m is None:
                continue
            g = [None if x is None else int(x) for x in m.groups()]
            # the tensors' head dims, then the split kernels' and the
            # forward's last flag, CAUSAL (absent at 256/256's forward): 0
            # for the non-causal instantiations
            dvg, dg = (g.pop(), g.pop()) if kind != "bwd" else (None, None)
            causal = g.pop() if kind != "bwd" else None
            nc = ", non-causal" if causal == 0 else ""
            if dg is not None and (dg, dvg) != (g[0], g[1]):
                g[0], g[1] = dg, dvg  # name and size it by its head dims
                nc += f", on {m.group(1)}-column tiles"
            if kind == "fwd":  # flash_fwd64_kernel at (256, 256): 64-key tiles
                kern = "flash_fwd64_kernel" if "fwd64" in ln else "flash_fwd_kernel"
                name, smem = f"{kern}<{g[0]}, {g[1]}{nc}>", lib.xt_flash_fwd_smem_bytes(*g)
            elif kind == "bwd":
                name = f"flash_bwd_kernel<{'two_pass' if g[0] else 'grouped'}>"
                smem = lib.xt_flash_bwd_smem_bytes(0, 128, 128)
            elif kind == "dq":
                name = f"flash_dq_kernel<{g[0]}, {g[1]}{', window' if g[2] else ''}{nc}>"
                smem = lib.xt_flash_bwd_smem_bytes(1, g[0], g[1])
            else:
                name = (f"flash_dkv_kernel<{g[0]}, {g[1]}, {'two_pass' if g[2] else 'grouped'}"
                        f"{', window' if g[3] else ''}{nc}>")
                smem = lib.xt_flash_bwd_smem_bytes(2, g[0], g[1])
            after = ptxas[i + 1:i + 3]
            say("build", kernel=name, smem_bytes=smem,
                registers=repr(next((x for x in after if "registers" in x), "?")),
                spills=repr(next((x for x in after if "spill" in x), "?")))
    # the grouped GEMMs (#6 nn/nt, #7 dw): one instantiation per mode and
    # tile width, grouped_kernel<mode, BN, reduce> (mode 0 nn, 1 nt, 2 dw;
    # reduce: dw adding into its f32 output, the fused CE's dW); the fused
    # CE's logits sweep, ce_sweep_kernel<fwd> (#8's statistics, then
    # ce_lse_combine_kernel) and <coeff> (#9/#10's coefficients); the fused
    # expert MLP (#16); the fp8 grouped GEMMs (#12 gg, #13 dw),
    # fp8_grouped_kernel<mode, A type, B type, out>; the block-sparse
    # kernels, bs_fwd_kernel (#14), bs_dq_kernel and bs_dkv_kernel (#15),
    # each <D, Dv>. A C7517
    # warning (a wgmma wait ptxas injected) is printed beside its kernel
    injected = [ln for ln in log.read_text().splitlines() if "C7517" in ln] \
        if log.exists() else []
    for i, ln in enumerate(ptxas):
        if not ln.startswith("kernel"):
            continue
        inst = re.search(r"(?<!fp8_)grouped_kernelILi(\d)ELi(\d+)ELb(\d)E", ln)
        sweep = re.search(r"ce_sweep_kernelILb(\d)E", ln)
        fp8g = re.search(r"fp8_grouped_kernelILi(\d)ELi(\d)ELi(\d)E(f|13__nv_bfloat16)E", ln)
        bsk = re.search(r"bs_(fwd|dq|dkv)_kernelILi(\d+)ELi(\d+)EE", ln)
        paged = re.search(r"paged_decode_kernelILi(\d+)E", ln)
        after = ptxas[i + 1:i + 3]
        regs = {"registers": repr(next((x for x in after if "registers" in x), "?")),
                "spills": repr(next((x for x in after if "spill" in x), "?"))}
        if inst:
            mode, bn, red = (int(x) for x in inst.groups())
            say("build", kernel=f"grouped_kernel<{('nn', 'nt', 'dw')[mode]}, {bn}"
                                f"{', reduce' if red else ''}>",
                smem_bytes=lib.xt_grouped_gemm_smem_bytes(mode, bn), **regs)
        elif sweep:
            name = f"ce_sweep_kernel<{('coeff', 'fwd')[int(sweep.group(1))]}>"
            mangled = f"ce_sweep_kernelILb{sweep.group(1)}E"
            say("build", kernel=name, **regs,
                injected_waits=sum(mangled in x for x in injected))
        elif "ce_lse_combine_kernel" in ln:
            say("build", kernel="ce_lse_combine_kernel", **regs)
        elif paged:
            d = int(paged.group(1))
            say("build", kernel=f"paged_decode_kernel<{d}>",
                smem_bytes=lib.xt_paged_decode_smem_bytes(128, d), **regs)
        elif "fused_moe_mlp_kernel" in ln:
            say("build", kernel="fused_moe_mlp_kernel",
                smem_bytes=lib.xt_fused_moe_mlp_smem_bytes(), **regs,
                injected_waits=sum("fused_moe_mlp_kernel" in x for x in injected))
        elif bsk:
            kind, d, dv = bsk.group(1), int(bsk.group(2)), int(bsk.group(3))
            say("build", kernel=f"bs_{kind}_kernel<{d}, {dv}>",
                smem_bytes=lib.xt_block_sparse_smem_bytes(("fwd", "dq", "dkv").index(kind), d,
                                                          dv),
                **regs, injected_waits=sum(bsk.group(0) in x for x in injected))
        elif fp8g:
            mode, ta, tb, out = fp8g.groups()
            types = ("e4m3", "e5m2")
            say("build", kernel=f"fp8_grouped_kernel<{('gg', 'dw', 'dense')[int(mode)]}, "
                                f"{types[int(ta)]}x{types[int(tb)]}, "
                                f"{'f32' if out == 'f' else 'bf16'}>",
                smem_bytes=lib.xt_fp8_grouped_smem_bytes(int(out == "f")), **regs,
                injected_waits=sum(fp8g.group(0) in x for x in injected))


def phase_kernels(torch, seed: int) -> list[dict]:
    # flash at the slice's prefill: one 1000-token prompt in a 1024 bucket;
    # paged decode (#5) at PAGED_SHAPES, its device time alone later
    # (`phase_paged_device_time`)
    flash = serving_flash_row(torch, seed, "serve", 1024, 1000)
    rows_paged = {label: check_paged(torch, seed, label, lens, mb)
                  for label, lens, mb in PAGED_SHAPES}
    return [flash, paged_row("serve", rows_paged["serve"])]


def paged_row(path: str, nums: dict) -> dict:
    """#5's kernel row on `path` from `check_paged`'s numbers."""
    say("kernel", name="library", path=path,
        paged_decode="none: no PyTorch call reads a block-table KV cache")
    return {"name": "paged_decode", "route": "cuda",
            "source": "xtuner_tpu_torch/csrc/paged_decode.cu",
            "replaces": "xtuner_tpu/ops/attention/paged_decode.py:66", "path": path,
            "launches": 0, **nums, "library_ms": None}


def serving_flash_row(torch, seed: int, path: str, l: int, real: int) -> dict:
    """#1 against its plain version at a serving prefill of Qwen3-8B's
    attention (B1, Hq32/8, D128): `real` tokens right-padded to `l`;
    errors, zero padding rows, times, SDPA's, the bound. Returns the
    kernel row on `path`."""
    from xtuner_tpu_torch.ops.attention.flash import (BIG_LSE, flash_attention,
                                                      flash_attention_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, d = 1, 32, 8, 128
    q = torch.randn((b, l, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
    seg = (torch.arange(l, device=dev) < real).to(torch.int32)[None].contiguous()
    scale = d ** -0.5
    out, lse = flash_attention(q, k, v, seg)
    ref_out, ref_lse = flash_attention_plain(q, k, v, seg, scale)
    torch.cuda.synchronize()
    out_err = (out[:, :real].float() - ref_out[:, :real].float()).abs().max().item()
    lse_err = (lse[..., :real] - ref_lse[..., :real]).abs().max().item()
    pad_ok = bool((out[:, real:] == 0).all()) and \
        bool((lse[..., real:] == torch.tensor(BIG_LSE, dtype=torch.float32)).all())
    f_ms = cuda_ms(lambda: flash_attention(q, k, v, seg))
    f_plain = cuda_ms(lambda: flash_attention_plain(q, k, v, seg, scale))
    f_lib, f_why = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg))
    say("kernel", name="flash_fwd", path=path,
        shape=f"B{b}xL{l}({real} real)xHq{hq}xHkv{hkv}xD{d}",
        out_err=f"{out_err:.3e}", lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok,
        ms=f"{f_ms:.4f}", plain_ms=f"{f_plain:.4f}",
        **fwd_numbers(torch, q, k, v, seg, None, f_ms, f_lib))
    say("kernel", name="library", path=path, flash_fwd_sdpa_ms=f_lib, why=repr(f_why))
    if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok):
        raise AssertionError(f"flash kernel ({path}) disagrees with its plain version: out "
                             f"{out_err} (<= {FLASH_OUT_ATOL}), lse {lse_err} "
                             f"(<= {FLASH_LSE_ATOL}), padding rows ok {pad_ok}")
    return {"name": "flash_fwd", "route": "cuda", "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": path, "launches": 0,
            "max_abs_err": max(out_err, lse_err), "ms": f_ms, "plain_ms": f_plain,
            **least_ms(4 * causal_pairs(torch, seg) * hq * d, flash_bytes(q, k), PEAK_BF16),
            "library_ms": f_lib}


# #5's shapes, Qwen3-8B's attention (Hq 32, Hkv 8, D 128, blocks of 128,
# one query token a slot): the slice's decode (4 slots, one inactive, a
# 16-entry table), then a rollout (32 slots of 4096 cached tokens, a
# 64-entry table: an engine sized for 8192 tokens)
PAGED_SHAPES = (("serve", [1000, 0, 517, 1900], 16), ("rollout", [4096] * 32, 64))
PAGED_HQ, PAGED_HKV, PAGED_D, PAGED_BS = 32, 8, 128, 128
PAGED_DIMS = (PAGED_HQ, PAGED_HKV, PAGED_D, PAGED_BS)
# gpt-oss-20b's decode (Hq 64, Hkv 8, D 64, blocks of 128, per-head sinks):
# (label, lens, table entries, window, sinks) on a windowed and a full
# layer, at the serving phase's shape and at a rollout
OSS_DIMS = (64, 8, 64, 128)
OSS_PAGED_SHAPES = (("serve_window", [1000, 0, 517, 1900], 16, 128, True),
                    ("serve_full", [1000, 0, 517, 1900], 16, None, True),
                    ("rollout_window", [4096] * 32, 64, 128, True),
                    ("rollout_full", [4096] * 32, 64, None, False))


def paged_inputs(torch, seed: int, lens: list, mb: int, n_layers: int = 2,
                 dims: tuple = PAGED_DIMS, sinks: bool = False):
    """#5's inputs at one of PAGED_SHAPES, from `seed`: an `n_layers`-layer
    pool holding just the slots' blocks (block 0 the inactive slots', each
    active slot's in order from block 1), q, the table, the lengths and,
    with `sinks`, per-head sink logits (None without)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    hq, hkv, d, bs = dims
    nb = 1 + sum(-(-(n + 1) // bs) for n in lens if n)
    pk = torch.randn((n_layers, nb, bs, hkv, d), generator=g, device=dev).bfloat16()
    pv = torch.randn((n_layers, nb, bs, hkv, d), generator=g, device=dev).bfloat16()
    qd = torch.randn((len(lens), 1, hq, d), generator=g, device=dev).bfloat16()
    table = torch.zeros((len(lens), mb), dtype=torch.int32)
    nxt = 1
    for bi, n in enumerate(lens):
        if n:
            for t in range(-(-(n + 1) // bs)):
                table[bi, t] = nxt
                nxt += 1
    snk = torch.randn((hq,), generator=g, device=dev) if sinks else None
    return (qd, pk, pv, table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev),
            snk)


def paged_bound(lens: list, dims: tuple = PAGED_DIMS, window=None) -> dict:
    """#5's least time: each active slot's keys it sees (its cached keys
    and this token's, only the last `window` of them with a window), K and
    V read once (bf16), q read (bf16) and out written (f32) once; the
    operations of S and O over the same keys."""
    hq, hkv, d, _ = dims
    keys = sum(min(n + 1, window or n + 1) for n in lens if n)
    return least_ms(4 * keys * hq * d, 4 * keys * hkv * d + len(lens) * hq * d * (2 + 4),
                    PEAK_BF16)


def check_paged(torch, seed: int, label: str, lens: list, mb: int, dims: tuple = PAGED_DIMS,
                window=None, sinks: bool = False) -> dict:
    """#5 against its plain version at one of PAGED_SHAPES or
    OSS_PAGED_SHAPES (layer 1 of `paged_inputs`): error, finite, two
    launches' bits, ms through the wrapper, the plain version's, the bytes
    bound and its share. Returns the kernel row's numbers."""
    from xtuner_tpu_torch.ops.attention.paged_decode import (max_window_blocks,
                                                             paged_decode_attn,
                                                             paged_decode_attn_plain,
                                                             paged_decode_split_plan)

    hq, hkv, d, bs = dims
    qd, pk, pv, table, seq_lens, snk = paged_inputs(torch, seed, lens, mb, dims=dims,
                                                    sinks=sinks)
    kw = dict(scale=d ** -0.5, window=window, sinks=snk)

    def kern():
        return paged_decode_attn(qd, pk, pv, 1, table, seq_lens, **kw)

    od, again = kern(), kern()
    ref_d = paged_decode_attn_plain(qd, pk, pv, 1, table, seq_lens, **kw)
    torch.cuda.synchronize()
    live = seq_lens > 0  # an inactive slot's output is discarded (undefined without sinks)
    d_err = (od[live] - ref_d[live]).abs().max().item()
    finite, same = bool(torch.isfinite(od).all()), torch.equal(od, again)
    del ref_d, again
    p_ms = cuda_ms(kern)
    p_plain = cuda_ms(lambda: paged_decode_attn_plain(qd, pk, pv, 1, table, seq_lens, **kw),
                      iters=3, warmup=1)
    b = paged_bound(lens, dims, window)
    walk_mb = min(mb, max_window_blocks(window, 1, bs)) if window else mb
    splits = paged_decode_split_plan(len(lens), hkv, walk_mb,
                                     torch.cuda.get_device_properties(0).multi_processor_count)
    say("kernel", name="paged_decode", shape=label,
        dims=f"B{len(lens)}xC1xHq{hq}xHkv{hkv}xD{d}xBS{bs}xMB{mb}", window=window,
        sinks=sinks, splits=splits,
        kv_mb=f"{4 * sum(n + 1 for n in lens if n) * hkv * d / 1e6:.1f}",
        seq_lens=",".join(map(str, sorted(set(lens)))), err=f"{d_err:.3e}", finite=finite,
        same_bits=same, ms=f"{p_ms:.4f}", plain_ms=f"{p_plain:.4f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
        share_of_bound=f"{b['bound_ms'] / p_ms:.3f}",
        parent_ms_perf_md=PARENT_MS.get(("paged_decode", label), "not measured"))
    if not (d_err <= PAGED_ATOL and finite and same):
        raise AssertionError(f"paged decode kernel ({label}) disagrees with its plain version: "
                             f"{d_err} (<= {PAGED_ATOL}), finite {finite}, two launches "
                             f"same bits {same}")
    return {"max_abs_err": d_err, "ms": p_ms, "plain_ms": p_plain, **b}


def phase_paged_device_time(torch, seed: int, kernels: list[dict]) -> None:
    """#5's device time alone (`kernel_device_ms`) at each of PAGED_SHAPES
    and OSS_PAGED_SHAPES, on `check_paged`'s inputs made again; the rows of
    `kernels` at those shapes gain `kernel_ms` and `kernel_share_of_bound`.
    It runs after the serving phases' timed requests: a profiler window
    leaves the process slower to launch from the host (the serving decode
    step by 10-15 ms on an H100, `tools/bench_serve_decode.py
    --profile-after`), and that loop is host-bound, so the serving phases
    open no profiler window before their timings end."""
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn

    shapes = [("serve", label, lens, mb, PAGED_DIMS, None, False)
              for label, lens, mb in PAGED_SHAPES]
    shapes += [("serve_gpt_oss", label, lens, mb, OSS_DIMS, window, sinks)
               for label, lens, mb, window, sinks in OSS_PAGED_SHAPES]
    for path, label, lens, mb, dims, window, sinks in shapes:
        qd, pk, pv, table, seq_lens, snk = paged_inputs(torch, seed, lens, mb, dims=dims,
                                                        sinks=sinks)
        k_ms = kernel_device_ms(torch, lambda: paged_decode_attn(
            qd, pk, pv, 1, table, seq_lens, scale=dims[2] ** -0.5, window=window, sinks=snk),
            "paged_decode_kernel")
        b = paged_bound(lens, dims, window)
        say("kernel", name="paged_decode", path=path, shape=label, kernel_ms=f"{k_ms:.4f}",
            bound_ms=f"{b['bound_ms']:.4f}", kernel_share_of_bound=f"{b['bound_ms'] / k_ms:.3f}")
        for row in kernels:
            if row["name"] == "paged_decode" and row["path"] == path and \
                    row.get("shape", "serve") == label:
                row.update(kernel_ms=k_ms, kernel_share_of_bound=b["bound_ms"] / k_ms)
        del qd, pk, pv, table, seq_lens, snk


def kernel_device_ms(torch, fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of the kernels named `kernel` that `iters` calls of
    `fn` launch (torch.profiler): the launch alone, without the host's
    time between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not times:
        raise AssertionError(f"{kernel}: no device launch in the profile of {iters} calls")
    if len(times) != iters:  # the profiler may drop events; the mean stands
        say("kernel", name=kernel, profiled_launches=len(times), calls=iters)
    return sum(times) / len(times)


def doc_lengths(rng, total: int, docs: int, pad: int) -> list[int]:
    """`docs` seeded document lengths that fill `total - pad` tokens."""
    cuts = sorted(rng.choice(range(256, total - pad - 256), docs - 1, replace=False).tolist())
    bounds = [0, *cuts, total - pad]
    return [bounds[i + 1] - bounds[i] for i in range(docs)]


def _segments(torch, lens: list[int], total: int, dev):
    seg = torch.zeros((1, total), dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i + 1
        off += n
    return seg.to(dev)


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp(min=1e-30)).item()


def _abs(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def least_ms(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take for work of `flops` operations
    at `peak` and `nbytes` of traffic at HBM_BYTES_S, and which binds."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def add_bound(row: dict, b: dict) -> None:
    """Sum the bounds of the calls a row's time sums; `bound_by` is the
    one that binds the larger part."""
    parts = row.setdefault("_bound_parts", {"operations": 0.0, "bytes": 0.0})
    parts[b["bound_by"]] += b["bound_ms"]
    row["bound_ms"] = parts["operations"] + parts["bytes"]
    row["bound_by"] = max(parts, key=parts.get)


def library_ms(torch, fn, iters: int = 5):
    """CUDA-event ms of one PyTorch call that computes a kernel's function
    (its yardstick; the port never calls it), or (None, why) where PyTorch
    refuses it."""
    try:
        return cuda_ms(fn, iters=iters, warmup=1), "ok"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"


def block_causal_mask(torch, seg):
    """(B, 1, L, L) bool: causal within a document (padding rows attend
    to earlier padding, so that no row is empty)."""
    l = seg.shape[-1]
    causal = torch.ones((l, l), dtype=torch.bool, device=seg.device).tril()
    return ((seg[:, :, None] == seg[:, None, :]) & causal)[:, None]


def causal_pairs(torch, seg) -> int:
    """(query, key) pairs on the documents' causal triangles (segment 0,
    padding, excluded)."""
    total = 0
    for row in seg.cpu():
        ids, counts = torch.unique_consecutive(row, return_counts=True)
        total += sum(n * (n + 1) // 2 for i, n in zip(ids.tolist(), counts.tolist()) if i)
    return total


def sdpa_ms(torch, q, k, v, mask, do=None, iters: int = 5):
    """`scaled_dot_product_attention` with a boolean (B, 1, L, L) mask and
    GQA on the kernels' (B, L, H, D) inputs: the forward, or with `do` the
    backward (one call giving dq, dk and dv together)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if do is None:
        return library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)
    return library_ms(torch, lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True),
                      iters)


def flash_bytes(q, k, out_like: int = 1, dv: int = 0) -> int:
    """q, k, v read once (bf16), out written (bf16) and lse (f32); v and out
    have the v head dim `dv` (q's when 0)."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], dv or d
    return 2 * b * l * (hq * d + hkv * (d + dv)) + out_like * 2 * b * l * hq * dv \
        + 4 * b * hq * l


def fwd_numbers(torch, q, k, v, seg, bound, ms: float, lib) -> dict:
    """The flash forward's figures beside its time `ms`: TFLOP/s on the
    documents' causal triangles, its share of the bound, SDPA's time `lib`,
    and the k tiles one launch walks and walks unmasked (full), as the
    kernel counts them, against `fwd_tile_plan` times the q heads; raises
    if the two differ."""
    from xtuner_tpu_torch.ops.attention import flash as fl

    hq, d, dv = q.shape[2], q.shape[3], v.shape[3]
    flops = 2 * causal_pairs(torch, seg) * hq * (d + dv)
    least = least_ms(flops, flash_bytes(q, k, dv=dv), PEAK_BF16)["bound_ms"]
    fl.reset_launches()
    fl.flash_attention(q, k, v, seg, max_logit=bound)
    walked, full = fl.fwd_tiles_walked()
    walk, plan_full = fl.fwd_tile_plan(seg)
    fl.reset_launches()
    plan = (int(walk.sum()) * hq, int(plan_full.sum()) * hq)
    if (walked, full) != plan:
        raise AssertionError(f"the flash forward walked {walked} k tiles ({full} full) where "
                             f"its plan says {plan[0]} ({plan[1]}) at {tuple(q.shape)}")
    return {"tflops": f"{flops / ms / 1e9:.1f}", "bound_ms": f"{least:.4f}",
            "share_of_bound": f"{least / ms:.3f}", "sdpa_ms": lib, "tiles_walked": walked,
            "tiles_full": full, "plan_walked_full": f"{plan[0]},{plan[1]}"}


def bwd_bound(q, k, pairs: int, two_pass: bool = False, dv: int = 0) -> dict:
    """`least_ms` of the flash backward: five products, 2 (3 D + 2 Dv)
    flops per visible (query, key) pair and q head (S, dK and dQ over D; dP
    and dV over Dv); q, k, v and do read once (bf16), lse and delta (f32),
    dq and dk, dv (per q head when two-pass) written once (bf16). `dv`: the
    v head dim (q's when 0)."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], dv or d
    ho = hq if two_pass else hkv
    nbytes = 2 * b * l * (hq * (d + dv) + hkv * (d + dv)) + 8 * b * hq * l \
        + 2 * b * l * (hq * d + ho * (d + dv))
    return least_ms(2 * (3 * d + 2 * dv) * pairs * hq, nbytes, PEAK_BF16)


def bwd_rows(path: str, nums: dict, two_pass: bool = False) -> list[dict]:
    """The kernels line's rows of the one-pass backward, each with the whole
    kernel's numbers: the grouped instantiation stands for #2 (dq) and #3
    (grouped dk/dv), the two-pass one for #2 and #4."""
    name, fn = ("flash_bwd_two_pass", "true") if two_pass else ("flash_bwd", "false")
    return [{"name": name, "route": "cuda", "source": "xtuner_tpu_torch/csrc/flash_bwd.cu",
             "function": f"flash_bwd_kernel<{fn}>",
             "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}", "path": path, **nums}
            for line in (199, 249 if two_pass else 303)]


def grouped_mm_ms(torch, x, w, sizes, kind: str):
    """`torch._grouped_mm` on the grouped GEMMs' inputs: nn, nt (w
    transposed) or dw (x^T dy over ragged rows, bf16 out where the kernel
    writes f32)."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if kind == "nn":
        return library_ms(torch, lambda: torch._grouped_mm(x, w, offs=offs))
    if kind == "nt":
        return library_ms(torch, lambda: torch._grouped_mm(x, w.transpose(1, 2), offs=offs))
    return library_ms(torch, lambda: torch._grouped_mm(x.t(), w, offs=offs))


def grouped_cases(x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e,
                  kinds=("nn", "nt", "dw")) -> list:
    """The bf16 grouped GEMMs one MoE layer runs (gate|up and down; forward
    nn, dgrad nt, wgrad dw; `kinds` of them): (kernel, which, kernel call,
    plain call, the library call's inputs, operations, bytes)."""
    from xtuner_tpu_torch.ops.bf16_grouped import (grouped_gemm_bf16, grouped_gemm_bf16_dw,
                                                   grouped_gemm_dw_plain, grouped_gemm_plain)

    cases = []
    for which, xin, w, dy in (("gate|up", x, w_gu, dy_gu), ("down", hmid, w_dn, dy_dn)):
        m, kk = xin.shape
        nn_ = w.shape[2]
        flops = 2 * m * kk * nn_
        wb = 2 * e * kk * nn_
        cases += [
            ("grouped_gemm_nn", which, lambda xin=xin, w=w: grouped_gemm_bf16(xin, w, sizes),
             lambda xin=xin, w=w: grouped_gemm_plain(xin, w, sizes), (xin, w, "nn", sizes), flops,
             2 * m * kk + wb + 2 * m * nn_),
            ("grouped_gemm_nt", which,
             lambda dy=dy, w=w: grouped_gemm_bf16(dy, w, sizes, transpose_rhs=True),
             lambda dy=dy, w=w: grouped_gemm_plain(dy, w, sizes, transpose_rhs=True),
             (dy, w, "nt", sizes), flops, 2 * m * nn_ + wb + 2 * m * kk),
            ("grouped_gemm_dw", which,
             lambda xin=xin, dy=dy: grouped_gemm_bf16_dw(xin, dy, sizes, e),
             lambda xin=xin, dy=dy: grouped_gemm_dw_plain(xin, dy, sizes, e),
             (xin, dy, "dw", sizes), flops, 2 * m * kk + 2 * m * nn_ + 4 * e * kk * nn_),
        ]
    return [c for c in cases if c[4][2] in kinds]


def grouped_rows(torch, path: str, cases, m: int, e: int, iters: int,
                 plain_iters: int) -> list[dict]:
    """Each grouped GEMM against its plain version and `torch._grouped_mm`;
    one row per kernel: the worst error of its GEMMs, the times and bounds
    summed over the two GEMMs the layer runs it on. Each GEMM also prints
    its share of the bound and what its CTAs walked (items with products,
    zero items, contraction chunks) against `grouped_plan_counts`; a
    mismatch fails."""
    from xtuner_tpu_torch.ops import bf16_grouped as bg

    by_name: dict = {}
    for name, which, kern, plain, (a, b_, kind, sz), flops, nbytes in cases:
        bg.reset_launches()
        got, want = kern(), plain()
        torch.cuda.synchronize()
        walked = bg.grouped_tiles_walked()[kind]
        bg.reset_launches()
        k_, n_ = (a.shape[1], b_.shape[1]) if kind == "dw" else (b_.shape[1], b_.shape[2])
        plan = bg.grouped_plan_counts(sz, m, kind, k_, n_)
        err, rel = _abs(got, want), _rel(got, want)
        del got, want
        ms = cuda_ms(kern, iters=iters)
        pms = cuda_ms(plain, iters=plain_iters, warmup=1)
        lib, why = grouped_mm_ms(torch, a, b_, sz, kind)
        least = least_ms(flops, nbytes, PEAK_BF16)
        say("kernel", name=name, gemm=which, m=m, experts=e, err=f"{err:.3e}",
            rel=f"{rel:.3e}", ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", library_ms=lib,
            why=repr(why), tflops=f"{flops / ms / 1e9:.1f}",
            plain_tflops=f"{flops / pms / 1e9:.1f}", bound_ms=f"{least['bound_ms']:.4f}",
            bound_by=least["bound_by"], share_of_bound=f"{least['bound_ms'] / ms:.3f}",
            walked=",".join(map(str, walked)), plan=",".join(map(str, plan)))
        if walked != plan:
            raise AssertionError(f"{name} ({which}) walked {walked} (items, zero items, "
                                 f"chunks) where its plan says {plan}")
        if not rel <= (DW_RTOL if name.endswith("dw") else GG_RTOL):
            raise AssertionError(f"{name} ({which}) disagrees with its plain version: {rel}")
        row = by_name.setdefault(name, {
            "name": name, "route": "cuda", "source": "xtuner_tpu_torch/csrc/grouped_gemm.cu",
            "replaces": ("xtuner_tpu/ops/bf16_grouped.py:174" if name.endswith("dw")
                         else "xtuner_tpu/ops/bf16_grouped.py:62"), "path": path,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += pms
        row["library_ms"] = None if lib is None or row["library_ms"] is None \
            else row["library_ms"] + lib
        add_bound(row, least)
    return list(by_name.values())


def phase_train_kernels(torch, seed: int) -> list[dict]:
    """The train slice's kernels against their plain versions at the shapes
    the step gives them (Qwen3-30B-A3B, one 8192-token row) and at odd
    shapes."""
    import numpy as np

    from xtuner_tpu_torch.ops import bf16_grouped as bg
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.ops.bf16_grouped import (bf16_grouped_linear, grouped_gemm_bf16,
                                                   grouped_gemm_bf16_dw,
                                                   grouped_gemm_dw_plain,
                                                   grouped_gemm_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    rows = []

    # ---- flash at the step's shape: B1 L8192 Hq32 Hkv4 D128, 5 docs + pad
    b, l, hq, hkv, d = 1, SEQ, 32, 4, 128
    lens = doc_lengths(rng, l, 5, int(rng.integers(100, 400)))
    seg = _segments(torch, lens, l, dev)
    # qk-normed rows (|x| = sqrt(d)) as the model feeds them: the bound
    # sqrt(d) * 1 * 1 = 11.3 holds, so the max-free variant runs
    def normed(h):
        x = torch.randn((b, l, h, d), generator=g, device=dev)
        return (x * (d ** 0.5) / x.norm(dim=-1, keepdim=True)).bfloat16()
    q, k, v = normed(hq), normed(hkv), torch.randn((b, l, hkv, d), generator=g,
                                                    device=dev).bfloat16()
    bound = torch.tensor(d ** 0.5, device=dev)
    scale = d ** -0.5
    fl.reset_launches()
    out, lse = fl.flash_attention(q, k, v, seg, max_logit=bound)
    torch.cuda.synchronize()
    if fl.max_free_launches() != 1:
        raise AssertionError("the max-free variant did not run under a bound of 11.3")
    ref_out, ref_lse = fl.flash_attention_plain(q, k, v, seg, scale, max_free=True)
    valid = seg[0] != 0
    mf_out_err = _abs(out[:, valid], ref_out[:, valid])
    mf_lse_err = _abs(lse[..., valid], ref_lse[..., valid])
    mf_pad_ok = bool((out[:, ~valid] == 0).all()) and \
        bool((lse[..., ~valid] == torch.tensor(fl.BIG_LSE, dtype=torch.float32)).all())
    mf_err = max(mf_out_err, mf_lse_err)
    del ref_out, ref_lse
    mf_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=10)
    rm_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg), iters=10)
    mf_plain = cuda_ms(lambda: fl.flash_attention_plain(q, k, v, seg, scale, max_free=True),
                       iters=3, warmup=1)
    pairs = causal_pairs(torch, seg)
    lib_fwd, why_fwd = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg))
    say("kernel", name="flash_fwd_max_free",
        shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}", docs=",".join(map(str, lens)),
        out_err=f"{mf_out_err:.3e}", lse_err=f"{mf_lse_err:.3e}", pad_rows_ok=mf_pad_ok,
        ms=f"{mf_ms:.4f}", running_max_ms=f"{rm_ms:.4f}", plain_ms=f"{mf_plain:.4f}",
        **fwd_numbers(torch, q, k, v, seg, bound, mf_ms, lib_fwd))
    if not (mf_out_err <= FLASH_OUT_ATOL and mf_lse_err <= FLASH_LSE_ATOL and mf_pad_ok):
        raise AssertionError(f"max-free flash disagrees with its plain version: out "
                             f"{mf_out_err} (<= {FLASH_OUT_ATOL}), lse {mf_lse_err} "
                             f"(<= {FLASH_LSE_ATOL}), padding rows ok {mf_pad_ok}")
    rows.append({"name": "flash_fwd_max_free", "route": "cuda",
                 "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "train",
                 "max_abs_err": mf_err, "ms": mf_ms, "plain_ms": mf_plain,
                 **least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16),
                 "library_ms": lib_fwd})

    do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, scale)
    got = fl.flash_bwd(*args)
    ref = fl.flash_bwd_plain(*args)
    errs = [_abs(t, w) for t, w in zip(got, ref)]
    rels = [_rel(t, w) for t, w in zip(got, ref)]
    pad_ok = all(bool((t[seg == 0] == 0).all()) for t in got)
    del got, ref
    bwd_ms = cuda_ms(lambda: fl.flash_bwd(*args), iters=10)
    bwd_plain = cuda_ms(lambda: fl.flash_bwd_plain(*args), iters=3, warmup=1)
    lib_bwd, why_bwd = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg), do)
    bwd_b = bwd_bound(q, k, pairs)
    # whether the grouped grid (one CTA per 128-row k tile, kv head and row)
    # fills the card at 4 kv heads: the two-pass grid has 8x the CTAs
    tp_ms = cuda_ms(lambda: fl.flash_bwd(*args, True), iters=10)
    ctas = -(-l // fl.KEY_TILE) * hkv * b
    say("kernel", name="flash_bwd", shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}",
        dq_dk_dv_err=",".join(f"{e:.3e}" for e in errs),
        dq_dk_dv_rel=",".join(f"{r_:.3e}" for r_ in rels), pad_rows_ok=pad_ok,
        ms=f"{bwd_ms:.4f}", plain_ms=f"{bwd_plain:.4f}", bound_ms=f"{bwd_b['bound_ms']:.4f}",
        tflops=f"{10 * pairs * hq * d / bwd_ms / 1e9:.1f}", grouped_ctas=ctas,
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        two_pass_ms=f"{tp_ms:.4f}", two_pass_ctas=ctas * (hq // hkv))
    say("kernel", name="library", shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}",
        sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd, why=repr(f"{why_fwd}; {why_bwd}"))
    if not (max(rels) <= FLASH_GRAD_RTOL and pad_ok):
        raise AssertionError(f"the flash backward kernel disagrees with its plain version: "
                             f"dq, dk, dv {rels} (<= {FLASH_GRAD_RTOL}), padding rows ok "
                             f"{pad_ok}")
    rows += bwd_rows("train", {"max_abs_err": max(errs), "ms": bwd_ms, "plain_ms": bwd_plain,
                               **bwd_b, "library_ms": lib_bwd})
    del q, k, v, do, out, lse, delta, args

    # gradients end to end against autograd through the plain forward; the
    # plain backward keeps several (L, L) f32 tensors per head group, so
    # this check runs at L = 2048, and at an L that is not a multiple of 64
    for ll, docs in ((2048, 3), (1000, 2)):
        segs = _segments(torch, doc_lengths(rng, ll, docs, 37), ll, dev)
        qq, kk = normed(hq)[:, :ll].contiguous(), normed(hkv)[:, :ll].contiguous()
        vv = torch.randn((b, ll, hkv, d), generator=g, device=dev).bfloat16()
        co = torch.randn(qq.shape, generator=g, device=dev)
        grads = []
        for fn in (lambda *a: fl.flash_attention(*a, max_logit=bound)[0],
                   lambda *a: fl.flash_attention_plain(*a, scale)[0]):
            leaves = [t.clone().requires_grad_(True) for t in (qq, kk, vv)]
            (fn(*leaves, segs).float() * co).sum().backward()
            grads.append([t.grad for t in leaves])
        rel = max(_rel(a, b_) for a, b_ in zip(*grads))
        say("kernel", name="flash_autograd", shape=f"B{b}xL{ll}xHq{hq}xHkv{hkv}xD{d}",
            docs=docs, rel_err=f"{rel:.3e}")
        if not rel <= FLASH_GRAD_RTOL:
            raise AssertionError(f"flash gradients disagree with autograd through the "
                                 f"plain version at L={ll}: {rel}")

    # ---- grouped GEMMs at the step's shapes: M = 8192 tokens x top-8
    e, hid, f = 128, 2048, 768
    m = SEQ * 8
    sizes = torch.tensor(rng.multinomial(m, rng.dirichlet(np.full(e, 2.0))),
                         dtype=torch.int32, device=dev)
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    rows += grouped_rows(torch, "train", grouped_cases(
        x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e), m, e, iters=10, plain_iters=5)
    del x, w_gu, w_dn, hmid, dy_gu, dy_dn

    # odd shapes: empty experts, one expert with every row, rows past the
    # last group, ragged M and N edges; and the linear's gradients
    odd = ((8192, 2048, 1536, [0] * 60 + [120] * 68),  # 60 empty; 32 rows past the last
           (8192, 768, 2048, [0] * 5 + [8192] + [0] * 122),  # one expert has every row
           (5000, 256, 224, [0, 1200, 0, 3000, 1]),  # ragged edges; 799 rows past the last
           # output width 128 for nt (the 128-wide tile, as the longctx down
           # dgrad), and for nn at the down shape
           (4096, 128, 1024, [700, 0, 1500, 900, 300, 96]),
           (1000, 96, 224, [100, 37, 700]))  # contraction 96: a half chunk at every edge
    for mm, kk_, nn_, sz in odd:
        ee = len(sz)
        gs = torch.tensor(sz, dtype=torch.int32, device=dev)
        xx = torch.randn((mm, kk_), generator=g, device=dev).bfloat16()
        ww = (torch.randn((ee, kk_, nn_), generator=g, device=dev) * 0.05).bfloat16()
        yy = torch.randn((mm, nn_), generator=g, device=dev).bfloat16()
        bg.reset_launches()
        rels = [_rel(grouped_gemm_bf16(xx, ww, gs), grouped_gemm_plain(xx, ww, gs)),
                _rel(grouped_gemm_bf16(yy, ww, gs, transpose_rhs=True),
                     grouped_gemm_plain(yy, ww, gs, transpose_rhs=True))]
        dw_rel = _rel(grouped_gemm_bf16_dw(xx, yy, gs, ee),
                      grouped_gemm_dw_plain(xx, yy, gs, ee))
        walked = bg.grouped_tiles_walked()
        plan = {kind: bg.grouped_plan_counts(gs, mm, kind, kk_, nn_) for kind in walked}
        if walked != plan:
            raise AssertionError(f"grouped GEMMs walked {walked} where the plan says {plan}")
        xl, wl = xx.clone().requires_grad_(True), ww.clone().requires_grad_(True)
        (bf16_grouped_linear(xl, wl, gs).float() * yy.float()).sum().backward()
        xr, wr = xx.float().requires_grad_(True), ww.float().requires_grad_(True)
        (grouped_gemm_plain(xr, wr, gs).float() * yy.float()).sum().backward()
        rels += [_rel(xl.grad, xr.grad), _rel(wl.grad, wr.grad)]
        say("kernel", name="grouped_gemm_odd", m=mm, k=kk_, n=nn_, experts=ee,
            empty=sum(1 for v_ in sz if v_ == 0), rows=sum(sz),
            nn_nt_grad_rel=",".join(f"{r_:.2e}" for r_ in rels), dw_rel=f"{dw_rel:.2e}",
            walked=repr(walked))
        if not (max(rels) <= GG_RTOL and dw_rel <= DW_RTOL):
            raise AssertionError(f"grouped GEMMs disagree at an odd shape: {rels}, {dw_rel}")

    # rows past the last group hold NaN: nn/nt must give exact zeros there
    # and dW stay finite and equal to the plain version (the wgrad zeroes
    # those rows of its last chunk in both operands); then an expert ending
    # mid-chunk before one whose rows are 1e3 times larger, each expert's
    # dW held on its own scale, so a leaked row would show (~1e6 relative)
    mm, kk_, nn_, sz = 1000, 256, 384, [300, 0, 333, 200]
    used, ee = sum(sz), len(sz)
    gs = torch.tensor(sz, dtype=torch.int32, device=dev)
    xx = torch.randn((mm, kk_), generator=g, device=dev).bfloat16()
    ww = (torch.randn((ee, kk_, nn_), generator=g, device=dev) * 0.05).bfloat16()
    yy = torch.randn((mm, nn_), generator=g, device=dev).bfloat16()
    xx[used:], yy[used:] = float("nan"), float("nan")
    out, dx = grouped_gemm_bf16(xx, ww, gs), grouped_gemm_bf16(yy, ww, gs, transpose_rhs=True)
    dw = grouped_gemm_bf16_dw(xx, yy, gs, ee)
    nan_ok = bool((out[used:] == 0).all()) and bool((dx[used:] == 0).all()) \
        and bool(torch.isfinite(dw).all())
    nan_rels = [_rel(out[:used], grouped_gemm_plain(xx, ww, gs)[:used]),
                _rel(dx[:used], grouped_gemm_plain(yy, ww, gs, transpose_rhs=True)[:used])]
    nan_dw = _rel(dw, grouped_gemm_dw_plain(xx, yy, gs, ee))
    sz = [100, 300, 112]
    gs = torch.tensor(sz, dtype=torch.int32, device=dev)
    xx = torch.randn((512, 128), generator=g, device=dev).bfloat16()
    yy = torch.randn((512, 256), generator=g, device=dev).bfloat16()
    xx[100:400] *= 1e3
    yy[100:400] *= 1e3
    dw, want = grouped_gemm_bf16_dw(xx, yy, gs, 3), grouped_gemm_dw_plain(xx, yy, gs, 3)
    leak_rels = [_rel(dw[i], want[i]) for i in range(3)]
    say("kernel", name="grouped_gemm_odd", nan_rows_past_last_group_ok=nan_ok,
        nan_nn_nt_rel=",".join(f"{r_:.2e}" for r_ in nan_rels), nan_dw_rel=f"{nan_dw:.2e}",
        mid_chunk_dw_rel_per_expert=",".join(f"{r_:.2e}" for r_ in leak_rels))
    if not (nan_ok and max(nan_rels) <= GG_RTOL and nan_dw <= DW_RTOL
            and max(leak_rels) <= DW_RTOL):
        raise AssertionError(f"grouped GEMMs: NaN rows past the last group {nan_ok}, "
                             f"{nan_rels}, {nan_dw}; mid-chunk dW per expert {leak_rels}")
    fl.reset_launches()
    return rows


def _peak_ms(torch, fn, iters: int = 3) -> tuple[float, float]:
    """(ms per call from CUDA events, peak device memory of one call above
    what was allocated before it, in GiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return cuda_ms(fn, iters=iters, warmup=1), peak


def phase_ce_kernels(torch, seed: int) -> list[dict]:
    """The fused CE kernels (#8, and #9/#10 as one backward: the coefficient
    sweep and the dh and dW products) against their plain versions: at the
    moe_heavy step's N = 2 x 8192 and the longctx row's N = 65536, H = 1024,
    V = 151936 with 5% ignored labels, at N = Nc + 300 (a ragged last row
    chunk), then at odd shapes (N not a multiple of the 128-row tile, V
    below one tile; a ragged vocab tail). The backward is checked under
    several cotangents: both terms; g_lse alone, so that dh and dW are the
    softmax part alone and the bound is relative to its own scale (with
    both, the label term's entries dominate dW at V = 151936, where p is
    ~1/V); g_lab alone. `ce_bwd` (dh and dW from one sweep, as the autograd
    backward runs it) must give `ce_dh`'s and `ce_dw`'s results bit for bit,
    and the coefficient kernel its plain version on the first row chunk.
    Per backward call at the two path shapes: each pass's device ms (the
    coefficient sweep, the dh and the dW products, dW's bf16 rounding), the
    share of the bound (three products of 2 N V H FLOPs), peak memory and
    the c scratch bytes, beside `torch.mm(..., out_dtype=float32)` over the
    same N x V x H product as the dh products (a tuned GEMM's time; the port
    never calls it). CUDA-event times and the peak memory of each wrapper,
    kernel and plain, under the first cotangents of each shape. Two forward
    launches must give the same bits; beside the forward's time, its
    parent's (PERF.md), its bound and `torch.mm` over the same N x V x H
    product."""
    import numpy as np

    from xtuner_tpu_torch.ops import fused_ce as fc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rng = np.random.default_rng(seed + 2)
    rows = []

    def ce_inputs(n, v, hd, ignored):
        h = torch.randn((n, hd), generator=g, device=dev).bfloat16()
        w = (torch.randn((v, hd), generator=g, device=dev) * 0.02).bfloat16()
        keep = torch.tensor(rng.random(n) >= ignored, device=dev)
        labels = torch.tensor(rng.integers(0, v, n), dtype=torch.int32, device=dev)
        labels = torch.where(keep, labels, 0).to(torch.int32).contiguous()
        g_lse = torch.where(keep, torch.rand((n,), generator=g, device=dev), 0.0).contiguous()
        g_lab = torch.where(keep, -torch.rand((n,), generator=g, device=dev), 0.0).contiguous()
        return h, w, labels, g_lse, g_lab

    main_n, vocab = SFT_ROWS * SEQ, 151936
    for n, v, hd, cotangents, path in (
            (main_n, vocab, 1024, ("both", "g_lse"), "sft"),
            (LONGCTX_SEQ, vocab, 1024, ("both", "g_lse"), "longctx"),
            (fc.ce_chunk_plan(main_n, vocab).nc + 300, vocab, 1024, ("both",), None),
            (1000, 100, 128, ("g_lab", "both"), None),
            (300, 5000, 256, ("g_lse",), None)):
        h, w, labels, g_lse_all, g_lab_all = ce_inputs(n, v, hd, 0.05)
        lse, lab = fc.ce_fwd(h, w, labels)
        lse2, lab2 = fc.ce_fwd(h, w, labels)
        repeat = torch.equal(lse, lse2) and torch.equal(lab, lab2)
        del lse2, lab2
        ref_lse, ref_lab = fc.ce_fwd_plain(h, w, labels)
        stat_err = max(_abs(lse, ref_lse), _abs(lab, ref_lab))
        shape = f"N{n}xH{hd}xV{v}"
        plan = fc.ce_chunk_plan(n, v)
        say("kernel", name="ce_fwd", shape=shape, lse_label_err=f"{stat_err:.3e}",
            bitwise_repeat=repeat, scratch_bytes=fc.ce_fwd_scratch_bytes(n, v))
        if not (stat_err <= CE_STAT_ATOL and repeat):
            raise AssertionError(f"ce_fwd disagrees with its plain version at {shape}: "
                                 f"lse/label {stat_err} (<= {CE_STAT_ATOL}), two launches "
                                 f"give the same bits {repeat}")
        for cot in cotangents:
            g_lse = torch.zeros_like(g_lse_all) if cot == "g_lab" else g_lse_all
            g_lab = torch.zeros_like(g_lab_all) if cot == "g_lse" else g_lab_all
            args = (h, w, labels, ref_lse, g_lse, g_lab)
            c0 = plan.chunks[0][1]
            first = (h[:c0], w, labels[:c0], ref_lse[:c0], g_lse[:c0], g_lab[:c0], plan.v_pad)
            c_k, c_p = fc.ce_coeff(*first), fc.ce_coeff_plain(*first)
            c_abs, c_rel = _abs(c_k, c_p), _rel(c_k, c_p)
            pad_zero = bool((c_k[:, v:] == 0).all())
            del c_k, c_p
            dh_k, dw_k = fc.ce_dh(*args), fc.ce_dw(*args)
            dh_b, dw_b = fc.ce_bwd(*args)
            one_sweep = torch.equal(dh_k, dh_b) and torch.equal(dw_k, dw_b)
            del dh_b, dw_b
            dh_p = fc.ce_dh_plain(*args)
            dh_abs, dh_rel = _abs(dh_k, dh_p), _rel(dh_k, dh_p)
            del dh_k, dh_p
            dw_p = fc.ce_dw_plain(*args)
            dw_abs, dw_rel = _abs(dw_k, dw_p), _rel(dw_k, dw_p)
            del dw_k, dw_p
            torch.cuda.synchronize()
            say("kernel", name="ce_bwd", shape=shape, ignored=0.05, cotangents=cot,
                chunks=len(plan.chunks), last_chunk_rows=plan.chunks[-1][1],
                coeff_err=f"{c_abs:.3e}", coeff_rel=f"{c_rel:.3e}", pad_zero=pad_zero,
                dh_err=f"{dh_abs:.3e}", dh_rel=f"{dh_rel:.3e}", dw_err=f"{dw_abs:.3e}",
                dw_rel=f"{dw_rel:.3e}", bwd_equals_dh_dw=one_sweep)
            if not (dh_rel <= GG_RTOL and dw_rel <= GG_RTOL and c_rel <= GG_RTOL and pad_zero
                    and one_sweep):
                raise AssertionError(f"the CE backward disagrees with its plain versions at "
                                     f"{shape}, cotangents {cot}: dh {dh_rel}, dw {dw_rel}, "
                                     f"c {c_rel} (<= {GG_RTOL}), pad columns zero {pad_zero}, "
                                     f"ce_bwd == (ce_dh, ce_dw) {one_sweep}")
            if cot != cotangents[0]:
                continue
            if path is not None:
                # one backward call, pass by pass, beside a tuned GEMM's time
                ms, peak = _peak_ms(torch, lambda: fc.ce_bwd(*args))
                marks: list = []
                for _ in range(3):
                    fc.ce_bwd(*args, marks=marks)
                passes = {k: t / 3 for k, t in fc.ce_bwd_pass_ms(marks).items()}
                c = torch.empty((plan.rows, v), device=dev, dtype=torch.bfloat16).normal_(
                    generator=g)
                mm_ms = cuda_ms(lambda: [torch.mm(c[:r], w, out_dtype=torch.float32)
                                         for _, r in plan.chunks], iters=3, warmup=1)
                del c
                bound = 3 * 2 * n * v * hd / PEAK_BF16 * 1e3
                say("kernel", name="ce_bwd", shape=shape, cotangents=cot, ms=f"{ms:.4f}",
                    coeff_ms=f"{passes['coeff']:.4f}", dh_products_ms=f"{passes['dh']:.4f}",
                    dw_products_ms=f"{passes['dw']:.4f}", round_ms=f"{passes['round']:.4f}",
                    bound_ms=f"{bound:.3f}", share_of_bound=f"{bound / ms:.3f}",
                    peak_gib=f"{peak:.3f}", c_scratch_bytes=plan.scratch_bytes,
                    chunks=len(plan.chunks), torch_mm_nvh_ms=f"{mm_ms:.4f}")

            def sweep(kernel: bool):
                c = torch.empty((plan.rows, plan.v_pad), device=dev, dtype=torch.bfloat16)
                for s0, r in plan.chunks:
                    sl = slice(s0, s0 + r)
                    part = (h[sl], w, labels[sl], ref_lse[sl], g_lse[sl], g_lab[sl], plan.v_pad)
                    if kernel:
                        fc.ce_coeff(*part, out=c[:r])
                    else:
                        c[:r] = fc.ce_coeff_plain(*part)
                return c

            timed = {
                "ce_fwd": (lambda: fc.ce_fwd(h, w, labels),
                           lambda: fc.ce_fwd_plain(h, w, labels), stat_err,
                           "xtuner_tpu/ops/fused_ce.py:47"),
                # the sweep of one backward, chunk by chunk (the kernel's
                # part of #9 and #10 that computes the logits)
                "ce_coeff": (lambda: sweep(True), lambda: sweep(False),
                             c_abs, "xtuner_tpu/ops/fused_ce.py:98"),
                "ce_dh": (lambda: fc.ce_dh(*args), lambda: fc.ce_dh_plain(*args), dh_abs,
                          "xtuner_tpu/ops/fused_ce.py:98"),
                "ce_dw": (lambda: fc.ce_dw(*args), lambda: fc.ce_dw_plain(*args), dw_abs,
                          "xtuner_tpu/ops/fused_ce.py:123"),
            }
            for name, (kern, plain, err, replaces) in timed.items():
                ms, peak = _peak_ms(torch, kern)
                pms, ppeak = _peak_ms(torch, plain)
                flops = 2 * n * v * hd * (2 if name in ("ce_dh", "ce_dw") else 1)
                say("kernel", name=name, shape=shape, cotangents=cot, err=f"{err:.3e}",
                    ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", tflops=f"{flops / ms / 1e9:.1f}",
                    peak_gib=f"{peak:.3f}", plain_peak_gib=f"{ppeak:.3f}")
                if name == "ce_fwd" and path is not None:
                    # beside the forward: its parent's time, its bound, and
                    # a tuned GEMM over the same N x V x H product (the
                    # backward's row chunks; f32 logits, the port never
                    # calls it)
                    mm_ms = cuda_ms(lambda: [torch.mm(h[s0:s0 + r], w.T, out_dtype=torch.float32)
                                             for s0, r in plan.chunks], iters=3, warmup=1)
                    say("kernel", name="ce_fwd", shape=shape, ms=f"{ms:.4f}",
                        parent_ms_perf_md=PARENT_MS[("ce_fwd", path)],
                        bound_ms=f"{flops / PEAK_BF16 * 1e3:.3f}",
                        share_of_bound=f"{flops / PEAK_BF16 * 1e3 / ms:.3f}",
                        torch_mm_nvh_ms=f"{mm_ms:.4f}")
                if path is not None:
                    ins = 2 * n * hd + 2 * v * hd + 4 * n  # h, w, labels
                    nbytes = {"ce_fwd": ins + 8 * n,  # lse, label logit out
                              "ce_coeff": ins + 12 * n + 2 * n * plan.v_pad,  # c out
                              "ce_dh": ins + 12 * n + 2 * n * hd,  # lse, g_lse, g_lab; dh
                              "ce_dw": ins + 12 * n + 2 * v * hd}[name]
                    rows.append({"name": name, "route": "cuda",
                                 "source": "xtuner_tpu_torch/csrc/fused_ce.cu",
                                 "replaces": replaces, "path": path, "max_abs_err": err,
                                 "ms": ms, "plain_ms": pms,
                                 **least_ms(flops, nbytes, PEAK_BF16),
                                 # no one PyTorch call computes lse and the label
                                 # logit, or their gradients, without the (N, V)
                                 # logits: library none
                                 "library_ms": None})
        del h, w, labels, g_lse, g_lab, g_lse_all, g_lab_all, lse, lab, ref_lse, ref_lab, args
    return rows


def phase_moe_heavy_kernels(torch, seed: int) -> list[dict]:
    """The train step's flash and grouped kernels at the new shapes the
    moe_heavy step gives them: flash (max-free forward, dq, dk/dv) at B2
    L8192 with 16/8 heads (GQA group 2) and the grouped GEMMs at 16
    experts, M = 16384 x top-8."""
    import numpy as np

    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)
    rows = []

    # ---- flash at B2 L8192 Hq16 Hkv8: forward (max-free), dq, dk/dv
    b, l, hq, hkv, d = SFT_ROWS, SEQ, 16, 8, 128
    seg = torch.cat([_segments(torch, doc_lengths(rng, l, 4, int(rng.integers(50, 300))),
                               l, dev) for _ in range(b)])

    def normed(hh):
        x = torch.randn((b, l, hh, d), generator=g, device=dev)
        return (x * (d ** 0.5) / x.norm(dim=-1, keepdim=True)).bfloat16()

    q, k = normed(hq), normed(hkv)
    v = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
    bound = torch.tensor(d ** 0.5, device=dev)
    scale = d ** -0.5
    out, lse = fl.flash_attention(q, k, v, seg, max_logit=bound)
    ref_out, ref_lse = fl.flash_attention_plain(q, k, v, seg, scale, max_free=True)
    valid = seg != 0
    out_err = _abs(out[valid], ref_out[valid])
    lse_t = lse.transpose(1, 2)
    lse_err = _abs(lse_t[valid], ref_lse.transpose(1, 2)[valid])
    pad_ok = bool((out[~valid] == 0).all()) and \
        bool((lse_t[~valid] == torch.tensor(fl.BIG_LSE, dtype=torch.float32)).all())
    del ref_out, ref_lse, lse_t
    do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, scale)
    got, ref = fl.flash_bwd(*args), fl.flash_bwd_plain(*args)
    bwd_errs = [_abs(t, w) for t, w in zip(got, ref)]
    bwd_rels = [_rel(t, w) for t, w in zip(got, ref)]
    bwd_pad_ok = all(bool((t[~valid] == 0).all()) for t in got)
    del got, ref
    f_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=5)
    f_plain = cuda_ms(lambda: fl.flash_attention_plain(q, k, v, seg, scale, max_free=True),
                      iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: fl.flash_bwd(*args), iters=5)
    bwd_plain = cuda_ms(lambda: fl.flash_bwd_plain(*args), iters=2, warmup=1)
    shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}"
    pairs = causal_pairs(torch, seg)
    bwd_b = bwd_bound(q, k, pairs)
    lib_fwd, why_fwd = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg))
    say("kernel", name="flash_fwd_max_free", shape=shape, out_err=f"{out_err:.3e}",
        lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, ms=f"{f_ms:.4f}",
        plain_ms=f"{f_plain:.4f}", **fwd_numbers(torch, q, k, v, seg, bound, f_ms, lib_fwd))
    say("kernel", name="flash_bwd", shape=shape,
        dq_dk_dv_err=",".join(f"{e:.3e}" for e in bwd_errs),
        dq_dk_dv_rel=",".join(f"{r_:.3e}" for r_ in bwd_rels), pad_rows_ok=bwd_pad_ok,
        ms=f"{bwd_ms:.4f}", plain_ms=f"{bwd_plain:.4f}", bound_ms=f"{bwd_b['bound_ms']:.4f}",
        tflops=f"{10 * pairs * hq * d / bwd_ms / 1e9:.1f}")
    lib_bwd, why_bwd = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg), do)
    say("kernel", name="library", shape=shape, sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
        why=repr(f"{why_fwd}; {why_bwd}"))
    if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok
            and max(bwd_rels) <= FLASH_GRAD_RTOL and bwd_pad_ok):
        raise AssertionError(f"flash kernels disagree at {shape}: out {out_err} "
                             f"(<= {FLASH_OUT_ATOL}), lse {lse_err} (<= {FLASH_LSE_ATOL}), "
                             f"padding rows ok {pad_ok}, {bwd_pad_ok}, dq, dk, dv {bwd_rels} "
                             f"(<= {FLASH_GRAD_RTOL})")
    src = "xtuner_tpu_torch/csrc/"
    rows += [{"name": "flash_fwd_max_free", "route": "cuda", "source": src + "flash_fwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "sft",
              "max_abs_err": max(out_err, lse_err), "ms": f_ms, "plain_ms": f_plain,
              **least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16), "library_ms": lib_fwd}]
    rows += bwd_rows("sft", {"max_abs_err": max(bwd_errs), "ms": bwd_ms, "plain_ms": bwd_plain,
                             **bwd_b, "library_ms": lib_bwd})
    del q, k, v, do, out, lse, delta, args

    # ---- grouped GEMMs at E16, M = 16384 x top-8, gate|up K1024/N1536 and
    # down K768/N1024
    e, hid, f = 16, 1024, 768
    m = SFT_ROWS * SEQ * 8
    sizes = torch.tensor(rng.multinomial(m, rng.dirichlet(np.full(e, 2.0))),
                         dtype=torch.int32, device=dev)
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    rows += grouped_rows(torch, "sft", grouped_cases(
        x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e), m, e, iters=5, plain_iters=3)
    del x, w_gu, w_dn, hmid, dy_gu, dy_dn
    fl.reset_launches()
    return rows


def routed_sizes(torch, rng, tokens: int, experts: int, topk: int, empty: int, dev):
    """(E,) int32 group sizes of a top-k routing of `tokens` random router
    logits over `experts`, expert `empty` given no token."""
    logits = torch.tensor(rng.standard_normal((tokens, experts)), dtype=torch.float32)
    logits[:, empty] = float("-inf")
    idx = logits.topk(topk, dim=-1).indices.flatten()
    return torch.bincount(idx, minlength=experts).to(torch.int32).to(dev)


def phase_fp8_kernels(torch, seed: int) -> list[dict]:
    """The fp8 kernels (#11-#13) against their plain versions, at every
    moe_heavy shape of the fp8 SFT step (M = 2 x 8192 rows for the
    attention projections; 131072 routed rows over 16 experts, group sizes
    from a top-8 routing with one expert empty), in e4m3 x e4m3 and with an
    e5m2 gradient, and at odd shapes (M not a multiple of 128, K = 768 and
    384, a 1-row expert, rows past the last group). Prints per GEMM the
    kernel's ms (the wrapper, its K-major copies included; timed rows also
    the launch alone on operands already in its layout), the plain
    version's, TFLOP/s, the bound, the error against plain (relative to the
    largest entry) and the mean relative error of the fp8 product against
    the unquantised bf16 one; and what `torch._scaled_mm` /
    `torch._scaled_grouped_mm` say to tile-wise scales."""
    import numpy as np

    from xtuner_tpu_torch.ops import fp8_gemm as fg
    from xtuner_tpu_torch.ops import fp8_grouped as fgr
    from xtuner_tpu_torch.ops.bf16_grouped import (_mm_f32, grouped_gemm_dw_plain,
                                                   grouped_gemm_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    rng = np.random.default_rng(seed + 4)
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    tag = {e4: "e4m3", e5: "e5m2"}
    src = "xtuner_tpu_torch/csrc/"
    rows = {
        "fp8_gemm": {"name": "fp8_gemm", "route": "cuda", "source": src + "fp8_gemm.cu",
                     "replaces": "xtuner_tpu/ops/fp8_gemm.py:60"},
        "fp8_grouped_gemm": {"name": "fp8_grouped_gemm", "route": "cuda",
                             "source": src + "fp8_grouped.cu",
                             "replaces": "xtuner_tpu/ops/fp8_grouped.py:106"},
        "fp8_grouped_dw": {"name": "fp8_grouped_dw", "route": "cuda",
                           "source": src + "fp8_grouped.cu",
                           "replaces": "xtuner_tpu/ops/fp8_grouped.py:195"},
    }
    for r in rows.values():
        r.update(path="sft_fp8", max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)

    def add_library(name, label, uses, fn):
        """Time the PyTorch call that would compute the same function, `uses`
        times into the row; None (with PyTorch's reason) where it refuses."""
        ms, why = library_ms(torch, fn)
        say("kernel", name=name, gemm=label, library_ms=ms, why=repr(why))
        row = rows[name]
        row["library_ms"] = None if ms is None or row["library_ms"] is None \
            else row["library_ms"] + uses * ms

    alone_ms = {name: 0.0 for name in rows}  # the launches alone, uses-weighted

    def check(name, label, got, want, ref, rtol, uses=0, timed=None, flops=0, nbytes=0):
        """Hold a kernel's result against its plain version; with `uses`,
        time it and add `uses` times its ms and bound to the kernel's row.
        `timed` is (wrapper, plain) or (wrapper, plain, the launch alone on
        operands already in the kernel's layout)."""
        torch.cuda.synchronize()
        err, rel = _abs(got, want), _rel(got, want)
        vs_bf16 = ((got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()
        kv = {}
        if uses:
            kern, plain, *alone = timed
            ms, pms = cuda_ms(kern, iters=5), cuda_ms(plain, iters=2, warmup=1)
            b = least_ms(flops, nbytes, PEAK_FP8)
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += uses * ms
            row["plain_ms"] += uses * pms
            for _ in range(uses):
                add_bound(row, b)
            kv = dict(uses=uses, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
                      tflops=f"{flops / ms / 1e9:.1f}", plain_tflops=f"{flops / pms / 1e9:.1f}",
                      bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
                      share_of_bound=f"{b['bound_ms'] / ms:.3f}")
            if alone:
                ams = cuda_ms(alone[0], iters=5)
                alone_ms[name] += uses * ams
                kv.update(kernel_ms=f"{ams:.4f}", kernel_tflops=f"{flops / ams / 1e9:.1f}",
                          kernel_share_of_bound=f"{b['bound_ms'] / ams:.3f}")
        say("kernel", name=name, gemm=label, err=f"{err:.3e}", rel=f"{rel:.3e}",
            mean_rel_vs_bf16=f"{vs_bf16:.4f}", **kv)
        if not (rel <= rtol and vs_bf16 <= FP8_VS_BF16_MEAN):
            raise AssertionError(f"{name} {label}: {rel} against its plain version (<= {rtol}), "
                                 f"{vs_bf16} mean against bf16 (<= {FP8_VS_BF16_MEAN})")

    def operands(m, k, n, a_dt=e4, b_dt=e4, e=None):
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        w = (torch.randn((k, n) if e is None else (e, k, n), generator=g, device=dev)
             * 0.02).bfloat16()
        xq, sx = fg.quantize_tilewise(x, dtype=a_dt)
        wq, sw = (fg.quantize_blockwise(w, dtype=b_dt) if e is None
                  else fgr.quantize_blockwise_stack(w, dtype=b_dt))
        return x, w, xq, sx, wq, sw

    # ---- #11 at the four attention projections (q, k, v, o), M = 16384
    m_att = SFT_ROWS * SEQ
    for label, m, k, n, a_dt, b_dt, uses in (
            ("q", m_att, 1024, 2048, e4, e4, 1), ("k", m_att, 1024, 1024, e4, e4, 1),
            ("v", m_att, 1024, 1024, e4, e4, 1), ("o", m_att, 2048, 1024, e4, e4, 1),
            ("q dgrad, e5m2 gradient", m_att, 2048, 1024, e5, e4, 0),
            ("q wgrad, e5m2 gradient", 1024, m_att, 2048, e4, e5, 0),
            ("odd M200 K768", 200, 768, 256, e4, e4, 0),
            ("odd M77 K384", 77, 384, 128, e5, e4, 0)):
        x, w, xq, sx, wq, sw = operands(m, k, n, a_dt, b_dt)
        kern = lambda: fg.fp8_gemm_tilewise(xq, sx, wq, sw)  # noqa: E731
        plain = lambda: fg.fp8_gemm_tilewise_plain(xq, sx, wq, sw, out_dtype=torch.float32)  # noqa
        wt = fg.k_major(wq).view(wq.dtype)  # the launch alone: W laid out K-major beforehand
        alone = lambda: fg.fp8_gemm_launch(xq, sx, wt, sw)  # noqa: E731
        kt, nt = k // 128, n // 128
        n0 = fg.fp8_gemm_tilewise.launches
        got = kern()
        if not torch.equal(got, alone()):
            raise AssertionError(f"fp8_gemm {label}: two launches give different bits")
        if fg.fp8_gemm_tilewise.launches != n0 + 2:
            raise AssertionError(f"fp8_gemm {label}: two launches counted "
                                 f"{fg.fp8_gemm_tilewise.launches - n0}")
        check("fp8_gemm", f"{label} {tag[a_dt]}x{tag[b_dt]} M{m} K{k} N{n}", got, plain(),
              _mm_f32(x, w), FP8_RTOL, uses, (kern, plain, alone), 2 * m * k * n,
              m * k + 4 * m * kt + k * n + 4 * kt * nt + 2 * m * n)
        if uses:
            # torch._scaled_mm with tile-wise scales, both outer-dim-major, as it takes them
            wt8 = wt.view(e4)
            add_library("fp8_gemm", f"{label}: torch._scaled_mm", uses, lambda: torch._scaled_mm(
                xq, wt8.t(), scale_a=sx.t().contiguous().t(), scale_b=sw.t().contiguous().t(),
                out_dtype=torch.bfloat16))
        del x, w, xq, sx, wq, sw, wt, got

    # ---- #12 and #13 at the expert GEMMs: 131072 routed rows, E16, top-8;
    # then odd shapes: every expert start offset inside a 128-row tile with
    # an empty first and last expert and 1-row experts, experts of exactly
    # 128 aligned rows, M below one tile
    e = 16
    m_moe = m_att * 8
    sizes = routed_sizes(torch, rng, m_att, e, 8, empty=5, dev=dev)
    say("kernel", name="fp8_grouped", rows=m_moe, experts=e, group_sizes=sizes.tolist())
    bounds = [0, 1, 14, 1, 1, 110, 300, 0]

    def same_walk_twice(name, kind, first, second, gs, m, k, n):
        """Two launches give the same bits and walk `fp8_plan_counts` each."""
        walked = fgr.fp8_grouped_walked()[kind]
        plan = tuple(2 * c for c in fgr.fp8_plan_counts(gs, m, kind, k, n))
        if walked != plan or not torch.equal(first, second):
            raise AssertionError(f"{name}: two launches walked {walked} (plan {plan}), "
                                 f"same bits: {torch.equal(first, second)}")
        return dict(walked=walked, plan=plan)

    for label, m, k, n, gs, a_dt, uses in (
            # gate and up forward, down's dgrad: K1024 -> N768
            ("gate/up fwd, down dgrad", m_moe, 1024, 768, sizes, e4, 3),
            # down forward, gate's and up's dgrad: K768 -> N1024
            ("down fwd, gate/up dgrad", m_moe, 768, 1024, sizes, e4, 3),
            ("gate/up dgrad, e5m2 gradient", m_moe, 768, 1024, sizes, e5, 0),
            ("odd M700 K768", 700, 768, 256, [300, 1, 0, 333], e4, 0),
            ("odd M700 K768", 700, 768, 256, [300, 1, 0, 333], e5, 0),
            ("odd M1000 K384", 1000, 384, 128, [0, 1000, 0, 0], e4, 0),
            ("starts 0/1/15/16/17/127", 512, 1024, 256, bounds, e4, 0),
            ("starts 0/1/15/16/17/127", 512, 768, 384, bounds, e5, 0),
            ("128 aligned rows", 256, 256, 128, [128, 0, 128], e4, 0),
            ("M below a tile", 100, 512, 128, [0, 37, 1, 50, 0], e5, 0)):
        gs = torch.as_tensor(gs, dtype=torch.int32, device=dev)
        ee = gs.shape[0]
        x, w, xq, sx, wq, sw = operands(m, k, n, a_dt, e4, ee)
        kern = lambda: fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)  # noqa: E731
        plain = lambda: fgr.fp8_grouped_gemm_plain(xq, sx, wq, sw, gs,  # noqa: E731
                                                   out_dtype=torch.float32)
        wt = fg.k_major(wq).view(wq.dtype)  # the launch alone: W laid out K-major beforehand
        alone = lambda: fgr.fp8_grouped_gemm_launch(xq, sx, wt, sw, gs)  # noqa: E731
        kt, nt = k // 128, n // 128
        fgr.reset_launches()
        got = kern()
        walk = same_walk_twice("fp8_grouped_gemm", "gg", got, kern(), gs, m, k, n)
        if (got[int(gs.sum()):] != 0).any():
            raise AssertionError("fp8_grouped_gemm wrote rows past the last group")
        say("kernel", name="fp8_grouped_gemm", gemm=label, **walk)
        check("fp8_grouped_gemm", f"{label} {tag[a_dt]}xe4m3 M{m} K{k} N{n}", got, plain(),
              grouped_gemm_plain(x, w, gs, out_dtype=torch.float32), FP8_RTOL, uses,
              (kern, plain, alone), 2 * int(gs.sum()) * k * n,
              m * k + 4 * m * kt + ee * k * n + 4 * ee * kt * nt + 2 * m * n)
        if uses:
            wt8 = wt.view(e4)
            offs = torch.cumsum(gs, 0).to(torch.int32)
            add_library("fp8_grouped_gemm", f"{label}: torch._scaled_grouped_mm", uses,
                        lambda: torch._scaled_grouped_mm(xq, wt8.transpose(1, 2), sx, sw,
                                                         offs=offs, out_dtype=torch.bfloat16))
        del x, w, xq, sx, wq, sw, wt, got

    for label, m, k, n, gs, y_dt, uses in (
            ("gate/up wgrad", m_moe, 1024, 768, sizes, e4, 2),
            ("down wgrad", m_moe, 768, 1024, sizes, e4, 1),
            ("down wgrad, e5m2 gradient", m_moe, 768, 1024, sizes, e5, 0),
            ("odd M640 K768", 640, 768, 256, [300, 1, 0, 339], e5, 0),
            ("odd M1024 K384", 1024, 384, 128, [0, 0, 1000, 0], e4, 0),
            ("starts 0/1/15/16/17/127", 512, 1024, 256, bounds, e4, 0),
            ("starts 0/1/15/16/17/127", 512, 768, 384, bounds, e5, 0),
            ("128 aligned rows", 256, 256, 128, [128, 0, 128], e4, 0),
            ("M below a tile, padded", 128, 512, 128, [0, 37, 1, 50, 0], e5, 0)):
        gs = torch.as_tensor(gs, dtype=torch.int32, device=dev)
        ee = gs.shape[0]
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        dy = torch.randn((m, n), generator=g, device=dev).bfloat16()
        xq, sx = fgr.quantize_rowtile(x)
        yq, sy = fgr.quantize_rowtile(dy, dtype=y_dt)
        kern = lambda: fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, ee)  # noqa: E731
        plain = lambda: fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, gs, ee)  # noqa: E731
        # the launch alone: both operands laid out in row tiles beforehand
        xt, yt = fgr._row_tiles_k_major(xq, 128), fgr._row_tiles_k_major(yq, 128)
        alone = lambda: fgr.fp8_grouped_dw_launch(xt, sx, yt, sy, gs, ee)  # noqa: E731
        fgr.reset_launches()
        got = kern()
        walk = same_walk_twice("fp8_grouped_dw", "dw", got, kern(), gs, m, k, n)
        if any((got[i] != 0).any() for i in range(ee) if int(gs[i]) == 0):
            raise AssertionError("fp8_grouped_gemm_dw wrote an empty expert's dW")
        say("kernel", name="fp8_grouped_dw", gemm=label, **walk)
        check("fp8_grouped_dw", f"{label} e4m3x{tag[y_dt]} M{m} K{k} N{n}", got, plain(),
              grouped_gemm_dw_plain(x, dy, gs, ee), FP8_DW_RTOL, uses, (kern, plain, alone),
              2 * int(gs.sum()) * k * n, m * (k + n) + 8 * (m // 128) + 4 * ee * k * n)
        del x, dy, xq, sx, yq, sy, xt, yt, got
    say("kernel", name="fp8_grouped_dw",
        library=repr("none: no PyTorch call takes one fp8 scale per 128-row tile of a ragged "
                     "contraction"))
    rows["fp8_grouped_dw"]["library_ms"] = None
    for name in ("fp8_gemm", "fp8_grouped_gemm", "fp8_grouped_dw"):
        r = rows[name]
        r.update(kernel_ms=alone_ms[name], kernel_share_of_bound=r["bound_ms"] / alone_ms[name])
        say("kernel", name=name, per_layer_ms=f"{r['ms']:.4f}",
            per_layer_kernel_ms=f"{alone_ms[name]:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
            share_of_bound=f"{r['bound_ms'] / r['ms']:.3f}",
            kernel_share_of_bound=f"{r['bound_ms'] / alone_ms[name]:.3f}",
            parent_ms_perf_md=PARENT_MS[(name, "sft_fp8")])
    return list(rows.values())


def block_visible(torch, seg, block: int):
    """(B, nb, nb) bool: key block kb holds a key that some query of q-block
    qb may see (causal, same non-padding document), as the indexer's
    block maxima are finite exactly there."""
    b, l = seg.shape
    nb = l // block
    docs = int(seg.max()) + 1
    onehot = torch.nn.functional.one_hot(seg.long(), docs)[..., 1:]  # (B, L, docs)
    present = onehot.reshape(b, nb, block, docs - 1).amax(dim=2).float()  # (B, nb, docs)
    shared = (present @ present.transpose(1, 2)) > 0
    return shared & torch.ones((nb, nb), dtype=torch.bool, device=seg.device).tril()


def bs_dense_mask(torch, idx, seg, block: int):
    """(B, 1, L, L) bool: the visible pairs of a block selection, for SDPA
    (an empty slot gathers block 0 again, masked: accumulate, then > 0)."""
    from xtuner_tpu_torch.ops.attention.block_sparse import _visible

    b, l = seg.shape
    nq = l // block
    mask, kpos = _visible(idx, seg, block, True)  # (B, nq, block, S * block)
    allow = torch.zeros((b, l, l), dtype=torch.int32, device=seg.device)
    bi = torch.arange(b, device=seg.device)[:, None, None, None]
    rows = torch.arange(l, device=seg.device).reshape(1, nq, block, 1)
    allow.index_put_((bi, rows, kpos[:, :, None, :]), mask.int(), accumulate=True)
    return (allow > 0)[:, None]


def phase_dsa_kernels(torch, seed: int, smi: str) -> list[dict]:
    """#14 and #15 against their plain versions at GLM-5.2's shapes: B1,
    L16384, Hq = Hkv = 64 (MLA gives every head its own k), D = Dv = 256,
    blocks of 256, 8 slots per q-block, five documents and a padded tail,
    the selection from random block maxima through `select_from_blockmax`
    (minus the blocks no query of the q-block can see, as the indexer's
    maxima are -inf there): the synthetic selection, kept unchanged so
    that its times compare across versions of the kernels."""
    import numpy as np

    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    rng = np.random.default_rng(seed + 5)
    b, l, h, d, block, s = 1, DSA_SEQ, DSA_HEADS, DSA_DIM, DSA_BLOCK, DSA_SLOTS
    lens = doc_lengths(rng, l, 5, int(rng.integers(200, 600)))
    seg = _segments(torch, lens, l, dev)
    nb = l // block
    blockmax = torch.randn((b, nb, nb), generator=g, device=dev)
    blockmax = torch.where(block_visible(torch, seg, block), blockmax, float("-inf"))
    idx = bs.select_from_blockmax(blockmax, s)
    q = torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
    do = torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
    say("dsa_kernels", selection="synthetic", docs=",".join(map(str, lens)), pad=l - sum(lens))
    return bs_kernel_rows(torch, q, k, v, do, idx, seg, d ** -0.5, smi, "synthetic")


def bs_kernel_rows(torch, q, k, v, do, idx, seg, scale: float, smi: str,
                   selection: str) -> list[dict]:
    """#14 and #15 against their plain versions at one selection: out, lse
    and mass within FLASH_OUT_ATOL, FLASH_LSE_ATOL and BS_MASS_ATOL, the
    padding rows' out 0, lse 1e30 and mass 0, the gradients within
    FLASH_GRAD_RTOL, the same bits from a second launch of each; times,
    the bound on the visible pairs, and SDPA with the selection as a dense
    mask (the library time)."""
    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    b, l, h, d = q.shape
    s = idx.shape[-1]
    block = l // idx.shape[1]
    shape = f"B{b}xL{l}xH{h}xD{d}xDv{v.shape[-1]}xblock{block}xS{s}"
    out, lse, mass = bs.block_sparse_fwd(q, k, v, idx, seg, scale, block)
    again = bs.block_sparse_fwd(q, k, v, idx, seg, scale, block)
    fwd_same = all(torch.equal(a, b_) for a, b_ in zip((out, lse, mass), again))
    del again
    ref_out, ref_lse, ref_mass = bs.block_sparse_fwd_plain(q, k, v, idx, seg, scale, block)
    torch.cuda.synchronize()
    valid = seg[0] != 0
    out_err = _abs(out[:, valid], ref_out[:, valid])
    lse_err = _abs(lse[..., valid], ref_lse[..., valid])
    mass_err = _abs(mass[:, valid], ref_mass[:, valid])
    pad_ok = bool((out[:, ~valid] == 0).all()) and bool((mass[:, ~valid] == 0).all()) and \
        bool((lse[..., ~valid] == torch.tensor(bs.BIG_LSE, dtype=torch.float32)).all())
    del ref_out, ref_lse, ref_mass
    grads = bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale, block)
    bwd_same = all(torch.equal(a, b_) for a, b_ in
                   zip(grads, bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale, block)))
    refs = bs.block_sparse_bwd_plain(q, k, v, idx, seg, out, lse, do, scale, block)
    torch.cuda.synchronize()
    g_err = max(_abs(a, r_) for a, r_ in zip(grads, refs))
    g_rel = max(_rel(a, r_) for a, r_ in zip(grads, refs))
    del grads, refs
    fwd_ms = cuda_ms(lambda: bs.block_sparse_fwd(q, k, v, idx, seg, scale, block), iters=10)
    fwd_plain = cuda_ms(lambda: bs.block_sparse_fwd_plain(q, k, v, idx, seg, scale, block),
                        iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale,
                                                 block), iters=10)
    bwd_plain = cuda_ms(lambda: bs.block_sparse_bwd_plain(q, k, v, idx, seg, out, lse, do,
                                                          scale, block), iters=2, warmup=1)
    mask_g, _ = bs._visible(idx, seg, block, True)
    pairs = int(mask_g.sum())
    del mask_g
    valid_slots = int((idx >= 0).sum())
    causal_blocks = int(block_visible(torch, seg, block).sum())
    # the function's work: q k^T and p v forward; q k^T, do v^T, p^T do,
    # ds^T q and ds k backward; every input read once, every output written
    flops_fwd = 2 * pairs * h * (d + d)
    flops_bwd = 2 * pairs * h * (3 * d + 2 * d)
    io = 2 * b * l * h * d  # one (B, L, H, D) bf16 tensor
    bytes_fwd = 4 * io + 4 * b * h * l + 4 * b * l * h * s + 4 * idx.numel() + 4 * b * l
    bytes_bwd = 5 * io + 4 * b * h * l + 3 * io + 4 * idx.numel() + 4 * b * l
    mask = bs_dense_mask(torch, idx, seg, block)
    lib_fwd, why_fwd = sdpa_ms(torch, q, k, v, mask, iters=3)
    lib_bwd, why_bwd = sdpa_ms(torch, q, k, v, mask, do, iters=3)
    del mask
    b_fwd, b_bwd = least_ms(flops_fwd, bytes_fwd, PEAK_BF16), least_ms(flops_bwd, bytes_bwd,
                                                                        PEAK_BF16)
    say("dsa_kernels", selection=selection, shape=shape,
        valid_slots=f"{valid_slots}/{idx.numel()}", visible_blocks=causal_blocks,
        visible_pairs=pairs, card=repr(smi))
    say("kernel", name="block_sparse_fwd", selection=selection, shape=shape,
        out_err=f"{out_err:.3e}", lse_err=f"{lse_err:.3e}", mass_err=f"{mass_err:.3e}",
        pad_rows_ok=pad_ok, same_bits=fwd_same, ms=f"{fwd_ms:.4f}",
        plain_ms=f"{fwd_plain:.4f}", tflops=f"{flops_fwd / fwd_ms / 1e9:.1f}",
        bound_ms=f"{b_fwd['bound_ms']:.4f}", bound_by=b_fwd["bound_by"],
        share_of_bound=f"{b_fwd['bound_ms'] / fwd_ms:.3f}")
    say("kernel", name="block_sparse_bwd", selection=selection, shape=shape,
        err=f"{g_err:.3e}", rel=f"{g_rel:.3e}", same_bits=bwd_same, ms=f"{bwd_ms:.4f}",
        plain_ms=f"{bwd_plain:.4f}", tflops=f"{flops_bwd / bwd_ms / 1e9:.1f}",
        bound_ms=f"{b_bwd['bound_ms']:.4f}", bound_by=b_bwd["bound_by"],
        share_of_bound=f"{b_bwd['bound_ms'] / bwd_ms:.3f}")
    say("kernel", name="library", selection=selection, shape=shape,
        sdpa_masked_fwd_ms=lib_fwd, sdpa_masked_bwd_ms=lib_bwd,
        what=repr("SDPA with the selection as a dense (B, 1, L, L) mask: out only (no lse, "
                  "no mass); its backward gives dq, dk, dv"),
        why=repr(f"{why_fwd}; {why_bwd}"))
    if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and
            mass_err <= BS_MASS_ATOL and pad_ok and g_rel <= FLASH_GRAD_RTOL and fwd_same
            and bwd_same):
        raise AssertionError(f"block-sparse kernels disagree with their plain versions at "
                             f"{shape} ({selection} selection): out {out_err} (<= "
                             f"{FLASH_OUT_ATOL}), lse {lse_err} (<= {FLASH_LSE_ATOL}), mass "
                             f"{mass_err} (<= {BS_MASS_ATOL}), padding rows ok {pad_ok}, "
                             f"grads {g_rel} (<= {FLASH_GRAD_RTOL}), same bits on a second "
                             f"launch: forward {fwd_same}, backward {bwd_same}")
    bs.reset_launches()
    src = "xtuner_tpu_torch/csrc/block_sparse.cu"
    return [{"name": "block_sparse_fwd", "route": "cuda", "source": src,
             "replaces": "xtuner_tpu/ops/attention/block_sparse.py:70", "path": "glm52_dsa",
             "selection": selection, "max_abs_err": max(out_err, lse_err, mass_err),
             "ms": fwd_ms, "plain_ms": fwd_plain, **b_fwd, "library_ms": lib_fwd},
            {"name": "block_sparse_bwd", "route": "cuda", "source": src,
             "replaces": "xtuner_tpu/ops/attention/block_sparse.py:130", "path": "glm52_dsa",
             "selection": selection, "max_abs_err": g_err, "ms": bwd_ms,
             "plain_ms": bwd_plain, **b_bwd, "library_ms": lib_bwd}]


class first_call:
    """While on, records the arguments of the first call of
    `owner.<name>` ((args, kwargs)) and passes every call through; the
    attribute is put back on exit."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.args = owner, name, None

    def __enter__(self):
        self.fn = getattr(self.owner, self.name)

        def wrapped(*a, **kw):
            if self.args is None:
                self.args = (a, kw)
            return self.fn(*a, **kw)
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)
        return False


INDEXER = "indexer_fwd"
ADAMW = "adamw"


def phase_glm52_dsa(torch, seed: int, smi: str) -> tuple[dict, list[dict]]:
    """GLM-5.2's three dense head layers at full width through the recipe
    `recipes/sft_glm52_dsa_head.py`: `Trainer` builds the engine and the
    data plane from it in a temporary directory, then 4 `train_step`s on
    the recipe's own batches (not `fit`: its final save would write ~38 GB
    of params and Adam state). Then the indexer's forward and backward
    alone at the layer's shapes, and one profiled step, whose first
    block-sparse call (layer 0's forward) gives the selection and segment
    ids at which #14 and #15 are then checked and timed (random q, k, v,
    do of the layer's shapes). Returns the launches and those kernel rows."""
    import os
    import runpy
    import tempfile
    from pathlib import Path

    import numpy as np

    from xtuner_tpu_torch.module.params import count_params
    from xtuner_tpu_torch.ops.sparse_mla import indexer_block_stats
    from xtuner_tpu_torch.train.trainer import Trainer

    recipe = str(Path(__file__).resolve().parent / GLM_RECIPE)
    tcfg = runpy.run_path(recipe)["trainer"]
    tcfg.seed = seed
    cfg = tcfg.model_cfg
    attn = cfg.attention
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="xt_glm52_") as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            trainer = Trainer(tcfg)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        eng = trainer.engine
        n = eng.num_params
        say("glm52_dsa", recipe=GLM_RECIPE, params=n, layers=f"{cfg.num_hidden_layers}/78",
            reason=repr(f"the 3 dense head layers: one MoE layer (256 experts) alone needs "
                        f"155 GB of f32 state; these need 16 B x {n / 1e9:.3f} B = "
                        f"{16 * n / 1e9:.1f} GB"),
            hidden=cfg.hidden_size, heads=attn.num_attention_heads,
            qk=f"{attn.qk_nope_head_dim}+{attn.qk_rope_head_dim}", v=attn.v_head_dim,
            lora=f"q{attn.q_lora_rank}/kv{attn.kv_lora_rank}",
            indexer=f"{attn.index_n_heads}x{attn.index_head_dim}/top{attn.index_top_k}",
            block=attn.index_block, mlp=cfg.intermediate_size, vocab=cfg.vocab_size,
            ce=cfg.lm_loss_cfg.mode, remat=eng.remat, compute=str(eng.compute_dtype),
            init_s=f"{init_s:.3f}", state_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
        if n != count_params(cfg.build().param_specs()):
            raise AssertionError("the engine's parameter count is not the recipe's")
        data = iter(trainer.dataloader)
        batches = [next(data) for _ in range(GLM_STEPS)]
        trainer.close()
    for i, bt in enumerate(batches):
        segs = bt["segment_ids"][0, 0]
        vis = block_visible(torch, torch.as_tensor(np.asarray(segs))[None], attn.index_block)
        say("glm52_dsa", batch=i + 1, rows=bt["input_ids"].shape[1], seq=segs.shape[0],
            docs=int(segs.max()), tokens=int((segs != 0).sum()),
            supervised=int(bt["loss_weights"].sum()),
            visible_blocks_per_qblock=f"{vis.sum(-1).float().mean().item():.2f}")

    reset_train_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for step, bt in enumerate(batches, start=1):
        t0 = time.perf_counter()
        m = eng.train_step(bt, step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist.append((m, dt))
        say("glm52_dsa", step=step, loss=f"{m['reduced_llm_loss']:.5f}",
            dsa_index_loss=f"{m['dsa_index_loss']:.5f}", total_loss=f"{m['total_loss']:.5f}",
            grad_norm=f"{m['grad_norm']:.5f}", lr=f"{m['lr']:.3e}", skipped=m["skipped"],
            tokens=m["consumed_tokens"], step_ms=f"{1e3 * dt:.1f}",
            tok_s=f"{m['consumed_tokens'] / dt:.1f}", pos_s=f"{DSA_SEQ / dt:.1f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    launches = train_launches(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    layers = cfg.num_hidden_layers
    # per layer and step: #14 in the forward and again in the remat
    # recompute, #15 once; nothing else of the port's
    want = {name: 0 for name in launches}
    want.update(block_sparse_fwd=2 * layers * GLM_STEPS, block_sparse_bwd=layers * GLM_STEPS)
    steady = hist[1:]
    step_s = sum(dt for _, dt in steady) / len(steady)
    tokens = sum(m["consumed_tokens"] for m, _ in steady) / len(steady)
    say("glm52_dsa", launches={k: v for k, v in launches.items() if v or want[k]},
        expected={k: v for k, v in want.items() if v}, steady_step_ms=f"{1e3 * step_s:.1f}",
        steady_tok_s=f"{tokens / step_s:.1f}", steady_pos_s=f"{DSA_SEQ / step_s:.1f}",
        peak_gib=f"{peak:.3f}", card=repr(smi))
    losses = [m["reduced_llm_loss"] for m, _ in hist]
    idx_losses = [m["dsa_index_loss"] for m, _ in hist]
    norms = [m["grad_norm"] for m, _ in hist]
    if not all(np.isfinite(losses + idx_losses + norms)):
        raise AssertionError(f"non-finite loss, indexer loss or grad norm: {losses}, "
                             f"{idx_losses}, {norms}")
    if not GLM_LOSS1[0] <= losses[0] <= GLM_LOSS1[1]:
        raise AssertionError(f"step-1 CE {losses[0]} outside {GLM_LOSS1}")
    if not all(x > 0 for x in idx_losses):
        raise AssertionError(f"indexer loss {idx_losses} not positive")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"CE did not fall over {GLM_STEPS} steps: {losses}")
    if any(m["skipped"] for m, _ in hist):
        raise AssertionError("a step was skipped")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what {GLM_STEPS} steps imply {want}")
    if not peak < GLM_PEAK_GIB:
        raise AssertionError(f"peak {peak:.3f} GiB >= {GLM_PEAK_GIB}")

    # the indexer alone at the layer's shapes (plain torch, f32): forward,
    # and forward + backward; a step runs per layer two forwards (the
    # forward and the remat recompute) and one forward + backward
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    hi, di, block = attn.index_n_heads, attn.index_head_dim, attn.index_block
    segs = torch.as_tensor(np.asarray(batches[0]["segment_ids"][0])).cuda()
    q_idx = torch.randn((1, DSA_SEQ, hi, di), generator=g, device="cuda").bfloat16()
    k_idx = torch.randn((1, DSA_SEQ, 1, di), generator=g, device="cuda").bfloat16()
    w_idx = torch.randn((1, DSA_SEQ, hi), generator=g, device="cuda").bfloat16()
    k_b = k_idx.expand(1, DSA_SEQ, hi, di)
    with torch.no_grad():
        ix_fwd = cuda_ms(lambda: indexer_block_stats(q_idx, k_b, w_idx, segs, block), iters=3,
                         warmup=1)
    leaves = [t.clone().requires_grad_(True) for t in (q_idx, k_idx, w_idx)]

    def fwd_bwd():
        pooled, _ = indexer_block_stats(leaves[0], leaves[1].expand(1, DSA_SEQ, hi, di),
                                        leaves[2], segs, block)
        torch.where(torch.isfinite(pooled), pooled, 0.0).sum().backward()

    ix_fb = cuda_ms(fwd_bwd, iters=3, warmup=1)
    ix_flops = 2 * DSA_SEQ * DSA_SEQ * hi * di
    say("glm52_dsa", indexer_fwd_ms=f"{ix_fwd:.3f}", indexer_fwd_bwd_ms=f"{ix_fb:.3f}",
        per_step_ms=f"{layers * (2 * ix_fwd + ix_fb):.1f}",
        fwd_tflops=f"{ix_flops / ix_fwd / 1e9:.1f}",
        note=repr("plain torch f32 (no TF32): the q.k products over all L x L pairs of "
                  "each layer, causality masked after"))
    del q_idx, k_idx, w_idx, k_b, leaves

    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    targets = {INDEXER: [("xtuner_tpu_torch.module.dsa", "indexer_block_stats")],
               ADAMW: [("xtuner_tpu_torch.config.optim", "AdamW.step")]}
    with annotated(torch, targets), first_call(bs, "block_sparse_attention") as rec:
        profile_window(torch, "glm52_dsa_step",
                       lambda: eng.train_step(batches[0], GLM_STEPS + 1), top=16,
                       annotations=(INDEXER, ADAMW))
    (q0, k0, v0, idx, seg), kw = rec.args[0][:5], rec.args[1]
    idx, seg = idx.to(torch.int32).clone(), seg.to(torch.int32).clone()
    shape_q, dv = tuple(q0.shape), v0.shape[-1]
    scale = kw.get("scale") or shape_q[-1] ** -0.5
    del trainer, eng, rec, q0, k0, v0
    gc.collect()
    torch.cuda.empty_cache()
    say("glm52_dsa", selection="recipe", q=shape_q, dv=dv, block=kw["block"], scale=scale,
        valid_slots_per_qblock=f"{(idx >= 0).sum(-1).float().mean().item():.3f}")
    if kw["block"] != attn.index_block or shape_q != (1, DSA_SEQ, DSA_HEADS, DSA_DIM):
        raise AssertionError(f"layer 0's block-sparse call was {shape_q}, block {kw['block']}")
    g = torch.Generator(device="cuda").manual_seed(seed + 8)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in (shape_q, shape_q, (*shape_q[:3], dv), (*shape_q[:3], dv)))
    rows = bs_kernel_rows(torch, q, k, v, do, idx, seg, scale, smi, "recipe")
    return launches, rows


def phase_deepseek_mla(torch, seed: int, smi: str) -> tuple[dict, dict, object]:
    """DeepSeek-V3's three dense head layers at full width through the
    `sft` CLI: `main(["--config", recipes/sft_deepseek_v3_mla_head.py])` in
    a temporary directory, 4 steps on the recipe's own 16384-token rows and
    the final checkpoint. Its tracker (4 finite steps, step-1 CE in
    DEEPSEEK_LOSS1, a falling CE, none skipped), the committed checkpoint,
    peak memory, steady step ms and supervised tokens/s, and the exact
    launches: per layer and step the flash forward (#1) twice (the forward
    and the remat "full" recompute) and the grouped backward (#2 + #3) once,
    all at q/k dim 192 and v dim 128, and nothing else of the port's; one
    more step under the profiler, with the flash wrappers' device time and
    AdamW's apart. Then the recipe at 1 layer under remat "save_out_lse" and
    `XTUNER_ATTN_BWD=two_pass` (`TrainEngine`, DEEPSEEK_SOL_STEPS steps on
    the same rows): the flash forward once per layer and step (never
    re-run: the backward re-runs `mla_project`, not the attention) and the
    two-pass backward (#2 + #4) once. Returns both runs' launches and the
    segment ids (1, L) of the recipe's first row."""
    import dataclasses
    import os
    import runpy
    import tempfile
    from pathlib import Path
    from unittest import mock

    import numpy as np

    from xtuner_tpu_torch.checkpoint.torch_io import TrainCheckpointManager
    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.module.mla import mla_softmax_scale
    from xtuner_tpu_torch.module.params import count_params
    from xtuner_tpu_torch.train.cli import sft

    recipe = str(Path(__file__).resolve().parent / DEEPSEEK_RECIPE)
    save_s: list = []
    real_save = TrainCheckpointManager.save

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        real_save(self, *a, **kw)
        save_s.append(time.perf_counter() - t0)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="xt_deepseek_") as tmp:
        os.chdir(tmp)
        TrainCheckpointManager.save = timed_save
        try:
            reset_train_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = sft.main(["--config", recipe])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = train_launches(torch)
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            TrainCheckpointManager.save = real_save
            os.chdir(cwd)
        work = Path(tmp) / trainer.cfg.work_dir / trainer.cfg.exp_name
        recs = [json.loads(x) for x in (work / "tracker.jsonl").read_text().splitlines()]
        step_dir = work / "checkpoints" / f"step-{DEEPSEEK_STEPS}"
        committed = (step_dir / "train_state.json").exists()
        ckpt_gib = sum(p.stat().st_size for p in step_dir.iterdir()) / 2**30 \
            if step_dir.exists() else 0.0
        tcfg = trainer.cfg
        cfg, attn = tcfg.model_cfg, tcfg.model_cfg.attention
        n = trainer.engine.num_params
        data = iter(trainer.dataloader)
        batches = [next(data) for _ in range(DEEPSEEK_SOL_STEPS)]
        trainer.dataloader.close()
        engine_remat = trainer.engine.remat
        # one more step under the profiler: the flash kernels (#1, and #2 with
        # #3) and AdamW apart from the rest
        with annotated(torch, MLA_TARGETS):
            profile_window(torch, "deepseek_mla_step",
                           lambda: trainer.engine.train_step(batches[0], DEEPSEEK_STEPS + 1),
                           top=12, annotations=tuple(MLA_TARGETS))
        del trainer, data
    gc.collect()
    torch.cuda.empty_cache()
    rs = cfg.rope_scaling_cfg
    say("deepseek_mla", recipe=DEEPSEEK_RECIPE, params=n, layers=f"{cfg.num_hidden_layers}/61",
        reason=repr(f"the 3 dense head layers: one MoE layer (256 experts x 3 x 7168 x 2048) "
                    f"alone needs 180 GB of f32 state; these need 16 B x {n / 1e9:.3f} B = "
                    f"{16 * n / 1e9:.1f} GB"),
        hidden=cfg.hidden_size, heads=attn.num_attention_heads,
        qk=f"{attn.qk_nope_head_dim}+{attn.qk_rope_head_dim}", v=attn.v_head_dim,
        lora=f"q{attn.q_lora_rank}/kv{attn.kv_lora_rank}", mlp=cfg.intermediate_size,
        vocab=cfg.vocab_size, rope=f"{rs.rope_type} x{rs.factor} over "
                                   f"{rs.original_max_position_embeddings}",
        softmax_scale=f"{mla_softmax_scale(attn, rs):.6f}", ce=cfg.lm_loss_cfg.mode,
        remat=engine_remat, wall_s=f"{wall:.3f}")
    for r in recs:
        say("deepseek_mla", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", data_ms=f"{1e3 * r['data_time']:.2f}",
            skipped=int(r["skipped"]))
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    per = DEEPSEEK_STEPS * cfg.num_hidden_layers
    want = {name: 0 for name in launches}
    want.update(flash_fwd=2 * per, flash_bwd=per)
    say("deepseek_mla", launches={k: v for k, v in launches.items() if v or want[k]},
        expected={k: v for k, v in want.items() if v}, steady_step_ms=f"{1e3 * step_s:.1f}",
        steady_tgs=f"{tokens / step_s:.1f}", pack_positions_s=f"{MLA_SEQ / step_s:.1f}",
        peak_gib=f"{peak:.3f}", ckpt_committed=committed, ckpt_gib=f"{ckpt_gib:.3f}",
        save_s=",".join(f"{x:.3f}" for x in save_s), card=repr(smi))
    losses = [r["reduced_llm_loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    if n != DEEPSEEK_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"{n} params, not the recipe's {DEEPSEEK_PARAMS}")
    if [r["step"] for r in recs] != list(range(1, DEEPSEEK_STEPS + 1)):
        raise AssertionError(f"tracker.jsonl has steps {[r['step'] for r in recs]}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    if not DEEPSEEK_LOSS1[0] <= losses[0] <= DEEPSEEK_LOSS1[1]:
        raise AssertionError(f"step-1 CE {losses[0]} outside {DEEPSEEK_LOSS1}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"CE did not fall over {DEEPSEEK_STEPS} steps: {losses}")
    if any(r["skipped"] for r in recs):
        raise AssertionError("a step was skipped")
    if not committed:
        raise AssertionError(f"no committed checkpoint at {step_dir}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what {DEEPSEEK_STEPS} steps "
                             f"imply {want}")
    if not peak < DEEPSEEK_PEAK_GIB:
        raise AssertionError(f"peak {peak:.3f} GiB >= {DEEPSEEK_PEAK_GIB}")

    # remat "save_out_lse" at 1 layer, under the two-pass backward
    one = dataclasses.replace(cfg, num_hidden_layers=1)
    mesh = dataclasses.replace(tcfg.mesh_cfg, remat_policy="save_out_lse")
    eng = TrainEngine(one, tcfg.optim_cfg, tcfg.lr_cfg, mesh, DEEPSEEK_SOL_STEPS)
    eng.init_random(seed)
    with mock.patch.dict(os.environ, {"XTUNER_ATTN_BWD": "two_pass"}):
        reset_train_launches()
        sol = [eng.train_step(bt, step) for step, bt in enumerate(batches, start=1)]
        torch.cuda.synchronize()
        sol_launches = train_launches(torch)
    del eng
    sol_want = {name: 0 for name in sol_launches}
    sol_want.update(flash_fwd=DEEPSEEK_SOL_STEPS, flash_bwd_two_pass=DEEPSEEK_SOL_STEPS)
    sol_losses = [m["reduced_llm_loss"] for m in sol]
    say("deepseek_mla", run="save_out_lse", layers=1, remat=mesh.remat_policy,
        switches=repr({"attn_bwd": "two_pass"}),
        losses=",".join(f"{x:.5f}" for x in sol_losses),
        launches={k: v for k, v in sol_launches.items() if v or sol_want[k]},
        expected={k: v for k, v in sol_want.items() if v})
    if not all(np.isfinite(sol_losses)) or sol_launches != sol_want:
        raise AssertionError(f"the save_out_lse run: losses {sol_losses}, launches "
                             f"{sol_launches} != {sol_want}")
    seg = torch.as_tensor(np.asarray(batches[0]["segment_ids"][0])).to(torch.int32)
    return launches, sol_launches, seg


# the deepseek_mla profile's own kinds: the flash forward's wrapper, the
# backward's (delta, the padding, the tile table and the kernels) and the
# optimizer. Wrappers whose body reads a counter off its own name
# (`flash_bwd.launches`) cannot be swapped for a plain wrapper
MLA_TARGETS = {"flash_fwd": [("xtuner_tpu_torch.ops.attention.flash", "flash_forward")],
               "flash_bwd": [("xtuner_tpu_torch.ops.attention.flash", "flash_backward")],
               ADAMW: [("xtuner_tpu_torch.config.optim", "AdamW.step")]}


def sdpa_any_ms(torch, q, k, v, mask, do=None):
    """`sdpa_ms` under each fused SDPA backend in turn (cuDNN, flash,
    memory-efficient; never the math one, which holds the (L, L) scores):
    (ms, backend, how) for the first that takes v's head dim, else the
    same with v (and do) zero-padded to q's head dim, else (None, None,
    why)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    whys = []
    for pad in (False, True):
        vv, dd = v, do
        if pad:
            grow = q.shape[-1] - v.shape[-1]
            vv = torch.nn.functional.pad(v, (0, grow))
            dd = None if do is None else torch.nn.functional.pad(do, (0, grow))
        for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            with sdpa_kernel(backend):
                ms, why = sdpa_ms(torch, q, k, vv, mask, dd, iters=3)
            if ms is not None:
                return ms, backend.name, f"v zero-padded to {q.shape[-1]}" if pad else \
                    f"v at {v.shape[-1]}"
            whys.append(f"{backend.name}{' (padded v)' if pad else ''}: {why}")
    return None, None, "; ".join(whys)


def phase_mla_kernels(torch, seed: int, smi: str, recipe_seg) -> list[dict]:
    """#1-#4 at MLA's q/k dim 192 and v dim 128 (DeepSeek-V3's 128 heads,
    B1 L16384) against their plain versions, at documents of MLA_DOCS
    tokens and at the recipe's own packed row (`recipe_seg`, from the
    deepseek_mla phase): the forward's out and lse (the running-max variant
    the path runs) and the k tiles it walks against `fwd_tile_plan`; both
    backward variants' dq, dk and dv (per q head when two-pass), each output
    the same bits over two launches. The plain versions run in
    PLAIN_CHUNK-row chunks (`flash_plain_chunked`: the unchunked ones hold
    (Hq, L, L) f32 scores, 137 GB here). Times from CUDA events; bounds on
    the documents' causal triangles, 2 (D + Dv) flops a pair forward and
    2 (3 D + 2 Dv) backward; the library time is SDPA with the documents'
    block-causal mask, under the first fused backend that takes v's head
    dim, or with v zero-padded to 192 (the row says which)."""
    from xtuner_tpu_torch.model.deepseek import deepseek_v3
    from xtuner_tpu_torch.module.mla import mla_softmax_scale
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    src = "xtuner_tpu_torch/csrc/"
    b, l, h, d, dv = 1, MLA_SEQ, MLA_HEADS, MLA_D, MLA_DV
    ds = deepseek_v3()
    scale = mla_softmax_scale(ds.attention, ds.rope_scaling_cfg)  # 0.1352
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, X) -> (H, L, X)
    rows = []
    for label, seg in (("docs", _segments(torch, MLA_DOCS, l, dev)),
                       ("recipe", recipe_seg.to(dev))):
        q, k = (torch.randn((b, l, h, d), generator=g, device=dev).bfloat16() for _ in "qk")
        v, do = (torch.randn((b, l, h, dv), generator=g, device=dev).bfloat16() for _ in "vd")
        pairs = causal_pairs(torch, seg)
        shape = f"B{b}xL{l}xHq{h}xHkv{h}xD{d}xDv{dv}"
        docs = int(seg.max())
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg, scale=scale)
        torch.cuda.synchronize()
        if fl.flash_attention.launches != 1 or fl.max_free_launches() != 0:
            raise AssertionError("the MLA forward did not launch the running-max kernel once")
        (ref_out, ref_lse), fwd_plain = timed_once(torch, lambda: flash_plain_chunked(
            torch, q, k, v, seg, None, None, None, scale, "fwd"))
        valid = seg[0] != 0
        fwd_rel = _rel_rows(heads_first(out)[:, valid], ref_out[:, valid])
        fwd_err = _abs(heads_first(out)[:, valid], ref_out[:, valid])
        lse_err = _abs(lse[0][:, valid], ref_lse[:, valid])
        pad_ok = bool((out[0][~valid] == 0).all())
        del ref_out, ref_lse
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, seg, lse, delta, do, scale)
        ref_dq, dq_plain = timed_once(torch, lambda: flash_plain_chunked(torch, *args, "dq"))
        (ref_dk, ref_dv), dkv_plain = timed_once(torch, lambda: flash_plain_chunked(
            torch, *args, "dkv"))
        res = {}
        for two_pass in (False, True):
            got = fl.flash_bwd(*args, two_pass)
            again = fl.flash_bwd(*args, two_pass)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            hf = [heads_first(t) for t in got]
            res[two_pass] = ([_rel_rows(t[:, valid], w[:, valid])
                              for t, w in zip(hf, (ref_dq, ref_dk, ref_dv))],
                             max(_abs(t[:, valid], w[:, valid])
                                 for t, w in zip(hf, (ref_dq, ref_dk, ref_dv))),
                             same, all(bool((t[0][~valid] == 0).all()) for t in got))
            del got, hf
        del ref_dq, ref_dk, ref_dv
        fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, scale=scale), iters=5)
        gr_ms = cuda_ms(lambda: fl.flash_bwd(*args), iters=5)
        tp_ms = cuda_ms(lambda: fl.flash_bwd(*args, True), iters=5)
        mask = block_causal_mask(torch, seg)
        lib_fwd, backend_fwd, how_fwd = sdpa_any_ms(torch, q, k, v, mask)
        lib_bwd, backend_bwd, how_bwd = sdpa_any_ms(torch, q, k, v, mask, do)
        del mask
        nums = fwd_numbers(torch, q, k, v, seg, None, fwd_ms, lib_fwd)
        fwd_b = least_ms(2 * pairs * h * (d + dv), flash_bytes(q, k, dv=dv), PEAK_BF16)
        gr_b, tp_b = bwd_bound(q, k, pairs, dv=dv), bwd_bound(q, k, pairs, True, dv=dv)
        say("kernel", name="flash_fwd", dims=f"{d}/{dv}", shape=shape, seq=label, docs=docs,
            pairs=pairs, err=f"{fwd_err:.3e}", out_rel=f"{fwd_rel:.3e}",
            lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, ms=f"{fwd_ms:.4f}",
            plain_ms=f"{fwd_plain:.1f}", sdpa_backend=backend_fwd, sdpa_how=repr(how_fwd),
            card=repr(smi), **nums)
        for two_pass, ms, bnd in ((False, gr_ms, gr_b), (True, tp_ms, tp_b)):
            rels, err, same, zero = res[two_pass]
            say("kernel", name="flash_bwd_two_pass" if two_pass else "flash_bwd",
                dims=f"{d}/{dv}", shape=shape, seq=label,
                dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels), err=f"{err:.3e}",
                same_bits=same, pad_rows_ok=zero, ms=f"{ms:.4f}",
                plain_ms=f"{dq_plain + dkv_plain:.1f}", bound_ms=f"{bnd['bound_ms']:.4f}",
                share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
                tflops=f"{2 * (3 * d + 2 * dv) * pairs * h / ms / 1e9:.1f}",
                sdpa_bwd_ms=lib_bwd, sdpa_backend=backend_bwd, sdpa_how=repr(how_bwd),
                card=repr(smi))
        worst = max(max(res[False][0]), max(res[True][0]))
        if not (fwd_rel <= FLASH_GRAD_RTOL and lse_err <= FLASH_LSE_ATOL and pad_ok and
                worst <= FLASH_GRAD_RTOL and all(r[2] and r[3] for r in res.values())):
            raise AssertionError(f"the MLA flash kernels disagree at {shape} ({label}): out "
                                 f"{fwd_rel}, lse {lse_err}, backward {res} (<= "
                                 f"{FLASH_GRAD_RTOL}; two launches the same bits; padding "
                                 f"rows zero)")
        plain_note = f"the plain version in {PLAIN_CHUNK}-row chunks (its (L, L) scores " \
                     f"do not fit)"
        common = {"route": "cuda", "dims": [d, dv], "seq": label, "shape": shape,
                  "plain_is": plain_note}
        rows.append({"name": "flash_fwd", "source": src + "flash_fwd.cu",
                     "function": f"flash_fwd_kernel<{d}, {dv}>",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "deepseek_mla",
                     "max_abs_err": max(fwd_err, lse_err), "ms": fwd_ms, "plain_ms": fwd_plain,
                     **fwd_b, "library_ms": lib_fwd, "library_is": f"SDPA {backend_fwd}, "
                                                                   f"{how_fwd}", **common})
        for two_pass, ms, bnd in ((False, gr_ms, gr_b), (True, tp_ms, tp_b)):
            for line in (199, 249 if two_pass else 303):
                rows.append({
                    "name": "flash_bwd_two_pass" if two_pass else "flash_bwd",
                    "source": src + "flash_bwd.cu",
                    "function": f"flash_dq_kernel<{d}, {dv}> + flash_dkv_kernel<{d}, {dv}, "
                                f"{'two_pass' if two_pass else 'grouped'}>",
                    "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}",
                    "path": "deepseek_mla_save_out_lse" if two_pass else "deepseek_mla",
                    "max_abs_err": res[two_pass][1], "ms": ms,
                    "plain_ms": dq_plain + dkv_plain, **bnd, "library_ms": lib_bwd,
                    "library_is": f"SDPA backward {backend_bwd}, {how_bwd}", **common})
        del q, k, v, do, out, lse, delta, args
        gc.collect()
        torch.cuda.empty_cache()
    fl.reset_launches()
    return rows


def fit_recipe(torch, rel_recipe: str, steps=None, hooks=(), env=None, cwd=None):
    """`Trainer.fit` on a recipe loaded as the `sft` CLI loads it
    (`config_from_args`), in a temporary working directory (or `cwd`,
    where a recipe's `load_from` was written), with `hooks` added, `steps`
    in place of the recipe's total when given and `env` set for the run;
    the final save is skipped (`Trainer._save` is a no-op here: these runs
    are measured, not resumed). -> (trainer, its tracker records, every
    kernel's launches, peak GiB, wall s)."""
    import dataclasses
    import os
    import tempfile
    from pathlib import Path
    from unittest import mock

    from xtuner_tpu_torch.train.cli import sft
    from xtuner_tpu_torch.train.trainer import Trainer

    recipe = str(Path(__file__).resolve().parent / rel_recipe)
    cfg = sft.config_from_args(sft.build_parser().parse_args(["--config", recipe]))
    cfg = dataclasses.replace(cfg, hooks=[*cfg.hooks, *hooks],
                              total_steps=steps or cfg.total_steps)
    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="xt_fit_") as tmp, \
            mock.patch.dict(os.environ, env or {}), \
            mock.patch.object(Trainer, "_save", lambda self, step, mgr=None: None):
        os.chdir(cwd or tmp)
        try:
            reset_train_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = Trainer(cfg)
            trainer.fit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = train_launches(torch)
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = [json.loads(x) for x in
                    (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]
        finally:
            os.chdir(here)
    return trainer, recs, launches, peak, wall


class StepProbe:
    """A `TrainerHook`: after each step, a copy of the trunk's noaux
    correction bias (`moe_layers`), the step's expert loads by stack
    (`TrainEngine.last_expert_load`) and its metrics."""

    def __init__(self):
        self.rows: list = []

    def after_train_step(self, trainer, step: int, metrics: dict) -> None:
        eng = trainer.engine
        bias = eng.params["moe_layers"]["router"]["e_score_correction_bias"].detach().clone()
        self.rows.append((step, bias, {k: v.clone() for k, v in eng.last_expert_load.items()},
                          dict(metrics)))

    def after_save_checkpoint(self, trainer, step: int) -> None:
        pass


def check_fit(phase: str, recs: list, steps: int, loss1: tuple) -> list:
    """The tracker of a `fit_recipe` run: `steps` steps, finite losses and
    grad norms, step-1 CE inside `loss1`, a falling CE, none skipped ->
    the CE per step."""
    import numpy as np

    losses = [r["reduced_llm_loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    if [r["step"] for r in recs] != list(range(1, steps + 1)):
        raise AssertionError(f"{phase}: tracker.jsonl has steps {[r['step'] for r in recs]}")
    if not all(np.isfinite(losses + norms + [r["total_loss"] for r in recs])):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: {losses}, {norms}")
    if not loss1[0] <= losses[0] <= loss1[1]:
        raise AssertionError(f"{phase}: step-1 CE {losses[0]} outside {loss1}")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: CE did not fall over {steps} steps: {losses}")
    if any(r["skipped"] for r in recs):
        raise AssertionError(f"{phase}: a step was skipped")
    return losses


def phase_glm45_air_head(torch, seed: int, smi: str) -> tuple[dict, dict, object]:
    """GLM-4.5-Air's dense layer and first MoE layer at full width
    (`recipes/sft_glm45_air_head.py`, 3.827 B params: 96/8 heads with qkv
    bias, 128 experts top-8 of width 1408 behind the noaux router, a shared
    expert) through `Trainer.fit`: 4 steps on the recipe's own 8192-token
    rows, no final save (`fit_recipe`). Per step: step ms, supervised
    tokens/s, `maxvio`, the trunk's correction-bias range and peak memory;
    after step 1 every bias entry must have moved by exactly
    `bias_update_speed` against the sign of its expert's load minus the
    mean (0 where equal); CE finite and falling; the exact launches (per
    layer and step the flash forward (#1, running max: no qk-norm) twice
    under remat "full" and the grouped backward (#2 + #3, a q-head group of
    12) once; per step of the MoE layer the grouped nn 4, nt 2, dw 2);
    peak below the card's memory; one more step under the profiler, the
    flash kernels and AdamW apart. Then a 1-step run under
    `XTUNER_FUSED_MLP=1` (#16 forward and recompute in place of the nn
    GEMMs): its step-1 CE and total loss within SWITCHED_LOSS_ATOL of the
    first run's. Returns both runs' launches and the segment ids (1, L) of
    the recipe's first row."""
    from xtuner_tpu_torch.module.params import count_params

    probe = StepProbe()
    trainer, recs, launches, peak, wall = fit_recipe(torch, GLM45_RECIPE, hooks=[probe])
    cfg, attn = trainer.cfg.model_cfg, trainer.cfg.model_cfg.attention
    n = trainer.engine.num_params
    speed = cfg.router.bias_update_speed
    batch = next(iter(trainer.dataloader))
    trainer.dataloader.close()
    seg = torch.as_tensor(batch["segment_ids"][0]).to(torch.int32)
    remat = trainer.engine.remat
    # one more step under the profiler: the flash kernels and AdamW apart
    # from the rest (the grouped GEMMs are the port's other kernels)
    with annotated(torch, MLA_TARGETS):
        profile_window(torch, "glm45_air_head_step",
                       lambda: trainer.engine.train_step(batch, GLM45_STEPS + 1), top=12,
                       annotations=tuple(MLA_TARGETS))
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    say("glm45_air_head", recipe=GLM45_RECIPE, params=n,
        layers=f"{cfg.num_hidden_layers}/46 (dense {cfg.first_k_dense_replace}, MoE "
               f"{cfg.num_hidden_layers - cfg.first_k_dense_replace}), mtp 0/1",
        reason=repr(f"16 B x {n / 1e9:.3f} B = {16 * n / 1e9:.1f} GB of f32 state; every "
                    f"further MoE layer adds 2.34 B params (37.5 GB), the MTP block is one"),
        hidden=cfg.hidden_size,
        heads=f"{attn.num_attention_heads}/{attn.num_key_value_heads}",
        qkv_bias=attn.qkv_bias, experts=f"{cfg.n_routed_experts}/top{cfg.num_experts_per_tok}",
        moe_inter=cfg.moe_intermediate_size, shared=cfg.n_shared_experts,
        router=f"{cfg.router.router_type} speed {speed}", vocab=cfg.vocab_size,
        ce=cfg.lm_loss_cfg.mode, remat=remat, wall_s=f"{wall:.3f}", save="skipped")
    bias_moves = None
    for (step, bias, load, m), r in zip(probe.rows, recs):
        say("glm45_air_head", step=step, loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", maxvio=f"{m['maxvio']:.4f}",
            bias_min=f"{bias.min().item():.6f}", bias_max=f"{bias.max().item():.6f}",
            skipped=int(r["skipped"]), peak_gib=f"{peak:.3f}")
        if step == 1:
            trunk = load["moe_layers"]
            want = (speed * torch.sign(trunk.mean(dim=-1, keepdim=True) - trunk)).float()
            exact = torch.equal(bias, want)
            bias_moves = (int((bias > 0).sum()), int((bias < 0).sum()), int((bias == 0).sum()))
            say("glm45_air_head", after_step=1, bias_exact=exact,
                up_down_still=",".join(map(str, bias_moves)),
                load_min_max_mean=f"{int(trunk.min())},{int(trunk.max())},"
                                  f"{trunk.mean().item():.1f}")
            if not exact:
                raise AssertionError(f"the correction bias after step 1 is not "
                                     f"+-{speed} x sign(mean - load): {bias} against {want}")
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    per = GLM45_STEPS * cfg.num_hidden_layers
    moe = GLM45_STEPS * (cfg.num_hidden_layers - cfg.first_k_dense_replace)
    want = {name: 0 for name in launches}
    want.update(flash_fwd=2 * per, flash_bwd=per, grouped_gemm_nn=4 * moe,
                grouped_gemm_nt=2 * moe, grouped_gemm_dw=2 * moe)
    say("glm45_air_head", launches={k: v for k, v in launches.items() if v or want[k]},
        expected={k: v for k, v in want.items() if v}, steady_step_ms=f"{1e3 * step_s:.1f}",
        steady_tgs=f"{tokens / step_s:.1f}", pack_positions_s=f"{SEQ / step_s:.1f}",
        peak_gib=f"{peak:.3f}", card_gib=f"{card_gib:.3f}", card=repr(smi))
    losses = check_fit("glm45_air_head", recs, GLM45_STEPS, GLM45_LOSS1)
    if n != GLM45_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"{n} params, not the recipe's {GLM45_PARAMS}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what {GLM45_STEPS} steps "
                             f"imply {want}")
    if not peak < card_gib or bias_moves is None:
        raise AssertionError(f"peak {peak:.3f} GiB >= the card's {card_gib:.3f}, or no "
                             f"bias after step 1")

    # the same recipe, seed and data, one step under the fused expert MLP
    trainer, frecs, flaunches, fpeak, _ = fit_recipe(torch, GLM45_RECIPE, steps=1,
                                                     env={"XTUNER_FUSED_MLP": "1"})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    moe1 = cfg.num_hidden_layers - cfg.first_k_dense_replace
    fwant = {name: 0 for name in flaunches}
    fwant.update(flash_fwd=2 * cfg.num_hidden_layers, flash_bwd=cfg.num_hidden_layers,
                 fused_moe_mlp=2 * moe1, grouped_gemm_nt=2 * moe1, grouped_gemm_dw=2 * moe1)
    diffs = [abs(frecs[0][k] - recs[0][k]) for k in ("reduced_llm_loss", "total_loss")]
    say("glm45_air_head", run="fused_mlp", switches=repr({"fused_mlp": "1"}),
        loss1=f"{frecs[0]['reduced_llm_loss']:.5f}", decomposed_loss1=f"{losses[0]:.5f}",
        total1=f"{frecs[0]['total_loss']:.5f}", decomposed_total1=f"{recs[0]['total_loss']:.5f}",
        max_abs_diff=f"{max(diffs):.3e}", tol=SWITCHED_LOSS_ATOL,
        step_ms=f"{1e3 * frecs[0]['step_time']:.1f}", peak_gib=f"{fpeak:.3f}",
        launches={k: v for k, v in flaunches.items() if v or fwant[k]},
        expected={k: v for k, v in fwant.items() if v})
    if not max(diffs) <= SWITCHED_LOSS_ATOL:
        raise AssertionError(f"the fused-MLP run's step-1 losses differ from the decomposed "
                             f"run's by {diffs} (> {SWITCHED_LOSS_ATOL})")
    if flaunches != fwant:
        raise AssertionError(f"the fused-MLP run's launches {flaunches} != {fwant}")
    return launches, flaunches, seg


def sdpa_or_none(torch, q, k, v, mask, do=None):
    """`sdpa_any_ms`, or (None, None, why) where the backward's own forward
    call already refuses."""
    try:
        return sdpa_any_ms(torch, q, k, v, mask, do)
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, None, f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"


def phase_glm45_kernels(torch, seed: int, smi: str, recipe_seg) -> list[dict]:
    """The kernels of the glm45_air_head path against their plain versions
    at the shapes it gives them. #1 (running max) and the grouped backward
    (#2 + #3) at B1 L8192 with 96 q heads over 8 kv heads (a group of 12),
    D 128, on five documents and a padded tail and on the recipe's own row,
    against the plain versions in PLAIN_CHUNK-row chunks
    (`flash_plain_chunked`; dk and dv summed over each group), whether two
    backward launches give the same bits (printed), the forward's walk
    against its plan, SDPA with the documents' mask as the library time.
    The bf16 grouped GEMMs (#6 nn and nt, #7) at E128 H4096 F1408 (gate|up
    N 2816, down K 1408), M = 8192 x top-8 with the group sizes of the
    noaux router's own top-8 route (`noaux_route` on rms-1 rows and
    router weights of std 0.02), against their plain versions and
    `torch._grouped_mm`. #16 forward and backward at the same shapes,
    against its plain version, two launches the same bits, its walk
    against `fused_mlp_plan_counts`, beside the decomposed path and
    `torch._grouped_mm` twice."""
    import numpy as np

    from xtuner_tpu_torch.model.glm import glm_45_air
    from xtuner_tpu_torch.module.router import noaux_route
    from xtuner_tpu_torch.ops import fused_moe_mlp as fm
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.ops.bf16_grouped import grouped_gemm_bf16

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    src = "xtuner_tpu_torch/csrc/"
    air = glm_45_air()
    b, l = 1, SEQ
    hq, hkv = air.attention.num_attention_heads, air.attention.num_key_value_heads
    d = air.attention.head_dim
    rep, scale = hq // hkv, d ** -0.5
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, X) -> (H, L, X)
    path = "glm45_air_head"
    rows = []
    docs_seg = _segments(torch, doc_lengths(rng, l, 5, int(rng.integers(100, 400))), l, dev)
    for label, seg in (("docs", docs_seg), ("recipe", recipe_seg.to(dev))):
        q = torch.randn((b, l, hq, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16() for _ in "kv")
        do = torch.randn((b, l, hq, d), generator=g, device=dev).bfloat16()
        pairs = causal_pairs(torch, seg)
        shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}"
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg)
        torch.cuda.synchronize()
        if fl.flash_attention.launches != 1 or fl.max_free_launches() != 0:
            raise AssertionError("the GLM-4.5-Air forward did not launch the running-max "
                                 "kernel once")
        (ref_out, ref_lse), fwd_plain = timed_once(torch, lambda: flash_plain_chunked(
            torch, q, k, v, seg, None, None, None, scale, "fwd"))
        valid = seg[0] != 0
        fwd_rel = _rel_rows(heads_first(out)[:, valid], ref_out[:, valid])
        fwd_err = _abs(heads_first(out)[:, valid], ref_out[:, valid])
        lse_err = _abs(lse[0][:, valid], ref_lse[:, valid])
        pad_ok = bool((out[0][~valid] == 0).all())
        del ref_out, ref_lse
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, seg, lse, delta, do, scale)
        ref_dq, dq_plain = timed_once(torch, lambda: flash_plain_chunked(torch, *args, "dq"))
        (ref_dk, ref_dv), dkv_plain = timed_once(torch, lambda: flash_plain_chunked(
            torch, *args, "dkv"))
        ref_dk, ref_dv = (t.reshape(hkv, rep, l, d).sum(1) for t in (ref_dk, ref_dv))
        got = fl.flash_bwd(*args)
        again = fl.flash_bwd(*args)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        hf = [heads_first(t) for t in got]
        bwd_rels = [_rel_rows(t[:, valid], w[:, valid])
                    for t, w in zip(hf, (ref_dq, ref_dk, ref_dv))]
        bwd_err = max(_abs(t[:, valid], w[:, valid]) for t, w in zip(hf, (ref_dq, ref_dk, ref_dv)))
        zero = all(bool((t[0][~valid] == 0).all()) for t in got)
        del got, hf, ref_dq, ref_dk, ref_dv
        fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg), iters=5)
        bwd_ms = cuda_ms(lambda: fl.flash_bwd(*args), iters=5)
        mask = block_causal_mask(torch, seg)
        lib_fwd, backend_fwd, how_fwd = sdpa_or_none(torch, q, k, v, mask)
        lib_bwd, backend_bwd, how_bwd = sdpa_or_none(torch, q, k, v, mask, do)
        del mask
        nums = fwd_numbers(torch, q, k, v, seg, None, fwd_ms, lib_fwd)
        fwd_b = least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16)
        bwd_b = bwd_bound(q, k, pairs)
        say("kernel", name="flash_fwd", shape=shape, group=rep, seq=label,
            docs=int(seg.max()), pairs=pairs, err=f"{fwd_err:.3e}", out_rel=f"{fwd_rel:.3e}",
            lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, ms=f"{fwd_ms:.4f}",
            plain_ms=f"{fwd_plain:.1f}", sdpa_backend=backend_fwd, sdpa_how=repr(how_fwd),
            card=repr(smi), **nums)
        say("kernel", name="flash_bwd", shape=shape, group=rep, seq=label,
            dq_dk_dv_rel=",".join(f"{x:.3e}" for x in bwd_rels), err=f"{bwd_err:.3e}",
            same_bits=same, pad_rows_ok=zero, ms=f"{bwd_ms:.4f}",
            plain_ms=f"{dq_plain + dkv_plain:.1f}", bound_ms=f"{bwd_b['bound_ms']:.4f}",
            share_of_bound=f"{bwd_b['bound_ms'] / bwd_ms:.3f}",
            tflops=f"{10 * pairs * hq * d / bwd_ms / 1e9:.1f}", sdpa_bwd_ms=lib_bwd,
            sdpa_backend=backend_bwd, sdpa_how=repr(how_bwd), card=repr(smi))
        # `same_bits` is printed, not required: at 128/128 the one-pass
        # backward adds dq into an f32 buffer by bulk reduce-add from each
        # k tile's CTA, in whatever order the CTAs finish
        if not (fwd_rel <= FLASH_GRAD_RTOL and lse_err <= FLASH_LSE_ATOL and pad_ok and
                max(bwd_rels) <= FLASH_GRAD_RTOL and zero):
            raise AssertionError(f"the flash kernels disagree at {shape} ({label}): out "
                                 f"{fwd_rel}, lse {lse_err}, dq/dk/dv {bwd_rels} (<= "
                                 f"{FLASH_GRAD_RTOL}); padding rows zero {pad_ok}, {zero}")
        common = {"route": "cuda", "seq": label, "shape": shape,
                  "plain_is": f"the plain version in {PLAIN_CHUNK}-row chunks"}
        rows.append({"name": "flash_fwd", "source": src + "flash_fwd.cu",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": path,
                     "max_abs_err": max(fwd_err, lse_err), "ms": fwd_ms, "plain_ms": fwd_plain,
                     **fwd_b, "library_ms": lib_fwd,
                     "library_is": f"SDPA {backend_fwd}, {how_fwd}", **common})
        for r in bwd_rows(path, {"max_abs_err": bwd_err, "ms": bwd_ms,
                                 "plain_ms": dq_plain + dkv_plain, **bwd_b,
                                 "library_ms": lib_bwd}):
            rows.append({**r, **common, "library_is": f"SDPA backward {backend_bwd}, "
                                                      f"{how_bwd}"})
        del q, k, v, do, out, lse, delta, args
        gc.collect()
        torch.cuda.empty_cache()

    # ---- the MoE layer's grouped GEMMs and #16 at E128 H4096 F1408, sizes
    # from the noaux router's own top-8 route of 8192 tokens
    e, hid, f, topk = (air.n_routed_experts, air.hidden_size, air.moe_intermediate_size,
                       air.num_experts_per_tok)
    tok = torch.randn((SEQ, hid), generator=g, device=dev)
    router = {"w": torch.randn((hid, e), generator=g, device=dev) * 0.02,
              "e_score_correction_bias": torch.zeros(e, device=dev)}
    idx = noaux_route(router, air.router, tok, topk).topk_idx
    sizes = torch.bincount(idx.flatten(), minlength=e).to(torch.int32)
    del tok, router, idx
    m = SEQ * topk
    say("kernel", name="noaux_route_sizes", experts=e, rows=m,
        min_max=f"{int(sizes.min())},{int(sizes.max())}", empty=int((sizes == 0).sum()))
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    rows += grouped_rows(torch, path, grouped_cases(
        x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e), m, e, iters=5, plain_iters=2)
    del hmid, dy_gu, dy_dn

    fm.reset_launches()
    out, gu = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes)
    out2, gu2 = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes)
    repeat = torch.equal(out, out2) and torch.equal(gu, gu2)
    del out2, gu2
    walked = fm.fused_mlp_tiles_walked()
    plan = tuple(2 * c for c in fm.fused_mlp_plan_counts(sizes, m, hid, f))
    ref_out, ref_gu = fm.fused_moe_mlp_plain(x, w_gu, w_dn, sizes)
    torch.cuda.synchronize()
    err = max(_abs(out, ref_out), _abs(gu, ref_gu))
    rel = max(_rel(out, ref_out), _rel(gu, ref_gu))
    del out, gu, ref_out, ref_gu
    co = torch.randn((m, hid), generator=g, device=dev)
    grads = []
    for fn, dtype in ((fm.fused_moe_mlp, torch.bfloat16),
                      (lambda *a: fm.fused_moe_mlp_plain(*a)[0], torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (x, w_gu, w_dn)]
        (fn(*leaves, sizes).float() * co).sum().backward()
        grads.append([t.grad for t in leaves])
        del leaves
    g_rel = max(_rel(a, r_) for a, r_ in zip(*grads))
    del grads, co
    gc.collect()
    torch.cuda.empty_cache()
    shape = f"M{m}xE{e}xH{hid}xF{f}"
    ms = cuda_ms(lambda: fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes), iters=5)
    plain = cuda_ms(lambda: fm.fused_moe_mlp_plain(x, w_gu, w_dn, sizes), iters=2, warmup=1)

    def decomposed():
        gu_ = grouped_gemm_bf16(x, w_gu, sizes)
        mid = (torch.nn.functional.silu(gu_[:, :f].float()) * gu_[:, f:].float()).bfloat16()
        return grouped_gemm_bf16(mid, w_dn, sizes)

    dec_ms = cuda_ms(decomposed, iters=5)
    offs = torch.cumsum(sizes, 0).to(torch.int32)

    def grouped_mm_pair():
        gu_ = torch._grouped_mm(x, w_gu, offs=offs)
        mid = (torch.nn.functional.silu(gu_[:, :f].float()) * gu_[:, f:].float()).bfloat16()
        return torch._grouped_mm(mid, w_dn, offs=offs)

    pair_ms, pair_why = library_ms(torch, grouped_mm_pair)
    flops = 6 * m * hid * f
    nbytes = 2 * m * hid * 2 + 2 * m * 2 * f + 2 * e * hid * 2 * f + 2 * e * f * hid
    bound = least_ms(flops, nbytes, PEAK_BF16)
    say("kernel", name="fused_moe_mlp", shape=shape, empty=int((sizes == 0).sum()),
        out_gu_err=f"{err:.3e}", out_gu_rel=f"{rel:.3e}", grad_rel=f"{g_rel:.3e}",
        bitwise_repeat=repeat, walked=walked, plan=plan, ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}", decomposed_ms=f"{dec_ms:.4f}", grouped_mm_pair_ms=pair_ms,
        why=repr(pair_why), tflops=f"{flops / ms / 1e9:.1f}",
        bound_ms=f"{bound['bound_ms']:.4f}", bound_by=bound["bound_by"],
        share_of_bound=f"{bound['bound_ms'] / ms:.3f}", card=repr(smi))
    if not (rel <= GG_RTOL and g_rel <= GG_RTOL and repeat and walked == plan):
        raise AssertionError(f"fused_moe_mlp disagrees with its plain version at {shape}: "
                             f"out/gu {rel}, grads {g_rel} (<= {GG_RTOL}), two launches "
                             f"the same bits {repeat}, walked {walked} against {plan}")
    rows.append({"name": "fused_moe_mlp", "route": "cuda", "source": src + "fused_moe_mlp.cu",
                 "replaces": "xtuner_tpu/ops/fused_moe_mlp.py:48", "path": path + "_fused",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain, **bound,
                 # no one PyTorch call fuses the two GEMMs and the activation
                 "library_ms": None})
    del x, w_gu, w_dn
    reset_train_launches()
    return rows


def phase_moe_heavy_mtp(torch, smi: str, sft_loss1: float) -> dict:
    """`recipes/sft_moe_heavy_mtp.py` (the sft recipe with one MTP layer)
    through `Trainer.fit`, 6 steps, no final save (`fit_recipe`): per step
    the trunk's CE, `mtp_loss` and step ms; the trunk's step-1 CE equal to
    the sft phase's `sft_loss1` within MTP_CE1_RTOL (the same trunk
    weights, seed and data: MTP does not change the trunk's forward);
    `mtp_loss` finite and positive; the exact launches: per step the 10
    trunk layers and the MTP layer each run flash (max-free) once and the
    grouped backward once, nn 4, nt 2 and dw 2, and the fused CE twice (the
    trunk's and the MTP depth's)."""
    import numpy as np

    trainer, recs, launches, peak, wall = fit_recipe(torch, MTP_RECIPE)
    cfg = trainer.cfg.model_cfg
    n = trainer.engine.num_params
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    say("moe_heavy_mtp", recipe=MTP_RECIPE, params=n, layers=cfg.num_hidden_layers,
        mtp_layers=cfg.mtp_num_layers, mtp_loss_coef=cfg.mtp_loss_coef,
        ce=cfg.lm_loss_cfg.mode, wall_s=f"{wall:.3f}", save="skipped")
    for r in recs:
        say("moe_heavy_mtp", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            mtp_loss=f"{r['mtp_loss']:.5f}", total_loss=f"{r['total_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", maxvio=f"{r['maxvio']:.4f}",
            step_ms=f"{1e3 * r['step_time']:.1f}", tgs=f"{r['tgs']:.1f}",
            skipped=int(r["skipped"]))
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    layers = cfg.num_hidden_layers + cfg.mtp_num_layers
    per = SFT_STEPS * layers
    want = {name: 0 for name in launches}
    want.update(flash_fwd_max_free=per, flash_bwd=per, grouped_gemm_nn=4 * per,
                grouped_gemm_nt=2 * per, grouped_gemm_dw=2 * per, ce_fwd=2 * SFT_STEPS,
                ce_coeff=2 * SFT_STEPS * ce_chunks(SFT_ROWS * SEQ, cfg.vocab_size),
                ce_dh=2 * SFT_STEPS, ce_dw=2 * SFT_STEPS)
    rel = abs(recs[0]["reduced_llm_loss"] - sft_loss1) / sft_loss1
    say("moe_heavy_mtp", launches={k: v for k, v in launches.items() if v or want[k]},
        expected={k: v for k, v in want.items() if v}, steady_step_ms=f"{1e3 * step_s:.1f}",
        peak_gib=f"{peak:.3f}", ce1=f"{recs[0]['reduced_llm_loss']:.6f}",
        sft_ce1=f"{sft_loss1:.6f}", ce1_rel=f"{rel:.3e}", tol=MTP_CE1_RTOL, card=repr(smi))
    check_fit("moe_heavy_mtp", recs, SFT_STEPS, SFT_LOSS1)
    mtp = [r["mtp_loss"] for r in recs]
    if not (all(np.isfinite(mtp)) and min(mtp) > 0):
        raise AssertionError(f"mtp_loss {mtp}")
    if not rel <= MTP_CE1_RTOL:
        raise AssertionError(f"the trunk's step-1 CE {recs[0]['reduced_llm_loss']} is not the "
                             f"sft phase's {sft_loss1} (relative {rel} > {MTP_CE1_RTOL})")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what {SFT_STEPS} steps imply "
                             f"{want}")
    return launches


def switch_state() -> dict:
    """The dk/dv path and the fused-MLP switch as the port reads them
    (bench.py records the first as `attn_bwd`)."""
    import os

    from xtuner_tpu_torch.ops.attention.flash import attn_bwd

    return {"attn_bwd": attn_bwd(), "fused_mlp": os.environ.get("XTUNER_FUSED_MLP", "0")}


def sdpa_causal_ms(torch, q, k, v, do=None, iters: int = 3):
    """`scaled_dot_product_attention` with `is_causal=True` on one document,
    k and v repeated to the q heads so that its flash backend takes it (a
    mask would send it to a path that holds the (L, L) scores): the
    forward, or with `do` the backward (dq, dk and dv in one call)."""
    import torch.nn.functional as F

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(rep, dim=2),
                                               v.repeat_interleave(rep, dim=2)))
    if do is None:
        return library_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                        is_causal=True), iters)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    dot = do.transpose(1, 2)
    return library_ms(torch, lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True),
                      iters)


def timed_once(torch, fn):
    """(fn(), its CUDA-event ms) for a call too slow to repeat."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def _rel_rows(got, want, chunk: int = PLAIN_CHUNK) -> float:
    """The largest `_rel` over chunks of `chunk` positions along dim 1 of
    (H, L, D) tensors: along one long document the entries shrink by
    orders of magnitude, so one scale for the whole row would hide the
    late rows."""
    return max(_rel(got[:, i:i + chunk], want[:, i:i + chunk])
               for i in range(0, got.shape[1], chunk))


def flash_plain_chunked(torch, q, k, v, seg, lse, delta, do, scale: float, want: str,
                        chunk: int = PLAIN_CHUNK, causal: bool = True):
    """The plain flash forward or backward of one packed row (B = 1) at a
    length whose (L, L) scores do not fit the card: the same f32 math as
    the plain versions in `ops/attention/flash.py`, over q rows in chunks
    of `chunk`, each against the keys up to its last row (all keys when
    not `causal`; a (Hq, chunk, L) f32 slab at most: 4.3 GB at Hq16
    L65536). A row that sees no key (padding) gets out 0 and lse 1e30.

    want "fwd": (out, lse) (Hq, L, Dv) and (Hq, L); "dq": dq (Hq, L, D) from
    the given lse and delta (B, Hq, L), the dq kernel's inputs; "dkv":
    (dk_h scaled, dv_h), (Hq, L, D) and (Hq, L, Dv) per q head, from the
    same inputs as the two-pass kernel. Dv is v's head dim."""
    l, hq = q.shape[1], q.shape[2]
    rep = hq // k.shape[2]
    heads_first = lambda t: t[0].float().transpose(0, 1).contiguous()  # (H, L, D)
    qs = heads_first(q)
    ks, vs = (heads_first(t).repeat_interleave(rep, dim=0) for t in (k, v))
    dos = None if do is None else heads_first(do)
    pos, sg = torch.arange(l, device=q.device), seg[0]
    res = {"fwd": [torch.zeros_like(vs)], "dq": [torch.zeros_like(qs)],
           "dkv": [torch.zeros_like(qs), torch.zeros_like(vs)]}[want]
    lse_out = torch.empty((hq, l), device=q.device)
    for r0 in range(0, l, chunk):
        r1 = min(r0 + chunk, l)
        rows, m1 = slice(r0, r1), r1 if causal else l
        s = torch.matmul(qs[:, rows], ks[:, :m1].transpose(1, 2)).mul_(scale)  # (Hq, r, m)
        mask = (sg[None, :m1] == sg[rows, None]) & (sg[rows, None] != 0)
        if causal:
            mask &= pos[None, :m1] <= pos[rows, None]
        if want == "fwd":
            s.masked_fill_(~mask, float("-inf"))
            lse_r = torch.logsumexp(s, dim=-1)
            lse_r = torch.where(torch.isfinite(lse_r), lse_r, torch.full_like(lse_r, 1e30))
            lse_out[:, rows] = lse_r
            res[0][:, rows] = torch.matmul(s.sub_(lse_r[..., None]).exp_(), vs[:, :m1])
            continue
        p = s.sub_(lse[0][:, rows, None]).exp_().masked_fill_(~mask, 0.0)
        ds = torch.matmul(dos[:, rows], vs[:, :m1].transpose(1, 2))
        ds.sub_(delta[0][:, rows, None]).mul_(p)
        if want == "dq":
            res[0][:, rows] = torch.matmul(ds, ks[:, :m1]).mul_(scale)
        else:
            res[0][:, :m1] += torch.matmul(ds.transpose(1, 2), qs[:, rows]).mul_(scale)
            res[1][:, :m1] += torch.matmul(p.transpose(1, 2), dos[:, rows])
        del s, p, ds
    if want == "fwd":
        return res[0], lse_out
    return res[0] if want == "dq" else tuple(res)


def phase_longctx_kernels(torch, seed: int, smi: str) -> list[dict]:
    """The two-pass flash backward (#2 + #4) and #16 (the fused MoE MLP)
    against their plain versions at the shapes their paths give them: the
    backward at moe_heavy's flash shapes (B2 L8192 Hq16/8, 4 documents per
    row and a padded tail), beside the grouped one; at the longctx row's B1
    L65536 Hq16/8 on one document, #1's out and lse and both backward
    instantiations' dq, dk and dv (dk_h and dv_h per q head for two-pass)
    against the plain versions run in `PLAIN_CHUNK`-row chunks
    (`flash_plain_chunked`; the unchunked ones hold (L, L) scores); #16's
    forward and backward at the longctx row's M 262144 E64 H1024 F128 and
    moe_heavy's M131072 E16 F768, routed sizes with an empty expert, at
    an odd M and at F1536 (timed, on no path); two launches must give the
    same bits and walk `fused_mlp_plan_counts`'s tiles and chunks. Times
    from CUDA events, bounds, SDPA's causal backward at L65536 as the
    backward's library time; #16 has no library call (none fuses two
    GEMMs): `torch._grouped_mm` twice with silu * up between them, the
    port's decomposed path and the parent kernel's time from PERF.md are
    printed beside it."""
    import numpy as np

    from xtuner_tpu_torch.ops import fused_moe_mlp as fm
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.ops.bf16_grouped import grouped_gemm_bf16

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.default_rng(seed + 7)
    src = "xtuner_tpu_torch/csrc/"
    rows = []
    d, hq, hkv, scale = 128, 16, 8, 128 ** -0.5

    def normed(b, l, hh):
        x = torch.randn((b, l, hh, d), generator=g, device=dev)
        return (x * (d ** 0.5) / x.norm(dim=-1, keepdim=True)).bfloat16()

    def flash_inputs(b, l, seg):
        q, k = normed(b, l, hq), normed(b, l, hkv)
        v = torch.randn((b, l, hkv, d), generator=g, device=dev).bfloat16()
        out, lse = fl.flash_attention(q, k, v, seg, max_logit=torch.tensor(d ** 0.5, device=dev))
        do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, out, lse, delta, do

    # ---- the two-pass backward (#2 + #4) against its plain version at
    # moe_heavy's flash shapes, beside the grouped one (#2 + #3)
    b, l = SFT_ROWS, SEQ
    seg = torch.cat([_segments(torch, doc_lengths(rng, l, 4, int(rng.integers(50, 300))),
                               l, dev) for _ in range(b)])
    q, k, v, _, lse, delta, do = flash_inputs(b, l, seg)
    args = (q, k, v, seg, lse, delta, do, scale)
    got, ref = fl.flash_bwd(*args, True), fl.flash_bwd_plain(*args, True)
    err = max(_abs(t, w) for t, w in zip(got, ref))
    rel = max(_rel(t, w) for t, w in zip(got, ref))
    pad_ok = all(bool((t[seg == 0] == 0).all()) for t in got)
    del got, ref
    ms = cuda_ms(lambda: fl.flash_bwd(*args, True), iters=5)
    plain = cuda_ms(lambda: fl.flash_bwd_plain(*args, True), iters=2, warmup=1)
    grouped = cuda_ms(lambda: fl.flash_bwd(*args), iters=5)
    pairs = causal_pairs(torch, seg)
    bound = bwd_bound(q, k, pairs, two_pass=True)
    lib, why = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg), do)
    shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}"
    say("kernel", name="flash_bwd_two_pass", shape=shape, err=f"{err:.3e}", rel=f"{rel:.3e}",
        pad_rows_ok=pad_ok, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
        grouped_ms=f"{grouped:.4f}", bound_ms=f"{bound['bound_ms']:.4f}",
        sdpa_bwd_ms=lib, why=repr(why), card=repr(smi))
    if not (rel <= FLASH_GRAD_RTOL and pad_ok):
        raise AssertionError(f"flash_bwd_two_pass disagrees with its plain version at {shape}: "
                             f"{rel} (<= {FLASH_GRAD_RTOL}), padding rows ok {pad_ok}")
    rows += bwd_rows("sft_switched", {"max_abs_err": err, "ms": ms, "plain_ms": plain, **bound,
                                      "library_ms": lib}, two_pass=True)
    del q, k, v, lse, delta, do, args

    # ---- #1 and both backward variants at the longctx row's shapes against
    # the plain versions in 1024-row chunks
    b, l = 1, LONGCTX_SEQ
    seg = torch.ones((b, l), dtype=torch.int32, device=dev)
    q, k, v, out, lse, delta, do = flash_inputs(b, l, seg)
    args = (q, k, v, seg, lse, delta, do, scale)
    shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}"
    pairs = causal_pairs(torch, seg)
    lib, why = sdpa_causal_ms(torch, q, k, v, do, iters=2)
    lib_fwd, why_fwd = sdpa_causal_ms(torch, q, k, v, iters=2)
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, D) -> (H, L, D)

    (ref_out, ref_lse), fwd_plain = timed_once(torch, lambda: flash_plain_chunked(
        torch, q, k, v, seg, None, None, None, scale, "fwd"))
    fwd_rel, fwd_err = _rel_rows(heads_first(out), ref_out), _abs(heads_first(out), ref_out)
    lse_err = _abs(lse[0], ref_lse)
    del ref_out, ref_lse
    ref_dq, dq_plain = timed_once(torch, lambda: flash_plain_chunked(torch, *args, "dq"))
    (ref_dk, ref_dv), dkv_plain = timed_once(torch, lambda: flash_plain_chunked(
        torch, *args, "dkv"))
    # the grouped outputs against the plain per-q-head ones summed over each group
    ref_group = [heads_first(fl.group_sum(t.transpose(0, 1)[None], hkv, torch.float32))
                 for t in (ref_dk, ref_dv)]
    res = {}
    for variant, two_pass in (("grouped", False), ("two_pass", True)):
        dq, dk, dv = fl.flash_bwd(*args, two_pass)
        want = (ref_dq, ref_dk, ref_dv) if two_pass else (ref_dq, *ref_group)
        got = [heads_first(t) for t in (dq, dk, dv)]
        res[variant] = ([_rel_rows(t, w) for t, w in zip(got, want)],
                        max(_abs(t, w) for t, w in zip(got, want)))
        del dq, dk, dv, got
    del ref_dq, ref_dk, ref_dv, ref_group
    say("kernel", name="flash_plain_chunked", shape=shape, docs=1, rows_per_chunk=PLAIN_CHUNK,
        out_rel=f"{fwd_rel:.3e}", lse_err=f"{lse_err:.3e}",
        grouped_dq_dk_dv_rel=",".join(f"{r_:.3e}" for r_ in res["grouped"][0]),
        two_pass_dq_dk_dv_rel=",".join(f"{r_:.3e}" for r_ in res["two_pass"][0]),
        fwd_plain_ms=f"{fwd_plain:.1f}", dq_plain_ms=f"{dq_plain:.1f}",
        dkv_plain_ms=f"{dkv_plain:.1f}")
    worst = max(max(res["grouped"][0]), max(res["two_pass"][0]))
    if not (fwd_rel <= FLASH_GRAD_RTOL and lse_err <= FLASH_LSE_ATOL and
            worst <= FLASH_GRAD_RTOL):
        raise AssertionError(f"flash kernels disagree at {shape}: out {fwd_rel}, backward "
                             f"{res} (<= {FLASH_GRAD_RTOL}); lse {lse_err} (<= {FLASH_LSE_ATOL})")

    bound = torch.tensor(d ** 0.5, device=dev)
    fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=3,
                     warmup=1)
    rm_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg), iters=3, warmup=1)
    say("kernel", name="flash_fwd_max_free", shape=shape, docs=1, out_rel=f"{fwd_rel:.3e}",
        lse_err=f"{lse_err:.3e}", ms=f"{fwd_ms:.3f}", running_max_ms=f"{rm_ms:.3f}",
        plain_ms=f"{fwd_plain:.1f}", card=repr(smi),
        **fwd_numbers(torch, q, k, v, seg, bound, fwd_ms, lib_fwd))
    tp_ms = cuda_ms(lambda: fl.flash_bwd(*args, True), iters=2, warmup=1)
    dk_h, dv_h = fl.flash_bwd(*args, True)[1:]
    sum_ms = cuda_ms(lambda: (fl.group_sum(dk_h, hkv, k.dtype), fl.group_sum(dv_h, hkv, v.dtype)),
                     iters=3, warmup=1)
    del dk_h, dv_h
    gr_ms = cuda_ms(lambda: fl.flash_bwd(*args), iters=2, warmup=1)
    tp_bound, gr_bound = bwd_bound(q, k, pairs, two_pass=True), bwd_bound(q, k, pairs)
    say("kernel", name="flash_bwd", shape=shape, docs=1, grouped_ms=f"{gr_ms:.3f}",
        two_pass_ms=f"{tp_ms:.3f}", group_sum_ms=f"{sum_ms:.3f}",
        grouped_bound_ms=f"{gr_bound['bound_ms']:.3f}",
        two_pass_bound_ms=f"{tp_bound['bound_ms']:.3f}",
        grouped_tflops=f"{10 * pairs * hq * d / gr_ms / 1e9:.1f}",
        two_pass_tflops=f"{10 * pairs * hq * d / tp_ms / 1e9:.1f}",
        sdpa_causal_bwd_ms=lib, why=repr(f"{why}; {why_fwd}"), card=repr(smi))
    plain_note = f"the plain version in {PLAIN_CHUNK}-row chunks (its (L, L) scores do not fit)"
    rows.append({"name": "flash_fwd_max_free", "route": "cuda", "source": src + "flash_fwd.cu",
                 "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "longctx",
                 "max_abs_err": max(fwd_err, lse_err),
                 "ms": fwd_ms, "plain_ms": fwd_plain, "plain_is": plain_note,
                 **least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16),
                 "library_ms": lib_fwd})
    rows += bwd_rows("longctx", {"max_abs_err": res["two_pass"][1], "ms": tp_ms,
                                 "plain_ms": dq_plain + dkv_plain, "plain_is": plain_note,
                                 **tp_bound, "library_ms": lib}, two_pass=True)
    del q, k, v, out, lse, delta, do, args

    # ---- #6 nt and #7 at the longctx row's shapes (#16's backward runs
    # them): E64, M = 65536 tokens x top-4, gate|up K1024/N256 and down
    # K128/N1024, one expert given no token
    e, hid, f = 64, 1024, 128
    sizes = routed_sizes(torch, rng, LONGCTX_SEQ, e, 4, empty=e // 2, dev=dev)
    m = LONGCTX_SEQ * 4
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    rows += grouped_rows(torch, "longctx", grouped_cases(
        x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e, kinds=("nt", "dw")), m, e, iters=5,
        plain_iters=2)
    del x, w_gu, w_dn, hmid, dy_gu, dy_dn

    # ---- #16, forward and backward, at the longctx and moe_heavy shapes
    # and at an odd M with rows past the last group
    # (F1536, the largest F the kernel takes, is timed but on no path)
    cases = (("longctx", LONGCTX_SEQ, 64, 4, 128), ("sft_switched", SFT_ROWS * SEQ, 16, 8, 768),
             ("odd", None, 5, None, 128), ("f1536", SFT_ROWS * SEQ, 16, 8, 1536))
    for path, tokens, e, topk, f in cases:
        h = 1024
        if tokens is None:
            sizes = torch.tensor([1200, 0, 3001, 1, 789], dtype=torch.int32, device=dev)
            m = int(sizes.sum()) + 11  # 11 rows past the last group
        else:
            sizes = routed_sizes(torch, rng, tokens, e, topk, empty=e // 2, dev=dev)
            m = tokens * topk
        x = torch.randn((m, h), generator=g, device=dev).bfloat16()
        w_gu = (torch.randn((e, h, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
        w_dn = (torch.randn((e, f, h), generator=g, device=dev) * 0.02).bfloat16()
        fm.reset_launches()
        out, gu = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes)
        out2, gu2 = fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes)
        repeat = torch.equal(out, out2) and torch.equal(gu, gu2)
        del out2, gu2
        # the tiles and chunks the kernel's CTAs walked in the two launches,
        # against the plain plan's
        walked = fm.fused_mlp_tiles_walked()
        plan = tuple(2 * c for c in fm.fused_mlp_plan_counts(sizes, m, h, f))
        ref_out, ref_gu = fm.fused_moe_mlp_plain(x, w_gu, w_dn, sizes)
        torch.cuda.synchronize()
        err = max(_abs(out, ref_out), _abs(gu, ref_gu))
        rel = max(_rel(out, ref_out), _rel(gu, ref_gu))
        n = int(sizes.sum())
        tail_ok = bool((out[n:] == 0).all()) and bool((gu[n:] == 0).all())
        del out, gu, ref_out, ref_gu
        # the backward: the kernel path (#16, then #6 nt and #7) against
        # autograd through the plain version in f32
        co = torch.randn((m, h), generator=g, device=dev)
        grads = []
        for fn, dtype in ((fm.fused_moe_mlp, torch.bfloat16),
                          (lambda *a: fm.fused_moe_mlp_plain(*a)[0], torch.float32)):
            leaves = [t.detach().to(dtype).requires_grad_(True) for t in (x, w_gu, w_dn)]
            (fn(*leaves, sizes).float() * co).sum().backward()
            grads.append([t.grad for t in leaves])
            del leaves
        g_rel = max(_rel(a, r_) for a, r_ in zip(*grads))
        del grads, co
        shape = f"M{m}xE{e}xH{h}xF{f}"
        say("kernel", name="fused_moe_mlp", shape=shape, rows=n, empty=int((sizes == 0).sum()),
            out_gu_err=f"{err:.3e}", out_gu_rel=f"{rel:.3e}", grad_rel=f"{g_rel:.3e}",
            tail_rows_ok=tail_ok, bitwise_repeat=repeat, walked=walked, plan=plan)
        if not (rel <= GG_RTOL and g_rel <= GG_RTOL and tail_ok and repeat and walked == plan):
            raise AssertionError(f"fused_moe_mlp disagrees with its plain version at {shape}: "
                                 f"out/gu {rel}, grads {g_rel} (<= {GG_RTOL}), rows past the "
                                 f"last group zero {tail_ok}, two launches give the same "
                                 f"bits {repeat}, walked {walked} against the plan {plan}")
        if path == "odd":
            continue
        ms = cuda_ms(lambda: fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes), iters=5)
        plain = cuda_ms(lambda: fm.fused_moe_mlp_plain(x, w_gu, w_dn, sizes), iters=2, warmup=1)

        def decomposed():
            gu_ = grouped_gemm_bf16(x, w_gu, sizes)
            hid = (torch.nn.functional.silu(gu_[:, :f].float()) * gu_[:, f:].float()).bfloat16()
            return grouped_gemm_bf16(hid, w_dn, sizes)

        dec_ms = cuda_ms(decomposed, iters=5)
        offs = torch.cumsum(sizes, 0).to(torch.int32)

        def grouped_mm_pair():
            gu_ = torch._grouped_mm(x, w_gu, offs=offs)
            hid = (torch.nn.functional.silu(gu_[:, :f].float()) * gu_[:, f:].float()).bfloat16()
            return torch._grouped_mm(hid, w_dn, offs=offs)

        pair_ms, pair_why = library_ms(torch, grouped_mm_pair)
        flops = 6 * n * h * f
        nbytes = 2 * m * h * 2 + 2 * m * 2 * f + 2 * e * h * 2 * f + 2 * e * f * h
        bound = least_ms(flops, nbytes, PEAK_BF16)
        _, peak = _peak_ms(torch, lambda: fm.fused_moe_mlp_fwd(x, w_gu, w_dn, sizes), iters=1)
        say("kernel", name="fused_moe_mlp", shape=shape, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            parent_ms_perf_md=PARENT_MS.get(("fused_moe_mlp", path), "not measured"),
            decomposed_ms=f"{dec_ms:.4f}", grouped_mm_pair_ms=pair_ms, why=repr(pair_why),
            tflops=f"{flops / ms / 1e9:.1f}", bound_ms=f"{bound['bound_ms']:.4f}",
            bound_by=bound["bound_by"], share_of_bound=f"{bound['bound_ms'] / ms:.3f}",
            peak_gib=f"{peak:.3f}", card=repr(smi))
        if path == "f1536":
            del x, w_gu, w_dn
            continue
        rows.append({"name": "fused_moe_mlp", "route": "cuda", "source": src + "fused_moe_mlp.cu",
                     "replaces": "xtuner_tpu/ops/fused_moe_mlp.py:48", "path": path,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain, **bound,
                     # no one PyTorch call fuses the two GEMMs and the activation
                     "library_ms": None})
        del x, w_gu, w_dn
    say("kernel", name="fused_moe_mlp",
        library=repr("none: no PyTorch call runs both grouped GEMMs and the activation; "
                     "torch._grouped_mm twice with silu * up between them is printed above"))
    reset_train_launches()
    return rows


def phase_longctx(torch, seed: int, smi: str) -> dict:
    """bench.py's longctx_64k row at full width and depth through
    `recipes/bench_longctx_64k.py`: `TrainEngine` on the card, random f32
    masters from the seed, 3 `train_step`s on one `fake_collator` row of
    65536 tokens, with `XTUNER_ATTN_BWD=two_pass` and `XTUNER_FUSED_MLP=1`
    set (and restored after). CE, grad norm, step ms, tokens/s and peak
    memory per step; the exact launches of every kernel; the bytes one
    forward holds for the backward against JAX's formula for remat
    "save_out_lse"; one profiled step."""
    import os
    from unittest import mock

    import numpy as np

    from xtuner_tpu_torch.data_proto import SequenceContext
    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.recipes import bench_longctx_64k as r

    cfg = r.model_cfg
    with mock.patch.dict(os.environ, r.SWITCHES):
        eng = TrainEngine(cfg, r.optim_cfg, r.lr_cfg, r.mesh_cfg, r.TOTAL_STEPS)
        t0 = time.perf_counter()
        eng.init_random(seed)
        torch.cuda.synchronize()
        n = eng.num_params
        batch = r.batch(seed)
        say("longctx", recipe=LONGCTX_RECIPE, params=n, layers=cfg.num_hidden_layers,
            hidden=cfg.hidden_size,
            heads=f"{cfg.attention.num_attention_heads}/{cfg.attention.num_key_value_heads}",
            experts=f"{cfg.n_routed_experts}/top{cfg.num_experts_per_tok}",
            moe_inter=cfg.moe_intermediate_size, vocab=cfg.vocab_size, ce=cfg.lm_loss_cfg.mode,
            remat=eng.remat, compute=str(eng.compute_dtype), seq=r.SEQ,
            switches=repr(switch_state()), init_s=f"{time.perf_counter() - t0:.3f}",
            state_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}",
            reason=repr(f"nothing cut: 16 B x {n / 1e6:.1f} M params = {16 * n / 1e9:.2f} GB "
                        f"of f32 state"))

        reset_train_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist = []
        for step in range(1, LONGCTX_STEPS + 1):
            t0 = time.perf_counter()
            m = eng.train_step(batch, step)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            hist.append((m, dt))
            say("longctx", step=step, ce=f"{m['reduced_llm_loss']:.5f}",
                total_loss=f"{m['total_loss']:.5f}", grad_norm=f"{m['grad_norm']:.5f}",
                lr=f"{m['lr']:.3e}", maxvio=f"{m['maxvio']:.3f}", skipped=m["skipped"],
                step_ms=f"{1e3 * dt:.1f}", tok_s=f"{m['consumed_tokens'] / dt:.1f}",
                peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                **switch_state())
        launches = train_launches(torch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        layers, steps = cfg.num_hidden_layers, LONGCTX_STEPS
        # per layer and step: the flash forward once (never re-run: its out
        # and lse are kept), the two-pass backward once, the fused MLP
        # in the forward and in post's recompute, its backward's two "nt"
        # and two wgrads; the fused CE once each, its coefficient kernel
        # once per row chunk
        want = {name: 0 for name in launches}
        want.update(flash_fwd_max_free=layers * steps, flash_bwd_two_pass=layers * steps,
                    fused_moe_mlp=2 * layers * steps,
                    grouped_gemm_nt=2 * layers * steps, grouped_gemm_dw=2 * layers * steps,
                    ce_fwd=steps, ce_dh=steps, ce_dw=steps,
                    ce_coeff=steps * ce_chunks(r.SEQ, cfg.vocab_size))
        steady = [dt for _, dt in hist[1:]]
        step_s = sum(steady) / len(steady)
        say("longctx", launches={k: v for k, v in launches.items() if v or want[k]},
            expected={k: v for k, v in want.items() if v}, steady_step_ms=f"{1e3 * step_s:.1f}",
            steady_tok_s=f"{r.SEQ / step_s:.1f}", peak_gib=f"{peak:.3f}", card=repr(smi))
        losses = [m["reduced_llm_loss"] for m, _ in hist]
        norms = [m["grad_norm"] for m, _ in hist]
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
        if not LONGCTX_LOSS1[0] <= losses[0] <= LONGCTX_LOSS1[1]:
            raise AssertionError(f"step-1 CE {losses[0]} outside {LONGCTX_LOSS1}")
        if any(m["skipped"] for m, _ in hist):
            raise AssertionError("a step was skipped")
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != what {steps} steps imply {want}")
        if not peak < LONGCTX_PEAK_GIB:
            raise AssertionError(f"peak {peak:.3f} GiB >= {LONGCTX_PEAK_GIB}")

        # what one forward holds for the backward, against JAX's formula for
        # "save_out_lse": per token and layer, out (Hq x Dv bf16) and lse
        # (Hq f32), plus the layer input (H bf16) that every policy keeps
        mb = {k: v[0] for k, v in eng._to_device(batch).items()}
        seq_ctx = SequenceContext(mb["input_ids"], mb["segment_ids"], mb["position_ids"])
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        out = eng.model.loss(eng._train_tree, seq_ctx, mb["shifted_labels"], mb["loss_weights"],
                             mb["loss_weights"].float().sum(), compute_dtype=eng.compute_dtype,
                             remat=eng.remat)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - resident
        del out
        a = cfg.attention
        per_layer = r.SEQ * (a.num_attention_heads * a.head_dim * 2 + a.num_attention_heads * 4
                             + cfg.hidden_size * 2)
        say("longctx", held_for_backward_gib=f"{held / 2**30:.3f}",
            jax_formula_per_layer_gb=f"{per_layer / 1e9:.3f}",
            jax_formula_layers_gib=f"{layers * per_layer / 2**30:.3f}",
            rest=repr("outside the layers: the final norm's f32 tensors, the head's bf16 "
                      "copy of the tied embedding, the CE's hidden states"))
        profile_window(torch, "longctx_step",
                       lambda: eng.train_step(batch, LONGCTX_STEPS + 1), top=16)
    del eng, batch, mb, seq_ctx
    return launches


def release(torch, phase: str) -> None:
    """Free what a phase left behind, so that the next phase's peak memory
    is its own: collect reference cycles (the serving phase's engine holds
    its own timed methods), return cached blocks, and fail if more than
    RELEASED_GIB stays allocated; prints the seconds since the last
    release (the phase's own)."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    now = time.perf_counter()
    say("memory", after=phase, allocated_gib=f"{left:.3f}",
        phase_s=f"{now - getattr(release, 'last', now):.1f}")
    release.last = now
    if left > RELEASED_GIB:
        live = sorted((o for o in gc.get_objects() if torch.is_tensor(o) and o.is_cuda),
                      key=lambda t: -t.numel() * t.element_size())[:8]
        say("memory", largest_live=[(tuple(t.shape), str(t.dtype)) for t in live])
        raise AssertionError(f"{left:.3f} GiB still allocated after the {phase} phase")


def window_pairs(torch, seg, window) -> int:
    """(query, key) pairs on the documents' causal triangles inside a
    sliding `window` (all of them without one); padding excluded."""
    if not window:
        return causal_pairs(torch, seg)
    total = 0
    for row in seg.cpu():
        ids, counts = torch.unique_consecutive(row, return_counts=True)
        for i, n in zip(ids.tolist(), counts.tolist()):
            if i:
                w = min(n, window)
                total += w * (w + 1) // 2 + (n - w) * window
    return total


def window_mask(torch, seg, window):
    """`block_causal_mask` cut to a sliding window (the full mask without
    one): SDPA's dense mask for #1 at a windowed layer."""
    mask = block_causal_mask(torch, seg)
    if window:
        pos = torch.arange(seg.shape[-1], device=seg.device)
        mask = mask & (pos[:, None] - pos[None, :] < window)
    return mask


def flash_plain_by_group(torch, q, k, v, seg, scale: float, window):
    """`flash_attention_plain` one kv head's q-head group at a time: the
    same f32 math, with an (L, L) score slab per group of Hq / Hkv heads
    (2.1 GB f32 at L8192 and 8 heads) instead of one for all heads."""
    from xtuner_tpu_torch.ops.attention.flash import flash_attention_plain

    rep = q.shape[2] // k.shape[2]
    outs, lses = [], []
    for g in range(k.shape[2]):
        o, lse = flash_attention_plain(q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1],
                                       v[:, :, g:g + 1], seg, scale, window=window)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=1)


def phase_gpt_oss_kernels(torch, seed: int, smi: str) -> list[dict]:
    """The kernels of gpt-oss-20b's serving path against their plain
    versions at its shapes: #1 at (64, 64), B1 L8192 Hq64/8 on five
    documents and a padded tail, with the window of 128 and in full (the
    walked k tiles against `fwd_tile_plan` with the window; the sinks
    folded in once, against the plain fold), SDPA with the window as a
    dense mask as the library time, the bound on the in-window pairs; #5 at
    D 64 at OSS_PAGED_SHAPES; #6 (nn) at E32 H2880 F2880 on a decode step's
    rows (4 slots x top-4) and a 1000-token prefill's, beside
    `torch._grouped_mm`."""
    import numpy as np

    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    rng = np.random.default_rng(seed + 17)
    l, hq, hkv, d = OSS_SEQ, OSS_HQ, OSS_HKV, OSS_D
    seg = _segments(torch, doc_lengths(rng, l, 5, 250), l, dev)
    q, k, v = (torch.randn((1, l, h, d), generator=g, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    sinks = torch.randn((hq,), generator=g, device=dev)
    scale = d ** -0.5
    valid = seg[0] != 0
    rows = []
    for window in (OSS_WINDOW, None):
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg, window=window)
        torch.cuda.synchronize()
        walked, full = fl.fwd_tiles_walked()
        walk, plan_full = fl.fwd_tile_plan(seg, window)
        plan = (int(walk.sum()) * hq, int(plan_full.sum()) * hq)
        fl.reset_launches()
        ref_out, ref_lse = flash_plain_by_group(torch, q, k, v, seg, scale, window)
        out_err = _abs(out[:, valid], ref_out[:, valid])
        lse_err = _abs(lse[..., valid], ref_lse[..., valid])
        pad_ok = bool((out[:, ~valid] == 0).all()) and \
            bool((lse[..., ~valid] == fl.BIG_LSE).all())
        # the sinks, folded after the kernel, against the plain fold
        s_out, s_lse = fl.flash_attention(q, k, v, seg, window=window, sinks=sinks)
        r_out, r_lse = fl.fold_sinks(ref_out, ref_lse, sinks)
        sink_err = _abs(s_out[:, valid], r_out[:, valid])
        sink_lse_err = _abs(s_lse[..., valid], r_lse[..., valid])
        sink_pad_ok = bool((s_out[:, ~valid] == 0).all()) and \
            bool(torch.isfinite(s_out.float()).all())
        del ref_out, ref_lse, s_out, s_lse, r_out, r_lse
        ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, window=window))
        plain = cuda_ms(lambda: flash_plain_by_group(torch, q, k, v, seg, scale, window),
                        iters=1, warmup=1)
        mask = window_mask(torch, seg, window)
        lib, why = sdpa_ms(torch, q, k, v, mask)
        del mask
        pairs = window_pairs(torch, seg, window)
        least = least_ms(2 * pairs * hq * (d + d), flash_bytes(q, k, dv=d), PEAK_BF16)
        say("kernel", name="flash_fwd", path="serve_gpt_oss",
            shape=f"B1xL{l}xHq{hq}xHkv{hkv}xD{d}", window=window, out_err=f"{out_err:.3e}",
            lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, sinks_out_err=f"{sink_err:.3e}",
            sinks_lse_err=f"{sink_lse_err:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}", sdpa_ms=lib, why=repr(why),
            pairs=pairs, tflops=f"{2 * pairs * hq * 2 * d / ms / 1e9:.1f}",
            bound_ms=f"{least['bound_ms']:.4f}", bound_by=least["bound_by"],
            share_of_bound=f"{least['bound_ms'] / ms:.3f}", tiles_walked=walked,
            tiles_full=full, plan_walked_full=f"{plan[0]},{plan[1]}", card=repr(smi))
        if (walked, full) != plan:
            raise AssertionError(f"#1 at 64/64 (window {window}) walked {walked} k tiles "
                                 f"({full} full) where its plan says {plan}")
        if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok and
                sink_err <= FLASH_OUT_ATOL and sink_lse_err <= FLASH_LSE_ATOL and sink_pad_ok):
            raise AssertionError(f"#1 at 64/64 (window {window}) disagrees with its plain "
                                 f"version: out {out_err}, lse {lse_err}, padding {pad_ok}, "
                                 f"with sinks {sink_err}, {sink_lse_err} (finite, padding "
                                 f"{sink_pad_ok})")
        rows.append({"name": "flash_fwd", "route": "cuda",
                     "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82",
                     "path": "serve_gpt_oss",
                     "shape": f"B1xL{l}xHq{hq}/{hkv}xD{d}, window {window or 'none'}",
                     "launches": 0, "max_abs_err": max(out_err, lse_err, sink_err, sink_lse_err),
                     "ms": ms,
                     "plain_ms": plain, **least, "library_ms": lib})
    del q, k, v
    for label, lens, mb, window, snk in OSS_PAGED_SHAPES:
        nums = check_paged(torch, seed, label, lens, mb, OSS_DIMS, window, snk)
        rows.append({"name": "paged_decode", "route": "cuda",
                     "source": "xtuner_tpu_torch/csrc/paged_decode.cu",
                     "replaces": "xtuner_tpu/ops/attention/paged_decode.py:66",
                     "path": "serve_gpt_oss", "shape": label, "launches": 0, **nums,
                     "library_ms": None})
    e, h, f = OSS_EXPERTS, OSS_H, OSS_F
    w_gu = (torch.randn((e, h, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, h), generator=g, device=dev) * 0.02).bfloat16()
    for label, tokens in (("decode", OSS_SLOTS), ("prefill", 1000)):
        m = tokens * OSS_TOPK
        sizes = routed_sizes(torch, rng, tokens, e, OSS_TOPK, e - 1, dev)
        x = torch.randn((m, h), generator=g, device=dev).bfloat16()
        hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
        cases = grouped_cases(x, hmid, w_gu, w_dn, None, None, sizes, e, kinds=("nn",))
        # the bytes the function must move: the weights of the experts that
        # have rows (a decode step's 16 rows touch fewer than 32)
        touched = int((sizes > 0).sum())
        cases = [(*c[:6], c[6] - 2 * (e - touched) * c[4][1].shape[1] * c[4][1].shape[2])
                 for c in cases]
        for row in grouped_rows(torch, "serve_gpt_oss", cases, m, e, iters=20, plain_iters=2):
            row["shape"] = f"{label} M{m} E{e} ({touched} with rows) H{h} F{f}"
            rows.append(row)
    return rows


def phase_serve_gpt_oss(torch, seed: int, smi: str) -> dict:
    """`PagedGenerator.generate` on gpt-oss-20b at full width and depth with
    random bf16 weights from the seed and `record_routing=True`: 6 requests
    on 4 slots (prompts up to 1000 tokens, past the window of 128 and across
    block edges; one GRPO pair), MAX_NEW new tokens each; prefill and decode
    tokens/s, ms a decode step, peak memory, the exact launches of #1, #5
    and #6; `routed_experts`' shape and range; the teacher-forced re-check
    of the logprobs with the share of positions whose re-prefill routing
    equals the recorded one; and what one concatenation of a layer's
    gate|up (which the engine's fused gate|up buffer avoids) costs. No
    profiler window opens here (`phase_gpt_oss_profile` runs at the end)."""
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig, _forward_cached, init_cache
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import count_params, init_params
    from xtuner_tpu_torch.ops import bf16_grouped as bg
    from xtuner_tpu_torch.ops.attention.flash import flash_attention
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn

    dev = torch.device("cuda")
    cfg = get_model_config(OSS_MODEL)
    model = cfg.build()
    specs = model.param_specs()
    n_params = count_params(specs)
    if n_params != OSS_PARAMS:
        raise AssertionError(f"{OSS_MODEL}: {n_params} params, JAX's preset has {OSS_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev,
                         torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    rng = np.random.default_rng(seed + 3)
    lens = [1000, 1, *rng.integers(130, 1000, size=3).tolist()]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    reqs = [{"prompt_ids": prompts[0], "group": "g0"}, {"prompt_ids": prompts[0], "group": "g0"},
            *[{"prompt_ids": p} for p in prompts[1:]]]
    greedy = GenerateConfig(max_length=2048, max_new_tokens=MAX_NEW, do_sample=False,
                            prefill_chunk=0, prefix_cache=False)
    t0 = time.perf_counter()
    eng = PagedGenerator(model, params, greedy, max_batch=OSS_SLOTS, block_size=128,
                         record_routing=True)
    torch.cuda.synchronize()
    say("serve_gpt_oss", model=OSS_MODEL, params=n_params, layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size, heads=f"{OSS_HQ}/{OSS_HKV}x{OSS_D}",
        experts=f"{cfg.n_routed_experts}top{cfg.num_experts_per_tok}",
        windows=cfg.layer_window_pattern, dtype="bf16", init_s=f"{init_s:.3f}",
        weights_gib=f"{weights_gib:.3f}", engine_init_s=f"{time.perf_counter() - t0:.3f}",
        init_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    eng.generate([{"prompt_ids": prompts[1], "max_new_tokens": 2}])  # warm-up
    eng._prefill = _Timed(torch, eng._prefill)
    eng._decode_step = _Timed(torch, eng._decode_step)
    flash_attention.launches = 0
    paged_decode_attn.launches = 0
    bg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "paged_decode": paged_decode_attn.launches,
                "grouped_gemm_nn": bg.grouped_gemm_bf16.launches["nn"]}
    n_layers = cfg.num_hidden_layers
    want = {"flash_fwd": n_layers * eng._prefill.calls,
            "paged_decode": n_layers * eng._decode_step.calls,
            "grouped_gemm_nn": 2 * n_layers * (eng._prefill.calls + eng._decode_step.calls)}
    n_gen = [len(o["token_ids"]) for o in outs]
    say("serve_gpt_oss", requests=len(reqs), slots=OSS_SLOTS, wall_s=f"{wall:.3f}",
        prefill_calls=eng._prefill.calls, prefill_s=f"{eng._prefill.seconds:.4f}",
        decode_steps=eng._decode_step.calls, decode_s=f"{eng._decode_step.seconds:.4f}",
        generated=n_gen, launches=launches, want=want,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if eng._prefill.calls != len(prompts):
        raise AssertionError(f"{eng._prefill.calls} prefills for {len(prompts)} prompts: "
                             f"the GRPO sibling did not share its leader's prompt")
    if launches != want:
        raise AssertionError(f"launches {launches}, the steps imply {want}")
    for o in outs:
        r = o["routed_experts"]
        if not o["token_ids"] or len(o["logprobs"]) != len(o["token_ids"]) or \
                not all(0 <= t < cfg.vocab_size for t in o["token_ids"]) or \
                not np.isfinite(o["logprobs"]).all():
            raise AssertionError(f"bad output {o['finish_reason']} {o['token_ids'][:8]}")
        if r.shape != (len(o["token_ids"]), n_layers, OSS_TOPK) or r.min() < 0 or \
                r.max() >= OSS_EXPERTS or (np.diff(np.sort(r, -1), axis=-1) == 0).any():
            raise AssertionError(f"routed_experts {r.shape}: want ({len(o['token_ids'])}, "
                                 f"{n_layers}, {OSS_TOPK}) distinct ids in [0, {OSS_EXPERTS})")
        if o["finish_reason"] == "length" and len(o["token_ids"]) != MAX_NEW:
            raise AssertionError(f"length finish with {len(o['token_ids'])} tokens")
    if outs[0]["token_ids"][0] != outs[1]["token_ids"][0] or \
            not np.array_equal(outs[0]["routed_experts"][0], outs[1]["routed_experts"][0]):
        raise AssertionError("the GRPO sibling's first token or routing differs from its "
                             "leader's (greedy, one prompt)")
    eng.check_block_conservation()
    if eng.cache.tables:
        raise AssertionError("sequences left in the pool")
    prefilled, decoded = sum(lens), sum(n_gen) - len(outs)
    say("serve_gpt_oss", prefill_tokens=prefilled,
        prefill_tok_s=f"{prefilled / eng._prefill.seconds:.1f}", decode_tokens=decoded,
        decode_tok_s=f"{decoded / eng._decode_step.seconds:.1f}",
        decode_ms_per_step=f"{1e3 * eng._decode_step.seconds / eng._decode_step.calls:.3f}",
        card=repr(smi))

    # teacher-forced re-check: prompt + generated tokens in one flash
    # prefill, with its routing at the positions that produced the tokens
    def teacher_forced(prompt, toks, extra_pad):
        ids = prompt + toks
        n = len(ids)
        pb = -(-n // 64) * 64 + extra_pad
        padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
        padded[0, :n] = torch.tensor(ids, device=dev)
        pos = torch.clamp(torch.arange(pb, device=dev), max=n - 1)[None]
        mask = (torch.arange(pb, device=dev) < n)[None]
        logits, _, routing = _forward_cached(model, params, padded, pos,
                                             init_cache(model, 1, pb, torch.bfloat16, dev),
                                             0, torch.bfloat16, mask, record_routing=True)
        p = len(prompt)
        lps = torch.log_softmax(logits[0, p - 1:p - 1 + len(toks)], dim=-1)
        lps = lps.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0].cpu()
        return lps, np.sort(routing[0, p - 1:p - 1 + len(toks)].cpu().numpy(), -1)

    diffs, floor, layers, floor_layers = [], [], [], []
    for req, o in zip(reqs, outs):
        tf, rout = teacher_forced(req["prompt_ids"], o["token_ids"], 0)
        tf_pad, rout_pad = teacher_forced(req["prompt_ids"], o["token_ids"], 64)
        diffs.append((tf - torch.tensor(o["logprobs"])).abs())
        floor.append((tf - tf_pad).abs())
        # (positions, layers): the same top-4 set in decode and re-prefill
        layers.append((rout == np.sort(o["routed_experts"], -1)).all(-1))
        floor_layers.append((rout == rout_pad).all(-1))
    diffs, floor = torch.cat(diffs), torch.cat(floor)
    layers, floor_layers = np.concatenate(layers), np.concatenate(floor_layers)
    agree = torch.from_numpy(layers.all(1))
    share, layer0 = agree.float().mean().item(), float(layers[:, 0].mean())
    tf_max, tf_mean = diffs.max().item(), diffs.mean().item()
    held = "all positions"
    if not (tf_max <= TF_MAX_ATOL and tf_mean <= TF_MEAN_ATOL) and \
            share >= OSS_ALL_LAYERS_AGREE_MIN and layer0 >= OSS_ROUTING_AGREE_MIN:
        tf_max, tf_mean = diffs[agree].max().item(), diffs[agree].mean().item()
        held = "positions whose routing agrees in every layer"
    say("serve_gpt_oss", teacher_forced_max_abs=f"{diffs.max().item():.4e}",
        mean_abs=f"{diffs.mean().item():.4e}", held_on=repr(held),
        held_max_abs=f"{tf_max:.4e}", held_mean_abs=f"{tf_mean:.4e}",
        tol=f"max<={TF_MAX_ATOL},mean<={TF_MEAN_ATOL}", positions=int(agree.numel()),
        routing_agree_all_layers=f"{share:.4f}", routing_agree_layer0=f"{layer0:.4f}",
        routing_agree_by_layer=",".join(f"{x:.3f}" for x in layers.mean(0)),
        prefill_vs_prefill_max_abs=f"{floor.max().item():.4e}",
        prefill_vs_prefill_mean_abs=f"{floor.mean().item():.4e}",
        prefill_vs_prefill_routing_agree_all_layers=f"{floor_layers.all(1).mean():.4f}")
    if not (tf_max <= TF_MAX_ATOL and tf_mean <= TF_MEAN_ATOL):
        raise AssertionError(f"teacher-forced logprobs disagree with decode on {held}: max "
                             f"{tf_max}, mean {tf_mean} (routing agrees in every layer at "
                             f"{share:.4f} of the positions, at layer 0 at {layer0:.4f})")

    # what the fused gate|up buffer saves: one layer's concatenation of its
    # gate and up weights, as `moe_mlp_forward` would make it every call
    ex = params["moe_layers"]["experts"]
    g0, u0 = ex["gate_proj"][0], ex["up_proj"][0]
    cat_ms = cuda_ms(lambda: torch.cat([g0, u0], dim=2), iters=5, warmup=1)
    cat_bytes = 2 * (g0.numel() + u0.numel()) * g0.element_size()
    say("serve_gpt_oss", gate_up_cat_ms_per_layer=f"{cat_ms:.4f}",
        gate_up_cat_gb_per_layer=f"{cat_bytes / 1e9:.3f}",
        avoided_ms_per_decode_step=f"{cat_ms * n_layers:.3f}",
        cat_bound_ms_per_layer=f"{cat_bytes / HBM_BYTES_S * 1e3:.4f}")
    return launches


def init_fused_params(torch, specs, generator, dev):
    """`init_params` in bf16 with each expert stack's gate and up weights
    drawn straight into the two halves of one (..., H, 2F) buffer (the
    same distribution), so `fuse_gate_up` has nothing to concatenate: at
    Qwen3.5-35B-A3B's four expert stacks a concatenation beside the old
    halves would need ~40 GiB more than the card has."""
    from xtuner_tpu_torch.module.params import ParamSpec, init_params

    def fuse(tree):
        if not isinstance(tree, dict):
            return tree
        if isinstance(tree.get("gate_proj"), ParamSpec) and "up_proj" in tree:
            g = tree["gate_proj"]
            rest = {k: v for k, v in tree.items() if k not in ("gate_proj", "up_proj")}
            return {**rest, "gate_up": ParamSpec((*g.shape[:-1], 2 * g.shape[-1]), g.init,
                                                 g.scale)}
        return {k: fuse(v) for k, v in tree.items()}

    def split(tree):
        if not isinstance(tree, dict):
            return tree
        if "gate_up" in tree:
            gu = tree.pop("gate_up")
            f = gu.shape[-1] // 2
            tree["gate_proj"], tree["up_proj"] = gu[..., :f], gu[..., f:]
            return tree
        return {k: split(v) for k, v in tree.items()}

    return split(init_params(fuse(specs), generator, dev, torch.bfloat16))


def phase_qwen35_kernels(torch, seed: int, smi: str) -> list[dict]:
    """The kernels of Qwen3.5-35B-A3B's serving path against their plain
    versions at its shapes: #1 at (256, 256) (the 64-key tile kernel), both
    variants (running max; max-free under a bound of 45), at the serving
    prefill (B1, 1000 tokens in a 1024 bucket) and at B1 L8192 on five
    documents, Hq16/2, the walked k tiles against `fwd_tile_plan` at 64-key
    tiles, SDPA with a dense mask as the library time; #5 at D 256 at
    QWEN_PAGED_SHAPES; #6 (nn) at E256 H2048 F512 on a decode step's rows
    (4 slots x top-8) and a 1000-token prefill's, beside
    `torch._grouped_mm`."""
    import numpy as np

    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 19)
    rng = np.random.default_rng(seed + 19)
    hq, hkv, d = QWEN_HQ, QWEN_HKV, QWEN_D
    scale = d ** -0.5
    rows = []
    for label, l, lens in (("serve_prefill", 1024, [1000]),
                           ("docs", QWEN_SEQ, doc_lengths(rng, QWEN_SEQ, 5, 250))):
        seg = _segments(torch, lens, l, dev)
        q, k, v = (torch.randn((1, l, h, d), generator=g, device=dev).bfloat16()
                   for h in (hq, hkv, hkv))
        valid = seg[0] != 0
        ref_out, ref_lse = flash_plain_by_group(torch, q, k, v, seg, scale, None)
        plain = cuda_ms(lambda: flash_plain_by_group(torch, q, k, v, seg, scale, None),
                        iters=1, warmup=1)
        lib, why = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg))
        pairs = causal_pairs(torch, seg)
        least = least_ms(2 * pairs * hq * (d + d), flash_bytes(q, k, dv=d), PEAK_BF16)
        walk, plan_full = fl.fwd_tile_plan(seg, key_tile=fl.fwd_key_tile(d, d))
        plan = (int(walk.sum()) * hq, int(plan_full.sum()) * hq)
        for variant, bound in (("running_max", None),
                               ("max_free", torch.tensor(fl.MAX_FREE_BOUND, device=dev))):
            fl.reset_launches()
            out, lse = fl.flash_attention(q, k, v, seg, max_logit=bound)
            again, _ = fl.flash_attention(q, k, v, seg, max_logit=bound)
            torch.cuda.synchronize()
            walked, full = fl.fwd_tiles_walked()
            n_free = fl.max_free_launches()
            fl.reset_launches()
            out_err = _abs(out[:, valid], ref_out[:, valid])
            lse_err = _abs(lse[..., valid], ref_lse[..., valid])
            pad_ok = bool((out[:, ~valid] == 0).all()) and \
                bool((lse[..., ~valid] == fl.BIG_LSE).all())
            same = torch.equal(out, again)
            del out, lse, again
            ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound))
            say("kernel", name="flash_fwd", path="serve_qwen35", variant=variant,
                shape=f"{label} B1xL{l}xHq{hq}xHkv{hkv}xD{d}", out_err=f"{out_err:.3e}",
                lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, same_bits=same,
                max_free_launches=n_free, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                sdpa_ms=lib, why=repr(why), pairs=pairs,
                tflops=f"{2 * pairs * hq * 2 * d / ms / 1e9:.1f}",
                bound_ms=f"{least['bound_ms']:.4f}", bound_by=least["bound_by"],
                share_of_bound=f"{least['bound_ms'] / ms:.3f}", tiles_walked=walked,
                tiles_full=full, plan_walked_full=f"{2 * plan[0]},{2 * plan[1]}",
                card=repr(smi))
            if (walked, full) != (2 * plan[0], 2 * plan[1]):
                raise AssertionError(f"#1 at 256/256 ({label}, {variant}) walked {walked} k "
                                     f"tiles ({full} full) in two launches where its plan "
                                     f"says {plan} each")
            if n_free != 2 * (bound is not None):
                raise AssertionError(f"#1 at 256/256 ({variant}): {n_free} max-free launches")
            if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok and same):
                raise AssertionError(f"#1 at 256/256 ({label}, {variant}) disagrees with its "
                                     f"plain version: out {out_err}, lse {lse_err}, padding "
                                     f"{pad_ok}, two launches the same bits {same}")
            rows.append({"name": "flash_fwd", "route": "cuda",
                         "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
                         "replaces": "xtuner_tpu/ops/attention/flash.py:82",
                         "path": "serve_qwen35",
                         "shape": f"{label} B1xL{l}xHq{hq}/{hkv}xD{d}, {variant}",
                         "launches": 0, "max_abs_err": max(out_err, lse_err), "ms": ms,
                         "plain_ms": plain, **least, "library_ms": lib})
        del q, k, v, ref_out, ref_lse
    for label, lens, mb in QWEN_PAGED_SHAPES:
        nums = check_paged(torch, seed, label, lens, mb, QWEN_DIMS)
        rows.append({"name": "paged_decode", "route": "cuda",
                     "source": "xtuner_tpu_torch/csrc/paged_decode.cu",
                     "replaces": "xtuner_tpu/ops/attention/paged_decode.py:66",
                     "path": "serve_qwen35", "shape": label, "launches": 0, **nums,
                     "library_ms": None})
    e, h, f = QWEN_EXPERTS, QWEN_H, QWEN_F
    w_gu = (torch.randn((e, h, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, h), generator=g, device=dev) * 0.02).bfloat16()
    for label, tokens in (("decode", QWEN_SLOTS), ("prefill", 1000)):
        m = tokens * QWEN_TOPK
        sizes = routed_sizes(torch, rng, tokens, e, QWEN_TOPK, 0, dev)
        x = torch.randn((m, h), generator=g, device=dev).bfloat16()
        hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
        cases = grouped_cases(x, hmid, w_gu, w_dn, None, None, sizes, e, kinds=("nn",))
        # the bytes the function must move: the weights of the experts that
        # have rows (a decode step's 32 rows touch at most 32 of 256)
        touched = int((sizes > 0).sum())
        cases = [(*c[:6], c[6] - 2 * (e - touched) * c[4][1].shape[1] * c[4][1].shape[2])
                 for c in cases]
        for row in grouped_rows(torch, "serve_qwen35", cases, m, e, iters=20, plain_iters=2):
            row["shape"] = f"{label} M{m} E{e} ({touched} with rows) H{h} F{f}"
            rows.append(row)
    return rows


def decode_vs_prefill_layers(torch, eng, prompt: list) -> dict:
    """One decode step of the engine against a prefill, sub-layer by
    sub-layer: the engine prefills `prompt` and decodes its first token
    (the hidden state after every sub-layer and its expert ids recorded
    around `_paged_gdn_decode` and `_paged_layer_decode`), then
    `forward_cached` prefills prompt + that token (recorded around
    `cached_sublayer`) and the two are compared at the token's position:
    the relative error of each sub-layer's output and whether its top-k
    set is the same."""
    import numpy as np

    import xtuner_tpu_torch.model.paged_generate as pg

    model, dev = eng.model, eng.device
    dec, pre = [], []
    gdn, full = pg._paged_gdn_decode, pg._paged_layer_decode

    def rec_gdn(*a, **kw):
        x, r = gdn(*a, **kw)
        dec.append((x, r))
        return x, r

    def rec_full(*a, **kw):
        out = full(*a, **kw)
        dec.append((out[0], out[3]))
        return out

    pg._paged_gdn_decode, pg._paged_layer_decode = rec_gdn, rec_full
    try:
        tok = eng.generate([{"prompt_ids": prompt, "max_new_tokens": 2}])[0]["token_ids"][0]
    finally:
        pg._paged_gdn_decode, pg._paged_layer_decode = gdn, full
    slot = 0  # the engine admits into the first free slot
    sub = model.cached_sublayer

    def rec_sub(*a, **kw):
        out = sub(*a, **kw)
        pre.append((out[0], out[2]))
        return out

    model.cached_sublayer = rec_sub
    try:
        ids = torch.tensor([prompt + [tok]], device=dev)
        n = ids.shape[1]
        model.forward_cached(eng.params, ids, torch.arange(n, device=dev)[None],
                             model.init_decode_cache(1, n, torch.bfloat16, dev), 0,
                             torch.bfloat16, record_routing=True)
    finally:
        del model.cached_sublayer
    rel, same = [], []
    for (xd, rd), (xp, rp) in zip(dec, pre):
        a, b = xd[slot, 0].float(), xp[0, n - 1].float()
        rel.append(((a - b).norm() / b.norm()).item())
        same.append(bool(np.array_equal(np.sort(rd[slot, 0].cpu().numpy()),
                                        np.sort(rp[0, n - 1].cpu().numpy()))))
    first_flip = same.index(False) if False in same else len(same)
    return {"rel": rel, "first_flip": first_flip, "layers": len(dec)}


def phase_serve_qwen35(torch, seed: int, smi: str) -> dict:
    """`PagedGenerator.generate` on Qwen3.5-35B-A3B whole (34.66 B params, 40
    layers: 10 periods of 3 GatedDeltaNet and 1 gated full attention, bf16,
    random weights from the seed, gate|up drawn as one buffer) with
    `record_routing=True`: 6 requests on 4 slots (prompts of 1000 and 1
    tokens and three of 130-1000, across the 64-token bucket and the
    128-token block edges; one GRPO pair), MAX_NEW new tokens each; init
    time and peak, prefill and decode tokens/s, ms a decode step, the
    serving peak, the exact launches of #1, #5 and #6, `routed_experts`
    (N, 40, 8) with distinct ids, the GRPO pair's first token, and the
    teacher-forced re-check of the logprobs, held where re-prefill routing
    equals the recorded one (that share printed by layer). No profiler
    window opens here."""
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import count_params
    from xtuner_tpu_torch.ops import bf16_grouped as bg
    from xtuner_tpu_torch.ops.attention.flash import flash_attention
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn

    dev = torch.device("cuda")
    cfg = get_model_config(QWEN_MODEL)
    model = cfg.build()
    specs = model.param_specs()
    n_params = count_params(specs)
    if n_params != QWEN_PARAMS:
        raise AssertionError(f"{QWEN_MODEL}: {n_params} params, JAX's preset has {QWEN_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_fused_params(torch, specs, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    rng = np.random.default_rng(seed + 5)
    lens = [1000, 1, *rng.integers(130, 1000, size=3).tolist()]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    reqs = [{"prompt_ids": prompts[0], "group": "g0"}, {"prompt_ids": prompts[0], "group": "g0"},
            *[{"prompt_ids": p} for p in prompts[1:]]]
    greedy = GenerateConfig(max_length=2048, max_new_tokens=MAX_NEW, do_sample=False,
                            prefill_chunk=0, prefix_cache=False)
    t0 = time.perf_counter()
    eng = PagedGenerator(model, params, greedy, max_batch=QWEN_SLOTS, block_size=128,
                         record_routing=True)
    torch.cuda.synchronize()
    n_layers = cfg.num_hidden_layers
    say("serve_qwen35", model=QWEN_MODEL, params=n_params, layers=n_layers,
        pattern=",".join(cfg.layer_types_pattern), hidden=cfg.hidden_size,
        heads=f"{QWEN_HQ}/{QWEN_HKV}x{QWEN_D}",
        gdn=f"{cfg.linear_attention.num_v_heads}v/{cfg.linear_attention.num_k_heads}k"
            f"x{cfg.linear_attention.head_k_dim}",
        experts=f"{cfg.n_routed_experts}top{cfg.num_experts_per_tok}", dtype="bf16",
        init_s=f"{init_s:.3f}", weights_gib=f"{weights_gib:.3f}",
        engine_init_s=f"{time.perf_counter() - t0:.3f}",
        init_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        pool_layers=eng.cache.pool_k.shape[0],
        gdn_state_gib=f"{sum(s.numel() * s.element_size() + c.numel() * c.element_size() for s, c in eng.gdn_state.values()) / 2**30:.3f}")
    eng.generate([{"prompt_ids": prompts[1], "max_new_tokens": 2}])  # warm-up
    eng._prefill = _Timed(torch, eng._prefill)
    eng._decode_step = _Timed(torch, eng._decode_step)
    flash_attention.launches = 0
    paged_decode_attn.launches = 0
    bg.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "paged_decode": paged_decode_attn.launches,
                "grouped_gemm_nn": bg.grouped_gemm_bf16.launches["nn"]}
    want = {"flash_fwd": QWEN_FULL_LAYERS * eng._prefill.calls,
            "paged_decode": QWEN_FULL_LAYERS * eng._decode_step.calls,
            "grouped_gemm_nn": 2 * n_layers * (eng._prefill.calls + eng._decode_step.calls)}
    n_gen = [len(o["token_ids"]) for o in outs]
    say("serve_qwen35", requests=len(reqs), slots=QWEN_SLOTS, prompt_lens=lens,
        wall_s=f"{wall:.3f}", prefill_calls=eng._prefill.calls,
        prefill_s=f"{eng._prefill.seconds:.4f}", decode_steps=eng._decode_step.calls,
        decode_s=f"{eng._decode_step.seconds:.4f}", generated=n_gen, launches=launches,
        want=want, peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if eng._prefill.calls != len(prompts):
        raise AssertionError(f"{eng._prefill.calls} prefills for {len(prompts)} prompts: "
                             f"the GRPO sibling did not share its leader's prompt")
    if launches != want:
        raise AssertionError(f"launches {launches}, the steps imply {want}")
    for o in outs:
        r = o["routed_experts"]
        if not o["token_ids"] or len(o["logprobs"]) != len(o["token_ids"]) or \
                not all(0 <= t < cfg.vocab_size for t in o["token_ids"]) or \
                not np.isfinite(o["logprobs"]).all():
            raise AssertionError(f"bad output {o['finish_reason']} {o['token_ids'][:8]}")
        if r.shape != (len(o["token_ids"]), n_layers, QWEN_TOPK) or r.min() < 0 or \
                r.max() >= QWEN_EXPERTS or (np.diff(np.sort(r, -1), axis=-1) == 0).any():
            raise AssertionError(f"routed_experts {r.shape}: want ({len(o['token_ids'])}, "
                                 f"{n_layers}, {QWEN_TOPK}) distinct ids in [0, "
                                 f"{QWEN_EXPERTS})")
        if o["finish_reason"] == "length" and len(o["token_ids"]) != MAX_NEW:
            raise AssertionError(f"length finish with {len(o['token_ids'])} tokens")
    if outs[0]["token_ids"][0] != outs[1]["token_ids"][0] or \
            not np.array_equal(outs[0]["routed_experts"][0], outs[1]["routed_experts"][0]):
        raise AssertionError("the GRPO sibling's first token or routing differs from its "
                             "leader's (greedy, one prompt)")
    eng.check_block_conservation()
    if eng.cache.tables:
        raise AssertionError("sequences left in the pool")
    prefilled, decoded = sum(lens), sum(n_gen) - len(outs)
    say("serve_qwen35", prefill_tokens=prefilled,
        prefill_tok_s=f"{prefilled / eng._prefill.seconds:.1f}", decode_tokens=decoded,
        decode_tok_s=f"{decoded / eng._decode_step.seconds:.1f}",
        decode_ms_per_step=f"{1e3 * eng._decode_step.seconds / eng._decode_step.calls:.3f}",
        card=repr(smi))

    # teacher-forced re-check: prompt + generated tokens in one prefill (the
    # flash forward for the full layers, the chunked recurrence for the
    # linear ones), with its routing at the positions that made the tokens
    def teacher_forced(prompt, toks, extra_pad):
        ids = prompt + toks
        n = len(ids)
        pb = -(-n // 64) * 64 + extra_pad
        padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
        padded[0, :n] = torch.tensor(ids, device=dev)
        pos = torch.clamp(torch.arange(pb, device=dev), max=n - 1)[None]
        mask = (torch.arange(pb, device=dev) < n)[None]
        logits, _, routing = model.forward_cached(
            params, padded, pos, model.init_decode_cache(1, pb, torch.bfloat16, dev), 0,
            torch.bfloat16, mask, record_routing=True,
            n_valid=torch.full((1,), n, dtype=torch.long, device=dev))
        p = len(prompt)
        lps = torch.log_softmax(logits[0, p - 1:p - 1 + len(toks)], dim=-1)
        lps = lps.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0].cpu()
        return lps, np.sort(routing[0, p - 1:p - 1 + len(toks)].cpu().numpy(), -1)

    diffs, floor, layers, floor_layers = [], [], [], []
    for req, o in zip(reqs, outs):
        tf, rout = teacher_forced(req["prompt_ids"], o["token_ids"], 0)
        tf_pad, rout_pad = teacher_forced(req["prompt_ids"], o["token_ids"], 64)
        diffs.append((tf - torch.tensor(o["logprobs"])).abs())
        floor.append((tf - tf_pad).abs())
        layers.append((rout == np.sort(o["routed_experts"], -1)).all(-1))
        floor_layers.append((rout == rout_pad).all(-1))
    # by generated position (the first comes from the prefill itself)
    by_pos = torch.stack([d[:MAX_NEW] for d in diffs if len(d) >= MAX_NEW]).mean(0)
    agree_by_pos = np.stack([x.all(1)[:MAX_NEW] for x in layers if len(x) >= MAX_NEW]).mean(0)
    say("serve_qwen35", tf_mean_abs_by_position=",".join(f"{x:.3f}" for x in by_pos.tolist()),
        floor_mean_abs_by_position=",".join(f"{x:.3f}" for x in torch.stack(
            [d[:MAX_NEW] for d in floor if len(d) >= MAX_NEW]).mean(0).tolist()),
        routing_agree_all_layers_by_position=",".join(f"{x:.2f}" for x in agree_by_pos))
    diffs, floor = torch.cat(diffs), torch.cat(floor)
    layers, floor_layers = np.concatenate(layers), np.concatenate(floor_layers)
    agree = torch.from_numpy(layers.all(1))
    share, layer0 = agree.float().mean().item(), float(layers[:, 0].mean())
    tf_max, tf_mean = diffs.max().item(), diffs.mean().item()
    held = "all positions"
    if not (tf_max <= TF_MAX_ATOL and tf_mean <= TF_MEAN_ATOL) and \
            share >= QWEN_ALL_LAYERS_AGREE_MIN and layer0 >= OSS_ROUTING_AGREE_MIN:
        tf_max, tf_mean = diffs[agree].max().item(), diffs[agree].mean().item()
        held = "positions whose routing agrees in every layer"
    say("serve_qwen35", teacher_forced_max_abs=f"{diffs.max().item():.4e}",
        mean_abs=f"{diffs.mean().item():.4e}", held_on=repr(held),
        held_max_abs=f"{tf_max:.4e}", held_mean_abs=f"{tf_mean:.4e}",
        tol=f"max<={TF_MAX_ATOL},mean<={TF_MEAN_ATOL}", positions=int(agree.numel()),
        routing_agree_all_layers=f"{share:.4f}", routing_agree_layer0=f"{layer0:.4f}",
        routing_agree_by_layer=",".join(f"{x:.3f}" for x in layers.mean(0)),
        prefill_vs_prefill_max_abs=f"{floor.max().item():.4e}",
        prefill_vs_prefill_mean_abs=f"{floor.mean().item():.4e}",
        prefill_vs_prefill_routing_agree_all_layers=f"{floor_layers.all(1).mean():.4f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if not (tf_max <= TF_MAX_ATOL and tf_mean <= TF_MEAN_ATOL):
        raise AssertionError(f"teacher-forced logprobs disagree with decode on {held}: max "
                             f"{tf_max}, mean {tf_mean} (routing agrees in every layer at "
                             f"{share:.4f} of the positions, at layer 0 at {layer0:.4f})")
    # the decode path layer by layer, up to its first routing flip
    for prompt in (prompts[0], prompts[2], prompts[1]):
        cmp = decode_vs_prefill_layers(torch, eng, prompt)
        held_rel = cmp["rel"][:min(cmp["first_flip"], len(cfg.layer_types_pattern))]
        say("serve_qwen35", decode_vs_prefill_prompt=len(prompt), sublayers=cmp["layers"],
            first_routing_flip=cmp["first_flip"],
            rel_by_layer=",".join(f"{x:.4f}" for x in cmp["rel"]),
            held_max_rel=f"{max(held_rel, default=0.0):.4e}", tol=QWEN_LAYER_RTOL)
        if cmp["layers"] != n_layers or cmp["first_flip"] < 1 or \
                max(held_rel, default=0.0) > QWEN_LAYER_RTOL:
            raise AssertionError(f"one decode step disagrees with a prefill of the same "
                                 f"position (prompt of {len(prompt)}): {cmp}")
    return launches


@contextlib.contextmanager
def routed_ids():
    """The expert ids (B L, K) each MoE layer's router returns, in call
    order, while the context is open (`model/moe.py`'s `moe_mlp_forward`
    wrapped; a remat "full" step routes each layer again in its
    backward)."""
    from unittest import mock

    from xtuner_tpu_torch.model import moe

    used = []
    orig = moe.moe_mlp_forward

    def spy(*a, **kw):
        out = orig(*a, **kw)
        used.append(out[1].topk_idx.detach().clone())
        return out

    with mock.patch.object(moe, "moe_mlp_forward", spy):
        yield used


def oss_forward(torch, eng, batch):
    """The engine's model on the batch's first micro-batch, no grad and no
    replay: (CE, each MoE layer's top-k ids (B L, K))."""
    from xtuner_tpu_torch.data_proto import SequenceContext

    mb = {k: v[0] for k, v in eng._to_device(batch).items()}
    seq = SequenceContext(mb["input_ids"], mb["segment_ids"], mb["position_ids"])
    with torch.no_grad(), routed_ids() as used:
        out = eng.model.loss(eng._train_tree, seq, mb["shifted_labels"], mb["loss_weights"],
                             mb["loss_weights"].float().sum(), compute_dtype=eng.compute_dtype,
                             remat=eng.remat)
    return float(out.sum_ce) / max(int(out.num_tokens), 1), list(used)


def replay_step(torch, eng, batch, replay, step: int, n_moe: int) -> tuple:
    """One `train_step` with `replay` ((B, L, n_moe, K) int32) as the
    batch's rollout_routed_experts: (its metrics, its launches, whether
    every MoE layer's forward used the forced id wherever an entry is 0 or
    more, how many entries were forced)."""
    rb = dict(batch, rollout_routed_experts=replay.cpu().numpy()[None])
    reset_train_launches()
    with routed_ids() as used:
        m = eng.train_step(rb, step)
    torch.cuda.synchronize()
    launches = train_launches(torch)
    k = replay.shape[-1]
    ok = len(used) >= n_moe
    forced = 0
    for i in range(min(n_moe, len(used))):
        want = replay[:, :, i].reshape(-1, k).to(used[i].device, used[i].dtype)
        sel = want >= 0
        ok = ok and torch.equal(used[i][sel], want[sel])
        forced += int(sel.sum())
    return m, launches, ok, forced


def phase_gpt_oss_train(torch, seed: int, smi: str) -> tuple[dict, dict, object]:
    """gpt-oss-20b's first two layers at full width
    (`recipes/sft_gpt_oss_20b_head.py`, 2.804 B params: 64/8 heads of 64
    with q/k/v/o biases and sinks, layer 0 a window of 128 and layer 1
    full attention, 32 experts top-4 of width 2880 with clipped swiglu)
    through `Trainer.fit`: 4 steps on the recipe's own 8192-token rows, no
    final save (`fit_recipe`). Per step CE, grad norm, step ms, supervised
    tokens/s, maxvio, peak memory; CE finite and falling; the exact
    launches (per layer and step #1 twice under remat "full", the grouped
    backward #2 + #3 once; nn 4, nt 2, dw 2); one more step under the
    profiler (the flash kernels and AdamW apart). Then rollout-routing
    replay on the engine as the 4 steps left it: a no-grad forward records
    each MoE layer's top-k ids; one step replays them with the first half
    of each document's positions (and the padding) at -1: its CE within
    OSS_REPLAY_ATOL of the unreplayed forward's, the ids each layer used
    equal to the forced ones wherever an entry is 0 or more; then one step
    with every real position forced to those ids plus one (mod E), which
    fresh routing would not pick: the ids used are those. Last, the recipe
    for 1 step under `XTUNER_ATTN_BWD=two_pass` (#2 + #4): its step-1 CE
    within SWITCHED_LOSS_ATOL of the first run's. Returns both runs'
    launches and the segment ids (1, L) of the recipe's first row."""
    from xtuner_tpu_torch.module.params import count_params

    trainer, recs, launches, peak, wall = fit_recipe(torch, OSS_RECIPE)
    cfg, attn = trainer.cfg.model_cfg, trainer.cfg.model_cfg.attention
    eng = trainer.engine
    n = eng.num_params
    batch = next(iter(trainer.dataloader))
    trainer.dataloader.close()
    seg = torch.as_tensor(batch["segment_ids"][0]).to(torch.int32)
    n_moe = cfg.num_hidden_layers
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    say("gpt_oss_train", recipe=OSS_RECIPE, params=n, layers=f"{n_moe}/24",
        windows=repr(eng.model.moe_windows(n_moe)),
        reason=repr(f"16 B x {n / 1e9:.3f} B = {16 * n / 1e9:.1f} GB of f32 state; every "
                    f"further pair of layers adds 1.646 B params (26.3 GB)"),
        hidden=cfg.hidden_size, heads=f"{attn.num_attention_heads}/{attn.num_key_value_heads}",
        head_dim=attn.head_dim, sinks=attn.with_sinks, qkv_o_bias=attn.qkv_bias and attn.o_bias,
        experts=f"{cfg.n_routed_experts}/top{cfg.num_experts_per_tok}",
        moe_inter=cfg.moe_intermediate_size, act=cfg.hidden_act, vocab=cfg.vocab_size,
        ce=cfg.lm_loss_cfg.mode, remat=eng.remat, docs=int(seg.max()), wall_s=f"{wall:.3f}",
        save="skipped")
    for r in recs:
        say("gpt_oss_train", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", maxvio=f"{r['maxvio']:.4f}", skipped=int(r["skipped"]),
            peak_gib=f"{peak:.3f}")
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    per = n_moe
    want = {name: 0 for name in launches}
    step_want = dict(flash_fwd=2 * per, flash_bwd=per, grouped_gemm_nn=4 * per,
                     grouped_gemm_nt=2 * per, grouped_gemm_dw=2 * per)
    want.update({k_: OSS_STEPS * v_ for k_, v_ in step_want.items()})
    say("gpt_oss_train", launches={k_: v_ for k_, v_ in launches.items() if v_ or want[k_]},
        expected={k_: v_ for k_, v_ in want.items() if v_}, steady_step_ms=f"{1e3 * step_s:.1f}",
        steady_tgs=f"{tokens / step_s:.1f}", pack_positions_s=f"{SEQ / step_s:.1f}",
        peak_gib=f"{peak:.3f}", card_gib=f"{card_gib:.3f}", card=repr(smi))
    losses = check_fit("gpt_oss_train", recs, OSS_STEPS, OSS_LOSS1)
    if n != OSS_HEAD_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"{n} params, not the recipe's {OSS_HEAD_PARAMS}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what {OSS_STEPS} steps imply "
                             f"{want}")
    if not peak < card_gib:
        raise AssertionError(f"peak {peak:.3f} GiB >= the card's {card_gib:.3f}")

    # ---- rollout-routing replay on the params the 4 steps left
    k, e = cfg.num_experts_per_tok, cfg.n_routed_experts
    fresh_ce, fresh = oss_forward(torch, eng, batch)
    b, l = batch["input_ids"].shape[1:]
    ids = torch.stack([t.reshape(b, l, k) for t in fresh[:n_moe]], dim=2).to(torch.int32)
    segd = seg.to(ids.device)
    counts = [torch.unique_consecutive(row, return_counts=True)[1] for row in segd]
    lens = torch.cat([c.repeat_interleave(c) for c in counts])  # each position's document
    pos = torch.as_tensor(batch["position_ids"][0]).to(ids.device).reshape(-1)
    second_half = ((pos >= (lens + 1) // 2) & (segd.reshape(-1) != 0)).reshape(b, l)
    replay = torch.where(second_half[..., None, None], ids, -1).to(torch.int32)
    m, rlaunches, used_ok, forced = replay_step(torch, eng, batch, replay, OSS_STEPS + 1, n_moe)
    one = {name: 0 for name in rlaunches}
    one.update(step_want)
    diff = abs(m["reduced_llm_loss"] - fresh_ce)
    say("gpt_oss_train", run="replay", forced_entries=forced,
        of=int(segd.ne(0).sum()) * n_moe * k, loss=f"{m['reduced_llm_loss']:.5f}",
        unreplayed_loss=f"{fresh_ce:.5f}", abs_diff=f"{diff:.3e}", tol=OSS_REPLAY_ATOL,
        used_equal_forced=used_ok, grad_norm=f"{m['grad_norm']:.5f}",
        maxvio=f"{m['maxvio']:.4f}", skipped=m["skipped"],
        launches={k_: v_ for k_, v_ in rlaunches.items() if v_ or one[k_]})
    if not (used_ok and diff <= OSS_REPLAY_ATOL and not m["skipped"] and rlaunches == one):
        raise AssertionError(f"the replay step: ids used equal the forced ones {used_ok}, CE "
                             f"{m['reduced_llm_loss']} vs unreplayed {fresh_ce} (> "
                             f"{OSS_REPLAY_ATOL}?), skipped {m['skipped']}, launches "
                             f"{rlaunches} vs {one}")
    real = (segd != 0)[..., None, None]
    permuted = torch.where(real, (ids + 1) % e, -1).to(torch.int32)
    m2, plaunches, perm_ok, pforced = replay_step(torch, eng, batch, permuted, OSS_STEPS + 2,
                                                  n_moe)
    say("gpt_oss_train", run="replay_permuted", forced_entries=pforced,
        loss=f"{m2['reduced_llm_loss']:.5f}", used_equal_forced=perm_ok,
        grad_norm=f"{m2['grad_norm']:.5f}", maxvio=f"{m2['maxvio']:.4f}",
        skipped=m2["skipped"])
    if not (perm_ok and pforced == int(segd.ne(0).sum()) * n_moe * k and
            all(map(math.isfinite, (m2["reduced_llm_loss"], m2["grad_norm"])))):
        raise AssertionError(f"the permuted replay step: ids used equal the forced ones "
                             f"{perm_ok}, {pforced} forced, loss {m2['reduced_llm_loss']}")
    # one more step under the profiler: the flash kernels and AdamW apart
    # from the rest (the grouped GEMMs are the port's other kernels)
    with annotated(torch, MLA_TARGETS):
        profile_window(torch, "gpt_oss_train_step",
                       lambda: eng.train_step(batch, OSS_STEPS + 3), top=12,
                       annotations=tuple(MLA_TARGETS))
    del trainer, eng, batch, ids, replay, permuted
    gc.collect()
    torch.cuda.empty_cache()

    # the same recipe, seed and data, one step under the two-pass dk/dv
    trainer, trecs, tlaunches, tpeak, _ = fit_recipe(torch, OSS_RECIPE, steps=1,
                                                     env={"XTUNER_ATTN_BWD": "two_pass"})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    twant = {name: 0 for name in tlaunches}
    twant.update(step_want, flash_bwd=0, flash_bwd_two_pass=per)
    tdiff = abs(trecs[0]["reduced_llm_loss"] - losses[0])
    say("gpt_oss_train", run="two_pass", switches=repr({"attn_bwd": "two_pass"}),
        loss1=f"{trecs[0]['reduced_llm_loss']:.5f}", grouped_loss1=f"{losses[0]:.5f}",
        abs_diff=f"{tdiff:.3e}", tol=SWITCHED_LOSS_ATOL,
        grad_norm=f"{trecs[0]['grad_norm']:.5f}", grouped_grad_norm=f"{recs[0]['grad_norm']:.5f}",
        step_ms=f"{1e3 * trecs[0]['step_time']:.1f}", peak_gib=f"{tpeak:.3f}",
        launches={k_: v_ for k_, v_ in tlaunches.items() if v_ or twant[k_]},
        expected={k_: v_ for k_, v_ in twant.items() if v_})
    if not tdiff <= SWITCHED_LOSS_ATOL:
        raise AssertionError(f"the two-pass run's step-1 CE differs from the grouped run's by "
                             f"{tdiff} (> {SWITCHED_LOSS_ATOL})")
    if tlaunches != twant:
        raise AssertionError(f"the two-pass run's launches {tlaunches} != {twant}")
    return launches, tlaunches, seg


def flash_bwd_plain_by_group(torch, q, k, v, seg, lse, delta, do, scale: float, window,
                             two_pass: bool):
    """`flash_bwd_plain` one kv head's q-head group at a time (the same f32
    math with an (L, L) slab per group: 2.1 GB f32 at L8192 and 8 heads, a
    few such at once), the outputs concatenated as `flash_bwd` gives them."""
    from xtuner_tpu_torch.ops.attention.flash import flash_bwd_plain

    rep = q.shape[2] // k.shape[2]
    parts = []
    for g in range(k.shape[2]):
        hs = slice(g * rep, (g + 1) * rep)
        parts.append(flash_bwd_plain(q[:, :, hs], k[:, :, g:g + 1], v[:, :, g:g + 1], seg,
                                     lse[:, hs].contiguous(), delta[:, hs].contiguous(),
                                     do[:, :, hs], scale, two_pass, window))
    return tuple(torch.cat(ts, dim=2) for ts in zip(*parts))


def phase_gpt_oss_train_kernels(torch, seed: int, smi: str, recipe_seg) -> list[dict]:
    """The kernels of the gpt_oss_train path against their plain versions
    at the recipe's shapes, on its own packed row (`recipe_seg`): #1 and
    the backward at (64, 64), B1 L8192 with 64 q heads over 8 kv heads,
    with the window of 128 (layer 0) and in full (layer 1), from an lse
    with random sinks folded in, as the path gives them: the forward's out
    and lse (sinks folded) against `flash_plain_by_group` and its walk
    against `fwd_tile_plan`; the grouped backward (#2 + #3) and the
    two-pass one (#2 + #4) against `flash_bwd_plain_by_group`, each output
    the same bits over two launches; dsinks (`flash_backward`) against
    the formula in f64. Bounds on the pairs inside the window; the library
    time is SDPA with the window as a dense mask and no sinks (SDPA takes
    none), under the first fused backend that takes it. Then the bf16
    grouped GEMMs (#6 nn and nt, #7) at E32 H2880 F2880 (gate|up N 5760,
    down K 2880) on M = 8192 x top-4 rows, the group sizes from the
    softmax router's own top-4 route of rms-1 rows (router weights of std
    0.02), against their plain versions and `torch._grouped_mm`."""
    from xtuner_tpu_torch.module.router import GreedyRouterConfig, greedy_route
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    src = "xtuner_tpu_torch/csrc/"
    seg = recipe_seg.to(dev)
    l, hq, hkv, d = OSS_SEQ, OSS_HQ, OSS_HKV, OSS_D
    scale = d ** -0.5
    q, k, v, do = (torch.randn((1, l, h, d), generator=g, device=dev).bfloat16()
                   for h in (hq, hkv, hkv, hq))
    sinks = torch.randn((hq,), generator=g, device=dev)
    valid = seg[0] != 0
    shape = f"B1xL{l}xHq{hq}xHkv{hkv}xD{d}"
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, X) -> (H, L, X)
    rows = []
    for window in (OSS_WINDOW, None):
        label = f"window {window or 'none'}"
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg, window=window, sinks=sinks)
        torch.cuda.synchronize()
        walked = fl.fwd_tiles_walked()
        walk, plan_full = fl.fwd_tile_plan(seg, window)
        plan = (int(walk.sum()) * hq, int(plan_full.sum()) * hq)
        (ref_out, ref_lse), fwd_plain = timed_once(torch, lambda: fl.fold_sinks(
            *flash_plain_by_group(torch, q, k, v, seg, scale, window), sinks))
        fwd_err = max(_abs(out[:, valid], ref_out[:, valid]),
                      _abs(lse[..., valid], ref_lse[..., valid]))
        fwd_ok = _abs(out[:, valid], ref_out[:, valid]) <= FLASH_OUT_ATOL and \
            _abs(lse[..., valid], ref_lse[..., valid]) <= FLASH_LSE_ATOL and walked == plan
        del ref_out, ref_lse
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, seg, lse, delta, do, scale)
        res = {}
        for two_pass in (False, True):
            want, plain_ms = timed_once(torch, lambda: flash_bwd_plain_by_group(
                torch, *args, window, two_pass))
            fl.reset_launches()
            got = fl.flash_bwd(*args, two_pass, window)
            again = fl.flash_bwd(*args, two_pass, window)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            counted = fl.flash_bwd.launches["two_pass" if two_pass else "grouped"] == 2
            del again
            hf, wf = [heads_first(t) for t in got], [heads_first(t) for t in want]
            rels = [_rel_rows(t[:, valid], w[:, valid]) for t, w in zip(hf, wf)]
            err = max(_abs(t[:, valid], w[:, valid]) for t, w in zip(hf, wf))
            zero = all(bool((t[0][~valid] == 0).all()) for t in got)
            del got, want, hf, wf
            ms = cuda_ms(lambda: fl.flash_bwd(*args, two_pass, window), iters=10)
            res[two_pass] = (rels, err, same and counted, zero, ms, plain_ms)
        # dsinks, plain torch outside the kernels, against the formula in f64
        dsinks = fl.flash_backward(q, k, v, seg, out, lse, do, scale, "grouped", window,
                                   sinks)[3]
        ref_ds = -(torch.exp(sinks.double()[None, :, None] - lse.double()) *
                   delta.double()).sum(dim=(0, 2))
        ds_rel = _rel(dsinks, ref_ds)
        fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, window=window, sinks=sinks),
                         iters=10)
        mask = window_mask(torch, seg, window)
        lib_fwd, backend_fwd, how_fwd = sdpa_or_none(torch, q, k, v, mask)
        lib_bwd, backend_bwd, how_bwd = sdpa_or_none(torch, q, k, v, mask, do)
        del mask
        pairs = window_pairs(torch, seg, window)
        fwd_b = least_ms(2 * pairs * hq * (d + d), flash_bytes(q, k, dv=d), PEAK_BF16)
        say("kernel", name="flash_fwd", path="gpt_oss_train", shape=shape, seq="recipe",
            window=window, docs=int(seg.max()), pairs=pairs, err=f"{fwd_err:.3e}",
            pad_rows_ok=bool((out[:, ~valid] == 0).all()), tiles_walked=walked,
            plan_walked_full=plan, ms=f"{fwd_ms:.4f}", plain_ms=f"{fwd_plain:.1f}",
            bound_ms=f"{fwd_b['bound_ms']:.4f}", share_of_bound=f"{fwd_b['bound_ms'] / fwd_ms:.3f}",
            tflops=f"{2 * pairs * hq * 2 * d / fwd_ms / 1e9:.1f}", sdpa_ms=lib_fwd,
            sdpa_backend=backend_fwd, sdpa_how=repr(how_fwd), card=repr(smi))
        rows.append({"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
                     "function": f"flash_fwd_kernel<{d}, {d}>",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "gpt_oss_train",
                     "shape": f"{shape}, {label}", "seq": "recipe", "max_abs_err": fwd_err,
                     "ms": fwd_ms, "plain_ms": fwd_plain, **fwd_b, "library_ms": lib_fwd,
                     "library_is": f"SDPA {backend_fwd}, {how_fwd}, no sinks"})
        for two_pass in (False, True):
            rels, err, same, zero, ms, plain_ms = res[two_pass]
            bnd = bwd_bound(q, k, pairs, two_pass)
            name = "flash_bwd_two_pass" if two_pass else "flash_bwd"
            say("kernel", name=name, path="gpt_oss_train", shape=shape, seq="recipe",
                window=window, dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels),
                err=f"{err:.3e}", same_bits=same, pad_rows_ok=zero,
                dsinks_rel=f"{ds_rel:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.1f}",
                bound_ms=f"{bnd['bound_ms']:.4f}", share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
                tflops=f"{2 * 5 * d * pairs * hq / ms / 1e9:.1f}", sdpa_bwd_ms=lib_bwd,
                sdpa_backend=backend_bwd, sdpa_how=repr(how_bwd), card=repr(smi))
            for line in (199, 249 if two_pass else 303):
                rows.append({
                    "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
                    "function": f"flash_dq_kernel<{d}, {d}{', window' if window else ''}> + "
                                f"flash_dkv_kernel<{d}, {d}, {'two_pass' if two_pass else 'grouped'}"
                                f"{', window' if window else ''}>",
                    "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}",
                    "path": "gpt_oss_train_two_pass" if two_pass else "gpt_oss_train",
                    "shape": f"{shape}, {label}", "seq": "recipe", "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib_bwd,
                    "library_is": f"SDPA backward {backend_bwd}, {how_bwd}, no sinks",
                    "plain_is": "flash_bwd_plain one q-head group at a time"})
        worst = max(max(res[False][0]), max(res[True][0]))
        if not (fwd_ok and worst <= FLASH_GRAD_RTOL and ds_rel <= FLASH_LSE_ATOL and
                all(r[2] and r[3] for r in res.values())):
            raise AssertionError(f"the flash kernels at 64/64 ({label}) disagree with their "
                                 f"plain versions: forward ok {fwd_ok}, dq/dk/dv {res} (<= "
                                 f"{FLASH_GRAD_RTOL}; two launches the same bits and counted; "
                                 f"padding rows zero), dsinks {ds_rel}")
        del out, lse, delta, args
        gc.collect()
        torch.cuda.empty_cache()
    del q, k, v, do

    # ---- the MoE layer's grouped GEMMs at E32 H2880 F2880, sizes from the
    # softmax router's own top-4 route of 8192 tokens
    e, hid, f, topk = OSS_EXPERTS, OSS_H, OSS_F, OSS_TOPK
    tok = torch.randn((l, hid), generator=g, device=dev)
    router = {"w": torch.randn((hid, e), generator=g, device=dev) * 0.02}
    idx = greedy_route(router, GreedyRouterConfig(), tok, topk).topk_idx
    sizes = torch.bincount(idx.flatten(), minlength=e).to(torch.int32)
    del tok, router, idx
    m = l * topk
    say("kernel", name="softmax_route_sizes", experts=e, rows=m,
        min_max=f"{int(sizes.min())},{int(sizes.max())}", empty=int((sizes == 0).sum()),
        tails=f"K {hid} % 128 = {hid % 128}, N {f} % 128 = {f % 128}")
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    for row in grouped_rows(torch, "gpt_oss_train", grouped_cases(
            x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e), m, e, iters=5, plain_iters=2):
        row["shape"] = f"M{m} E{e} H{hid} F{f}, top-{topk} route"
        rows.append(row)
    del x, w_gu, w_dn, hmid, dy_gu, dy_dn
    reset_train_launches()
    return rows


def phase_qwen35_train(torch, seed: int, smi: str) -> tuple[dict, dict, object]:
    """Qwen3.5-35B-A3B's first period at full width
    (`recipes/sft_qwen35_35b_a3b_period.py`, 4.381 B params: 3 Gated
    DeltaNet sub-layers and 1 gated full attention sub-layer of 16/2 heads
    of 256 under interleaved MRoPE, each with 256 experts top-8 of width 512
    and a gated shared expert, vocab 248,320) through `Trainer.fit`: 4
    steps on the recipe's own 8192-token rows, no final save
    (`fit_recipe`). Per step CE, grad norm, step ms, supervised tokens/s,
    maxvio, peak memory beside the card's name and power limit; CE finite
    and falling; the exact launches (per step #1 twice and #2 + #3 once in
    the full sub-layer; per MoE sub-layer #6 nn 4, nt 2, #7 2). Then one
    Gated DeltaNet sub-layer's forward and backward at the recipe's shape,
    timed and profiled alone (its launches). Then rollout-routing replay on
    the engine as the 4 steps left it, in HF layer order: a no-grad forward
    records each MoE sub-layer's top-k ids; one step replays them with the
    first half of each document's positions (and the padding) at -1, its
    CE within QWEN_REPLAY_ATOL of the unreplayed forward's and the ids each
    sub-layer used equal to the forced ones; one step with every real
    position forced to those ids plus one (mod E). One more step under the
    profiler (the flash kernels, the Gated DeltaNet forwards and AdamW
    apart). Last, the recipe for 1 step under `XTUNER_ATTN_BWD=two_pass`
    (#2 + #4): its step-1 CE within SWITCHED_LOSS_ATOL of the first run's.
    Returns both runs' launches and the segment ids (1, L) of the recipe's
    first row."""
    from xtuner_tpu_torch.module.gated_deltanet import gdn_forward
    from xtuner_tpu_torch.module.params import cast_tree, count_params

    trainer, recs, launches, peak, wall = fit_recipe(torch, QWEN_TRAIN_RECIPE)
    cfg, attn = trainer.cfg.model_cfg, trainer.cfg.model_cfg.attention
    la = cfg.linear_attention
    eng = trainer.engine
    n = eng.num_params
    batch = next(iter(trainer.dataloader))
    trainer.dataloader.close()
    seg = torch.as_tensor(batch["segment_ids"][0]).to(torch.int32)
    n_moe = cfg.num_hidden_layers
    n_full = cfg.layer_types_pattern.count("full") * n_moe // len(cfg.layer_types_pattern)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    say("qwen35_train", recipe=QWEN_TRAIN_RECIPE, params=n, layers=f"{n_moe}/40",
        pattern=",".join(cfg.layer_types_pattern),
        reason=repr(f"16 B x {n / 1e9:.3f} B = {16 * n / 1e9:.1f} GB of f32 state; every "
                    f"further period adds 3.36 B params (53.8 GB)"),
        hidden=cfg.hidden_size, heads=f"{attn.num_attention_heads}/{attn.num_key_value_heads}",
        head_dim=attn.head_dim, gate=attn.with_gate, rope=cfg.rope_scaling_cfg.rope_type,
        mrope_section=cfg.rope_scaling_cfg.mrope_section,
        gdn=f"{la.num_v_heads}v/{la.num_k_heads}kx{la.head_k_dim} chunk {la.chunk_size}",
        experts=f"{cfg.n_routed_experts}/top{cfg.num_experts_per_tok}",
        moe_inter=cfg.moe_intermediate_size, shared_gate=cfg.with_shared_expert_gate,
        vocab=cfg.vocab_size, ce=cfg.lm_loss_cfg.mode, remat=eng.remat, docs=int(seg.max()),
        wall_s=f"{wall:.3f}", save="skipped")
    for r in recs:
        say("qwen35_train", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", maxvio=f"{r['maxvio']:.4f}", skipped=int(r["skipped"]),
            peak_gib=f"{peak:.3f}", card=repr(smi))
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    step_want = dict(flash_bwd=n_full, grouped_gemm_nn=4 * n_moe, grouped_gemm_nt=2 * n_moe,
                     grouped_gemm_dw=2 * n_moe)
    want = {name: 0 for name in launches}
    want.update({k_: QWEN_TRAIN_STEPS * v_ for k_, v_ in step_want.items()})
    fwd = launches["flash_fwd"] + launches["flash_fwd_max_free"]
    got = {k_: v_ for k_, v_ in launches.items() if k_ not in ("flash_fwd", "flash_fwd_max_free")}
    want_rest = {k_: v_ for k_, v_ in want.items() if k_ in got}
    say("qwen35_train", launches={k_: v_ for k_, v_ in launches.items() if v_ or want[k_]},
        expected={**{k_: v_ for k_, v_ in want_rest.items() if v_},
                  "flash_fwd (either variant)": 2 * n_full * QWEN_TRAIN_STEPS},
        steady_step_ms=f"{1e3 * step_s:.1f}", steady_tgs=f"{tokens / step_s:.1f}",
        pack_positions_s=f"{SEQ / step_s:.1f}", peak_gib=f"{peak:.3f}",
        card_gib=f"{card_gib:.3f}", card=repr(smi))
    losses = check_fit("qwen35_train", recs, QWEN_TRAIN_STEPS, QWEN_TRAIN_LOSS1)
    if n != QWEN_TRAIN_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"{n} params, not the recipe's {QWEN_TRAIN_PARAMS}")
    if got != want_rest or fwd != 2 * n_full * QWEN_TRAIN_STEPS:
        raise AssertionError(f"kernel launches {launches} != what {QWEN_TRAIN_STEPS} steps "
                             f"imply {want} (flash forward {2 * n_full * QWEN_TRAIN_STEPS})")
    if not peak < card_gib:
        raise AssertionError(f"peak {peak:.3f} GiB >= the card's {card_gib:.3f}")

    # ---- one Gated DeltaNet sub-layer's recurrence alone: forward and
    # backward at the recipe's shape (JAX has no kernel there; plain torch)
    with torch.no_grad():
        lp = cast_tree(eng._train_tree["pattern"]["p0"][0]["attn"], eng.compute_dtype)
    segd = seg.to("cuda")
    xg = torch.randn((1, SEQ, cfg.hidden_size), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed + 31)).bfloat16()

    def gdn_fwd_bwd():
        x_ = xg.detach().requires_grad_(True)
        y = gdn_forward(lp, la, x_, segd)
        y.float().square().mean().backward()
        return x_.grad

    dx = gdn_fwd_bwd()
    ok_gdn = bool(torch.isfinite(dx.float()).all())
    gdn_ms = cuda_ms(gdn_fwd_bwd, iters=3, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gdn_fwd_bwd()
    gdn_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    say("qwen35_train", run="gdn_sublayer", shape=f"B1xL{SEQ}xH{cfg.hidden_size}",
        chunks=SEQ // la.chunk_size, fwd_bwd_ms=f"{gdn_ms:.3f}", finite_dx=ok_gdn,
        peak_extra_gib=f"{gdn_peak:.3f}", card=repr(smi))
    if not ok_gdn:
        raise AssertionError("the Gated DeltaNet backward gave a non-finite dx")
    profile_window(torch, "qwen35_gdn_sublayer_fwd_bwd", gdn_fwd_bwd, top=6)
    del lp, xg, dx

    # ---- rollout-routing replay on the params the 4 steps left, HF layer order
    k, e = cfg.num_experts_per_tok, cfg.n_routed_experts
    fresh_ce, fresh = oss_forward(torch, eng, batch)
    b, l = batch["input_ids"].shape[1:]
    ids = torch.stack([t.reshape(b, l, k) for t in fresh[:n_moe]], dim=2).to(torch.int32)
    segd = seg.to(ids.device)
    counts = [torch.unique_consecutive(row, return_counts=True)[1] for row in segd]
    lens = torch.cat([c.repeat_interleave(c) for c in counts])  # each position's document
    pos = torch.as_tensor(batch["position_ids"][0]).to(ids.device).reshape(-1)
    second_half = ((pos >= (lens + 1) // 2) & (segd.reshape(-1) != 0)).reshape(b, l)
    replay = torch.where(second_half[..., None, None], ids, -1).to(torch.int32)
    m, rlaunches, used_ok, forced = replay_step(torch, eng, batch, replay,
                                                QWEN_TRAIN_STEPS + 1, n_moe)
    one = {name: 0 for name in rlaunches}
    one.update(step_want)
    rfwd = rlaunches.pop("flash_fwd") + rlaunches.pop("flash_fwd_max_free")
    for key in ("flash_fwd", "flash_fwd_max_free"):
        one.pop(key)
    diff = abs(m["reduced_llm_loss"] - fresh_ce)
    say("qwen35_train", run="replay", forced_entries=forced,
        of=int(segd.ne(0).sum()) * n_moe * k, loss=f"{m['reduced_llm_loss']:.5f}",
        unreplayed_loss=f"{fresh_ce:.5f}", abs_diff=f"{diff:.3e}", tol=QWEN_REPLAY_ATOL,
        used_equal_forced=used_ok, grad_norm=f"{m['grad_norm']:.5f}",
        maxvio=f"{m['maxvio']:.4f}", skipped=m["skipped"], flash_fwd=rfwd,
        launches={k_: v_ for k_, v_ in rlaunches.items() if v_ or one[k_]})
    if not (used_ok and diff <= QWEN_REPLAY_ATOL and not m["skipped"] and rlaunches == one
            and rfwd == 2 * n_full):
        raise AssertionError(f"the replay step: ids used equal the forced ones {used_ok}, CE "
                             f"{m['reduced_llm_loss']} vs unreplayed {fresh_ce} (> "
                             f"{QWEN_REPLAY_ATOL}?), skipped {m['skipped']}, launches "
                             f"{rlaunches} vs {one}, flash forward {rfwd}")
    real = (segd != 0)[..., None, None]
    permuted = torch.where(real, (ids + 1) % e, -1).to(torch.int32)
    m2, _, perm_ok, pforced = replay_step(torch, eng, batch, permuted, QWEN_TRAIN_STEPS + 2,
                                          n_moe)
    say("qwen35_train", run="replay_permuted", forced_entries=pforced,
        loss=f"{m2['reduced_llm_loss']:.5f}", used_equal_forced=perm_ok,
        grad_norm=f"{m2['grad_norm']:.5f}", maxvio=f"{m2['maxvio']:.4f}",
        skipped=m2["skipped"])
    if not (perm_ok and pforced == int(segd.ne(0).sum()) * n_moe * k and
            all(map(math.isfinite, (m2["reduced_llm_loss"], m2["grad_norm"])))):
        raise AssertionError(f"the permuted replay step: ids used equal the forced ones "
                             f"{perm_ok}, {pforced} forced, loss {m2['reduced_llm_loss']}")
    # one more step under the profiler: the flash kernels, the Gated DeltaNet
    # forwards (the recompute's too; their backward is in the rest) and
    # AdamW apart from the rest (the grouped GEMMs are the port's other kernels)
    targets = {**MLA_TARGETS, "gdn_fwd": [("xtuner_tpu_torch.model.hybrid", "gdn_forward")]}
    with annotated(torch, targets):
        profile_window(torch, "qwen35_train_step",
                       lambda: eng.train_step(batch, QWEN_TRAIN_STEPS + 3), top=12,
                       annotations=tuple(targets))
    del trainer, eng, batch, ids, replay, permuted
    gc.collect()
    torch.cuda.empty_cache()

    # the same recipe, seed and data, one step under the two-pass dk/dv
    trainer, trecs, tlaunches, tpeak, _ = fit_recipe(torch, QWEN_TRAIN_RECIPE, steps=1,
                                                     env={"XTUNER_ATTN_BWD": "two_pass"})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    twant = {name: 0 for name in tlaunches}
    twant.update(step_want, flash_bwd=0, flash_bwd_two_pass=n_full)
    tfwd = tlaunches["flash_fwd"] + tlaunches["flash_fwd_max_free"]
    for key in ("flash_fwd", "flash_fwd_max_free"):
        twant[key] = tlaunches[key]
    tdiff = abs(trecs[0]["reduced_llm_loss"] - losses[0])
    say("qwen35_train", run="two_pass", switches=repr({"attn_bwd": "two_pass"}),
        loss1=f"{trecs[0]['reduced_llm_loss']:.5f}", grouped_loss1=f"{losses[0]:.5f}",
        abs_diff=f"{tdiff:.3e}", tol=SWITCHED_LOSS_ATOL,
        grad_norm=f"{trecs[0]['grad_norm']:.5f}", grouped_grad_norm=f"{recs[0]['grad_norm']:.5f}",
        step_ms=f"{1e3 * trecs[0]['step_time']:.1f}", peak_gib=f"{tpeak:.3f}",
        launches={k_: v_ for k_, v_ in tlaunches.items() if v_ or twant[k_]},
        expected={k_: v_ for k_, v_ in twant.items() if v_})
    if not tdiff <= SWITCHED_LOSS_ATOL:
        raise AssertionError(f"the two-pass run's step-1 CE differs from the grouped run's by "
                             f"{tdiff} (> {SWITCHED_LOSS_ATOL})")
    if tlaunches != twant or tfwd != 2 * n_full:
        raise AssertionError(f"the two-pass run's launches {tlaunches} != {twant}")
    return launches, tlaunches, seg


def phase_qwen35_train_kernels(torch, seed: int, smi: str, recipe_seg) -> list[dict]:
    """The kernels of the qwen35_train path against their plain versions
    at the recipe's shapes: the backward at (256, 256), B1 L8192 with 16 q
    heads over 2 kv heads, on five documents and on the recipe's own row
    (`recipe_seg`), from the forward kernel's out and lse: the grouped
    backward (#2 + #3) and the two-pass one (#2 + #4) against
    `flash_bwd_plain_by_group`, each output the same bits over two
    launches, padding rows exactly zero; the bound on the visible pairs;
    the library time SDPA's backward with the documents as a dense mask,
    under the first fused backend that takes it. Then the bf16 grouped
    GEMMs (#6 nn and nt, #7) at E256 H2048 F512 (gate|up N1024, down K512)
    on M = 8192 x top-8 rows, the group sizes from the softmax router's own
    top-8 route of rms-1 rows (router weights of std 0.02), against their
    plain versions and `torch._grouped_mm`."""
    import numpy as np

    from xtuner_tpu_torch.module.router import GreedyRouterConfig, greedy_route
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 29)
    rng = np.random.default_rng(seed + 29)
    src = "xtuner_tpu_torch/csrc/"
    l, hq, hkv, d = QWEN_SEQ, QWEN_HQ, QWEN_HKV, QWEN_D
    scale = d ** -0.5
    q, k, v, do = (torch.randn((1, l, h, d), generator=g, device=dev).bfloat16()
                   for h in (hq, hkv, hkv, hq))
    shape = f"B1xL{l}xHq{hq}xHkv{hkv}xD{d}"
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, X) -> (H, L, X)
    rows = []
    for label, seg in (("docs", _segments(torch, doc_lengths(rng, l, 5, 250), l, dev)),
                       ("recipe", recipe_seg.to(dev))):
        valid = seg[0] != 0
        pairs = causal_pairs(torch, seg)
        # #1 as the path runs it (the preset's norms give a bound above
        # MAX_FREE_BOUND at init: the running-max variant), then its out and
        # lse feed the backward
        (ref_out, ref_lse), fwd_plain = timed_once(
            torch, lambda: flash_plain_by_group(torch, q, k, v, seg, scale, None))
        out, lse = fl.flash_attention(q, k, v, seg)
        fwd_err = max(_abs(out[:, valid], ref_out[:, valid]),
                      _abs(lse[..., valid], ref_lse[..., valid]))
        fwd_ok = _abs(out[:, valid], ref_out[:, valid]) <= FLASH_OUT_ATOL and \
            _abs(lse[..., valid], ref_lse[..., valid]) <= FLASH_LSE_ATOL
        del ref_out, ref_lse
        fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg), iters=10)
        mask = block_causal_mask(torch, seg)
        lib_fwd, backend_fwd, how_fwd = sdpa_or_none(torch, q, k, v, mask)
        fwd_b = least_ms(2 * pairs * hq * (d + d), flash_bytes(q, k, dv=d), PEAK_BF16)
        say("kernel", name="flash_fwd", path="qwen35_train", shape=shape, seq=label,
            docs=int(seg.max()), pairs=pairs, err=f"{fwd_err:.3e}", ok=fwd_ok,
            ms=f"{fwd_ms:.4f}", plain_ms=f"{fwd_plain:.1f}", bound_ms=f"{fwd_b['bound_ms']:.4f}",
            bound_by=fwd_b["bound_by"], share_of_bound=f"{fwd_b['bound_ms'] / fwd_ms:.3f}",
            sdpa_ms=lib_fwd, sdpa_backend=backend_fwd, sdpa_how=repr(how_fwd), card=repr(smi))
        if not fwd_ok:
            raise AssertionError(f"#1 at 256/256 ({label}) disagrees with its plain version: "
                                 f"{fwd_err}")
        rows.append({"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
                     "function": f"flash_fwd64_kernel<{d}, {d}>",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "qwen35_train",
                     "shape": f"{shape}, running max", "seq": label, "max_abs_err": fwd_err,
                     "ms": fwd_ms, "plain_ms": fwd_plain, **fwd_b, "library_ms": lib_fwd,
                     "library_is": f"SDPA {backend_fwd}, {how_fwd}"})
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, seg, lse, delta, do, scale)
        res = {}
        for two_pass in (False, True):
            want, plain_ms = timed_once(torch, lambda: flash_bwd_plain_by_group(
                torch, *args, None, two_pass))
            fl.reset_launches()
            got = fl.flash_bwd(*args, two_pass)
            again = fl.flash_bwd(*args, two_pass)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            counted = fl.flash_bwd.launches["two_pass" if two_pass else "grouped"] == 2
            del again
            hf, wf = [heads_first(t) for t in got], [heads_first(t) for t in want]
            rels = [_rel_rows(t[:, valid], w[:, valid]) for t, w in zip(hf, wf)]
            err = max(_abs(t[:, valid], w[:, valid]) for t, w in zip(hf, wf))
            zero = all(bool((t[0][~valid] == 0).all()) for t in got)
            del got, want, hf, wf
            ms = cuda_ms(lambda: fl.flash_bwd(*args, two_pass), iters=10)
            res[two_pass] = (rels, err, same and counted, zero, ms, plain_ms)
        lib_bwd, backend_bwd, how_bwd = sdpa_or_none(torch, q, k, v, mask, do)
        del mask
        for two_pass in (False, True):
            rels, err, same, zero, ms, plain_ms = res[two_pass]
            bnd = bwd_bound(q, k, pairs, two_pass)
            name = "flash_bwd_two_pass" if two_pass else "flash_bwd"
            say("kernel", name=name, path="qwen35_train", shape=shape, seq=label,
                docs=int(seg.max()), pairs=pairs, dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels),
                err=f"{err:.3e}", same_bits=same, pad_rows_ok=zero, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.1f}", bound_ms=f"{bnd['bound_ms']:.4f}",
                bound_by=bnd["bound_by"], share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
                tflops=f"{2 * 10 * d * pairs * hq / ms / 1e9:.1f}", sdpa_bwd_ms=lib_bwd,
                sdpa_backend=backend_bwd, sdpa_how=repr(how_bwd), card=repr(smi))
            for line in (199, 249 if two_pass else 303):
                rows.append({
                    "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
                    "function": f"flash_dq_kernel<{d}, {d}> + flash_dkv_kernel<{d}, {d}, "
                                f"{'two_pass' if two_pass else 'grouped'}>",
                    "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}",
                    "path": "qwen35_train_two_pass" if two_pass else "qwen35_train",
                    "shape": shape, "seq": label, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, **bnd, "library_ms": lib_bwd,
                    "library_is": f"SDPA backward {backend_bwd}, {how_bwd}",
                    "plain_is": "flash_bwd_plain one q-head group at a time"})
        worst = max(max(res[False][0]), max(res[True][0]))
        if not (worst <= FLASH_GRAD_RTOL and all(r[2] and r[3] for r in res.values())):
            raise AssertionError(f"the backward kernels at 256/256 ({label}) disagree with "
                                 f"their plain versions: {res} (<= {FLASH_GRAD_RTOL}; two "
                                 f"launches the same bits and counted; padding rows zero)")
        del out, lse, delta, args
        gc.collect()
        torch.cuda.empty_cache()
    del q, k, v, do

    # ---- a MoE sub-layer's grouped GEMMs at E256 H2048 F512, sizes from the
    # softmax router's own top-8 route of 8192 tokens
    e, hid, f, topk = QWEN_EXPERTS, QWEN_H, QWEN_F, QWEN_TOPK
    tok = torch.randn((l, hid), generator=g, device=dev)
    router = {"w": torch.randn((hid, e), generator=g, device=dev) * 0.02}
    idx = greedy_route(router, GreedyRouterConfig(), tok, topk).topk_idx
    sizes = torch.bincount(idx.flatten(), minlength=e).to(torch.int32)
    del tok, router, idx
    m = l * topk
    say("kernel", name="softmax_route_sizes", path="qwen35_train", experts=e, rows=m,
        min_max=f"{int(sizes.min())},{int(sizes.max())}", empty=int((sizes == 0).sum()))
    x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
    dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
    dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
    for row in grouped_rows(torch, "qwen35_train", grouped_cases(
            x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e), m, e, iters=5, plain_iters=2):
        row["shape"] = f"M{m} E{e} H{hid} F{f}, top-{topk} route"
        rows.append(row)
    del x, w_gu, w_dn, hmid, dy_gu, dy_dn
    reset_train_launches()
    return rows


def noncausal_pairs(torch, seg) -> int:
    """(query, key) pairs inside the segments, both ways (segment 0,
    padding, excluded): what non-causal attention computes."""
    total = 0
    for row in seg.cpu():
        ids, counts = torch.unique_consecutive(row, return_counts=True)
        total += sum(n * n for i, n in zip(ids.tolist(), counts.tolist()) if i)
    return total


def phase_vlm_train(torch, seed: int, smi: str) -> tuple[dict, dict, object]:
    """Qwen3-VL-4B whole (`recipes/sft_qwen3_vl_4b.py`, 4.438 B params: a
    24-block tower of 16 heads of 64 with deepstack after blocks 5, 11 and
    17, the merger and 3 deepstack mergers, 36 text layers of 32/8 heads of
    128 under interleaved MRoPE, a tied vocab of 151,936) through
    `Trainer.fit`: 4 steps on the recipe's own rows (8192 tokens, 32,768
    patch rows), no final save (`fit_recipe`). Per step CE, grad norm, step
    ms, supervised tokens/s, peak memory beside the card's name and power
    limit, and the row's documents, images, patches and tokens; CE finite
    and falling; the exact launches (per step the text layers' #1 72 times
    and #2 + #3 36, the tower's non-causal #1 48 and #2 + #3 24). Then the
    vision tower's forward and backward alone at the recipe's first row
    (ms), one profiled step (the vision blocks, the text layers' pieces,
    the flash kernels and AdamW apart), and the recipe for 1 step under
    `XTUNER_ATTN_BWD=two_pass` (#2 + #4 in both), its step-1 CE within
    SWITCHED_LOSS_ATOL of the first run's. Returns both runs' launches and
    the vision segment ids (1, P) of the first row."""
    from unittest import mock

    from xtuner_tpu_torch.data_proto import SequenceContext
    from xtuner_tpu_torch.engine.train_engine import VLM_BATCH_KEYS, TrainEngine
    from xtuner_tpu_torch.model import qwen3_vl
    from xtuner_tpu_torch.module.params import count_params
    from xtuner_tpu_torch.ops.attention import flash as fl

    rows, batches = [], []
    step = TrainEngine.train_step

    def spy(self, batch, i):  # the row each step trains on, and the step's own peak
        vseg = batch["vision_segment_ids"][0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(self, batch, i)
        rows.append({"docs": int(batch["segment_ids"].max()), "images": int(vseg.max()),
                     "patches": int((vseg != 0).sum()),
                     "image_tokens": int(batch["image_token_mask"].sum()),
                     "tokens": int((batch["segment_ids"] != 0).sum()),
                     "step_peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        if not batches:
            batches.append(batch)
        return out

    with mock.patch.object(TrainEngine, "train_step", spy):
        trainer, recs, launches, peak, wall = fit_recipe(torch, VLM_RECIPE)
    cfg = trainer.cfg.model_cfg
    v, t, dl = cfg.vision_cfg, cfg.text_cfg, trainer.cfg.dataloader_cfg
    eng = trainer.engine
    n = eng.num_params
    batch = batches[0]
    trainer.dataloader.close()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    say("vlm_train", recipe=VLM_RECIPE, params=n, cut="none",
        state_gb=f"{16 * n / 1e9:.1f}",
        vision=f"{v.depth}x{v.hidden_size} {v.num_attention_heads}x{v.head_dim} "
               f"mlp {v.intermediate_size} {v.hidden_act}",
        deepstack=v.deepstack_visual_indexes,
        text=f"{t.num_hidden_layers}x{t.hidden_size} {t.attention.num_attention_heads}/"
             f"{t.attention.num_key_value_heads}x{t.attention.head_dim} mlp "
             f"{t.intermediate_size}", vocab=t.vocab_size, tied=t.tie_word_embeddings,
        rope=t.rope_scaling_cfg.rope_type, mrope_section=t.rope_scaling_cfg.mrope_section,
        pack=dl.pack_max_length, max_patches=dl.max_patches, ce=t.lm_loss_cfg.mode,
        remat=eng.remat, wall_s=f"{wall:.3f}", save="skipped")
    for r, row in zip(recs, rows):
        say("vlm_train", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", skipped=int(r["skipped"]),
            step_peak_gib=f"{row['step_peak_gib']:.3f}", docs=row["docs"],
            images=row["images"], patches=row["patches"], image_tokens=row["image_tokens"],
            row_tokens=row["tokens"], card=repr(smi))
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    step_want = dict(flash_bwd=VLM_TEXT_LAYERS, flash_fwd_noncausal=2 * VLM_BLOCKS,
                     flash_bwd_noncausal=VLM_BLOCKS)
    want = {name: 0 for name in launches}
    want.update({k_: VLM_STEPS * v_ for k_, v_ in step_want.items()})
    fwd = launches["flash_fwd"] + launches["flash_fwd_max_free"]  # the text layers' #1
    got = {k_: v_ for k_, v_ in launches.items() if k_ not in ("flash_fwd", "flash_fwd_max_free")}
    want_rest = {k_: v_ for k_, v_ in want.items() if k_ in got}
    say("vlm_train", launches={k_: v_ for k_, v_ in launches.items() if v_ or want[k_]},
        expected={**{k_: v_ for k_, v_ in want_rest.items() if v_},
                  "flash_fwd causal (either variant)": 2 * VLM_TEXT_LAYERS * VLM_STEPS},
        steady_step_ms=f"{1e3 * step_s:.1f}", steady_tgs=f"{tokens / step_s:.1f}",
        pack_positions_s=f"{dl.pack_max_length / step_s:.1f}", peak_gib=f"{peak:.3f}",
        card_gib=f"{card_gib:.3f}", card=repr(smi))
    losses = check_fit("vlm_train", recs, VLM_STEPS, VLM_LOSS1)
    if n != VLM_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"{n} params, not the recipe's {VLM_PARAMS}")
    if got != want_rest or fwd != 2 * VLM_TEXT_LAYERS * VLM_STEPS:
        raise AssertionError(f"kernel launches {launches} != what {VLM_STEPS} steps imply "
                             f"{want} (causal flash forward {2 * VLM_TEXT_LAYERS * VLM_STEPS})")
    if not peak < card_gib:
        raise AssertionError(f"peak {peak:.3f} GiB >= the card's {card_gib:.3f}")
    if any(r["image_tokens"] * 4 != r["patches"] or r["patches"] > dl.max_patches
           for r in rows):
        raise AssertionError(f"a row's image tokens and patches disagree: {rows}")

    # ---- the tower alone, forward and backward, at the first row
    dev = torch.device("cuda")
    dbatch = {k_: torch.as_tensor(batch[k_][0]).to(dev) for k_ in
              ("input_ids", "segment_ids", "position_ids", *VLM_BATCH_KEYS)}
    seq = SequenceContext(dbatch["input_ids"], dbatch["segment_ids"], dbatch["position_ids"],
                          **{k_: dbatch[k_] for k_ in VLM_BATCH_KEYS})
    vparams = eng._train_tree["vision"]

    def tower():
        final, ds = qwen3_vl.qwen3vl_vision_forward(vparams, v, seq, eng.compute_dtype)
        loss = final.float().square().mean() + sum(d.float().square().mean() for d in ds)
        loss.backward()
        for p_ in eng._leaves:
            p_.grad = None

    fl.reset_launches()
    tower()
    tower_launches = (fl.flash_attention.noncausal_launches,
                      fl.flash_bwd.noncausal_launches["grouped"])
    tower_ms = cuda_ms(tower, iters=3, warmup=1)
    vseg = dbatch["vision_segment_ids"]
    say("vlm_train", run="tower_fwd_bwd", patches=int((vseg != 0).sum()),
        rows=int(vseg.numel()), images=int(vseg.max()), ms=f"{tower_ms:.3f}",
        launches=f"fwd {tower_launches[0]}, bwd {tower_launches[1]}", card=repr(smi))
    if tower_launches != (2 * VLM_BLOCKS, VLM_BLOCKS):
        raise AssertionError(f"the tower alone launched {tower_launches}, not "
                             f"{(2 * VLM_BLOCKS, VLM_BLOCKS)}")
    profile_window(torch, "vlm_tower_fwd_bwd", tower, top=8)
    del dbatch, seq

    # ---- one more step under the profiler: the vision blocks (forward and
    # recompute), the text layers' attention inputs and outputs (the same),
    # the flash kernels and AdamW apart; the backward GEMMs stay cuBLAS
    targets = {**MLA_TARGETS, "vision_block": [("xtuner_tpu_torch.model.qwen3_vl",
                                                "_vision_block")],
               "text_attn_in": [("xtuner_tpu_torch.model.dense", "Dense._attn_in")],
               "text_post": [("xtuner_tpu_torch.model.dense", "Dense._dense_post")]}
    with annotated(torch, targets):
        profile_window(torch, "vlm_train_step",
                       lambda: eng.train_step(batch, VLM_STEPS + 1), top=12,
                       annotations=tuple(targets))
    vision_seg = torch.as_tensor(batch["vision_segment_ids"][0][None]).to(torch.int32)
    del trainer, eng, batch, batches, vparams
    gc.collect()
    torch.cuda.empty_cache()

    # the same recipe, seed and data, one step under the two-pass dk/dv
    trainer, trecs, tlaunches, tpeak, _ = fit_recipe(torch, VLM_RECIPE, steps=1,
                                                     env={"XTUNER_ATTN_BWD": "two_pass"})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    twant = {name: 0 for name in tlaunches}
    twant.update(step_want, flash_bwd=0, flash_bwd_noncausal=0,
                 flash_bwd_two_pass=VLM_TEXT_LAYERS, flash_bwd_two_pass_noncausal=VLM_BLOCKS)
    tfwd = tlaunches["flash_fwd"] + tlaunches["flash_fwd_max_free"]
    for key in ("flash_fwd", "flash_fwd_max_free"):
        twant[key] = tlaunches[key]
    tdiff = abs(trecs[0]["reduced_llm_loss"] - losses[0])
    say("vlm_train", run="two_pass", switches=repr({"attn_bwd": "two_pass"}),
        loss1=f"{trecs[0]['reduced_llm_loss']:.5f}", grouped_loss1=f"{losses[0]:.5f}",
        abs_diff=f"{tdiff:.3e}", tol=SWITCHED_LOSS_ATOL,
        grad_norm=f"{trecs[0]['grad_norm']:.5f}", grouped_grad_norm=f"{recs[0]['grad_norm']:.5f}",
        step_ms=f"{1e3 * trecs[0]['step_time']:.1f}", peak_gib=f"{tpeak:.3f}",
        launches={k_: v_ for k_, v_ in tlaunches.items() if v_ or twant[k_]},
        expected={k_: v_ for k_, v_ in twant.items() if v_})
    if not tdiff <= SWITCHED_LOSS_ATOL:
        raise AssertionError(f"the two-pass run's step-1 CE differs from the grouped run's by "
                             f"{tdiff} (> {SWITCHED_LOSS_ATOL})")
    if tlaunches != twant or tfwd != 2 * VLM_TEXT_LAYERS:
        raise AssertionError(f"the two-pass run's launches {tlaunches} != {twant}")
    return launches, tlaunches, vision_seg


def phase_vlm_kernels(torch, seed: int, smi: str, recipe_vseg) -> list[dict]:
    """#1-#4 non-causal at (64, 64) against their plain versions at the
    tower's shapes, 16 q heads over 16 kv heads: on the recipe's own vision
    row (`recipe_vseg`, 32,768 patch rows: its images and a padded tail)
    and on an odd row (segments of 1, 100 and 4097 patches, P = 4198, not a
    multiple of 128), as `noncausal_rows` holds them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 37)
    return noncausal_rows(torch, g, smi, (("recipe", recipe_vseg.to(dev)),
                                          ("odd", _segments(torch, VLM_ODD, sum(VLM_ODD), dev))),
                          VLM_HQ, VLM_D, "vlm_train", "vlm_train_two_pass")


def noncausal_rows(torch, g, smi: str, segs, hq: int, d: int, path: str, two_pass_path=None,
                   fwd_only: bool = False) -> list[dict]:
    """#1-#4 non-causal at (d, d) against their plain versions on each
    (label, (1, P) segment ids) of `segs`, `hq` q heads over as many kv
    heads (the towers have no GQA); rows longer than 8192 hold the plain
    versions in `PLAIN_CHUNK`-row chunks (`flash_plain_chunked`). Per row:
    the forward's out and lse, its k tiles walked and walked unmasked
    against `fwd_tile_plan(causal=False)` (a mismatch fails); unless
    `fwd_only` (a frozen tower runs no backward), both backward
    instantiations (grouped #2 + #3 on `path`, two-pass #2 + #4 on
    `two_pass_path`) with two launches the same bits and padding rows
    zero; times, the plain versions' times, the bound on the visible pairs
    (at the head dim, not at the 128-column tiles 72 runs on), and SDPA's
    forward and backward with the block-diagonal mask as a dense mask as
    the library time. The kernels line's names end in "_72" at head dim
    72."""
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    src = "xtuner_tpu_torch/csrc/"
    sfx = "_72" if d == 72 else ""
    tiles = ", on 128-column tiles" if d == 72 else ""
    scale = d ** -0.5
    heads_first = lambda t: t[0].transpose(0, 1)  # (B, L, H, X) -> (H, L, X)
    rows = []
    for label, seg in segs:
        seg = seg.to(dev).to(torch.int32).contiguous()
        l = seg.shape[1]
        chunked = l > 8192
        q, k, v, do = (torch.randn((1, l, hq, d), generator=g, device=dev).bfloat16()
                       for _ in range(4))
        valid = seg[0] != 0
        pairs = noncausal_pairs(torch, seg)
        shape = f"B1xP{l}xHq{hq}xHkv{hq}xD{d}, {int(seg.max())} segments, {int(valid.sum())} rows"
        if chunked:
            (ro, rl), fwd_plain = timed_once(torch, lambda: flash_plain_chunked(
                torch, q, k, v, seg, None, None, None, scale, "fwd", causal=False))
            ref_out, ref_lse = ro.transpose(0, 1)[None], rl[None]
        else:
            (ref_out, ref_lse), fwd_plain = timed_once(torch, lambda: fl.flash_attention_plain(
                q, k, v, seg, scale, causal=False))
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg, causal=False)
        torch.cuda.synchronize()
        walked, full = fl.fwd_tiles_walked()
        walk, plan_full = fl.fwd_tile_plan(seg, causal=False)
        plan = (int(walk.sum()) * hq, int(plan_full.sum()) * hq)
        counted = fl.flash_attention.noncausal_launches == 1
        fwd_err = max(_abs(out[:, valid], ref_out[:, valid]),
                      _abs(lse[..., valid], ref_lse[..., valid]))
        fwd_ok = _abs(out[:, valid], ref_out[:, valid]) <= FLASH_OUT_ATOL and \
            _abs(lse[..., valid], ref_lse[..., valid]) <= FLASH_LSE_ATOL and \
            bool((out[:, ~valid] == 0).all()) and bool((lse[..., ~valid] == 1e30).all())
        del ref_out, ref_lse
        fwd_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, causal=False), iters=10)
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]  # padding sees padding: no empty row
        lib_fwd, backend_fwd, how_fwd = sdpa_or_none(torch, q, k, v, mask)
        fwd_b = least_ms(2 * pairs * hq * (d + d), flash_bytes(q, k, dv=d), PEAK_BF16)
        say("kernel", name="flash_fwd_noncausal" + sfx, path=path, shape=shape, seq=label,
            pairs=pairs, err=f"{fwd_err:.3e}", ok=fwd_ok, ms=f"{fwd_ms:.4f}",
            plain_ms=f"{fwd_plain:.1f}", bound_ms=f"{fwd_b['bound_ms']:.4f}",
            bound_by=fwd_b["bound_by"], share_of_bound=f"{fwd_b['bound_ms'] / fwd_ms:.3f}",
            tflops=f"{2 * pairs * hq * 2 * d / fwd_ms / 1e9:.1f}", tiles_walked=walked,
            tiles_full=full, plan_walked_full=f"{plan[0]},{plan[1]}", sdpa_ms=lib_fwd,
            sdpa_backend=backend_fwd, sdpa_how=repr(how_fwd), card=repr(smi))
        if not (fwd_ok and counted and (walked, full) == plan):
            raise AssertionError(f"#1 non-causal at {d}/{d} ({label}): error {fwd_err} (ok "
                                 f"{fwd_ok}), counted {counted}, walked {(walked, full)} "
                                 f"against the plan {plan}")
        rows.append({"name": "flash_fwd_noncausal" + sfx, "route": "cuda",
                     "source": src + "flash_fwd.cu",
                     "function": f"flash_fwd_kernel<{d}, {d}, non-causal{tiles}>",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": path,
                     "shape": f"{shape}, running max", "seq": label, "max_abs_err": fwd_err,
                     "ms": fwd_ms, "plain_ms": fwd_plain, **fwd_b, "library_ms": lib_fwd,
                     "library_is": f"SDPA {backend_fwd}, block-diagonal dense mask, {how_fwd}"})
        if fwd_only:
            del q, k, v, do, out, lse, mask
            gc.collect()
            torch.cuda.empty_cache()
            continue
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, seg, lse, delta, do, scale)
        res = {}
        for two_pass in (False, True):
            if chunked:
                (dq_w, (dk_w, dv_w)), plain_ms = timed_once(torch, lambda: (
                    flash_plain_chunked(torch, q, k, v, seg, lse, delta, do, scale, "dq",
                                        causal=False),
                    flash_plain_chunked(torch, q, k, v, seg, lse, delta, do, scale, "dkv",
                                        causal=False)))
                wf = [dq_w, dk_w, dv_w]  # (H, L, X); group 1: grouped = per q head
            else:
                want, plain_ms = timed_once(torch, lambda: fl.flash_bwd_plain(
                    *args, two_pass, causal=False))
                wf = [heads_first(t) for t in want]
                del want
            fl.reset_launches()
            got = fl.flash_bwd(*args, two_pass, causal=False)
            again = fl.flash_bwd(*args, two_pass, causal=False)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            counted = fl.flash_bwd.noncausal_launches["two_pass" if two_pass else "grouped"] == 2
            del again
            hf = [heads_first(t) for t in got]
            rels = [_rel_rows(t[:, valid], w[:, valid]) for t, w in zip(hf, wf)]
            err = max(_abs(t[:, valid], w[:, valid]) for t, w in zip(hf, wf))
            zero = all(bool((t[0][~valid] == 0).all()) for t in got)
            del got, hf, wf
            ms = cuda_ms(lambda: fl.flash_bwd(*args, two_pass, causal=False), iters=10)
            res[two_pass] = (rels, err, same and counted, zero, ms, plain_ms)
        lib_bwd, backend_bwd, how_bwd = sdpa_or_none(torch, q, k, v, mask, do)
        del mask
        for two_pass in (False, True):
            rels, err, same, zero, ms, plain_ms = res[two_pass]
            bnd = bwd_bound(q, k, pairs, two_pass)
            name = ("flash_bwd_two_pass_noncausal" if two_pass else "flash_bwd_noncausal") + sfx
            say("kernel", name=name, path=path, shape=shape, seq=label, pairs=pairs,
                dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels), err=f"{err:.3e}",
                same_bits=same, pad_rows_ok=zero, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.1f}",
                bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
                share_of_bound=f"{bnd['bound_ms'] / ms:.3f}",
                tflops=f"{2 * 10 * d * pairs * hq / ms / 1e9:.1f}", sdpa_bwd_ms=lib_bwd,
                sdpa_backend=backend_bwd, sdpa_how=repr(how_bwd), card=repr(smi))
            for line in (199, 249 if two_pass else 303):
                rows.append({
                    "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
                    "function": f"flash_dq_kernel<{d}, {d}, non-causal{tiles}> + "
                                f"flash_dkv_kernel<{d}, {d}, "
                                f"{'two_pass' if two_pass else 'grouped'}, non-causal{tiles}>",
                    "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}",
                    "path": two_pass_path if two_pass else path,
                    "shape": shape, "seq": label, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, **bnd, "library_ms": lib_bwd,
                    "library_is": f"SDPA backward {backend_bwd}, block-diagonal dense mask, "
                                  f"{how_bwd}",
                    "plain_is": "flash_plain_chunked" if chunked else "flash_bwd_plain"})
        worst = max(max(res[False][0]), max(res[True][0]))
        if not (worst <= FLASH_GRAD_RTOL and all(r[2] and r[3] for r in res.values())):
            raise AssertionError(f"the non-causal backward kernels at {d}/{d} ({label}) disagree "
                                 f"with their plain versions: {res} (<= {FLASH_GRAD_RTOL}; two "
                                 f"launches the same bits and counted; padding rows zero)")
        del q, k, v, do, out, lse, delta, args
        gc.collect()
        torch.cuda.empty_cache()
    fl.reset_launches()
    return rows


def tiles_of(np, pixel_values) -> int:
    """The real tiles of a micro-batch's (T, 3, S, S) pixel_values: the
    collator pads with all-zero tiles after the last real one."""
    flat = np.abs(np.asarray(pixel_values)).reshape(len(pixel_values), -1)
    return int(flat.max(axis=1).astype(bool).sum())


def image_doc_weights(torch, mb: dict, ctx_id: int):
    """A micro-batch's loss weights kept on the documents that hold an
    image-context token (the rest zero), and their sum."""
    seg, ids = mb["segment_ids"], mb["input_ids"]
    keep = torch.zeros_like(seg, dtype=torch.bool)
    for r in range(seg.shape[0]):
        docs = torch.unique(seg[r][ids[r] == ctx_id])
        keep[r] = torch.isin(seg[r], docs[docs != 0])
    w = torch.where(keep, mb["loss_weights"], torch.zeros_like(mb["loss_weights"]))
    return w, w.float().sum()


def vision_injection(torch, eng, mb: dict, ctx_id: int, tpt: int) -> dict:
    """CE (mean over the documents that hold an image) of one micro-batch
    under the engine's params, no grad: with the vision tokens as the model
    puts them (twice: the run-to-run noise), with the vision embeds zeroed,
    and with a misaligned scatter planted (the k-th context position
    takes vision token k + `tpt`, the next tile's)."""
    model, params = eng.model, eng._train_tree
    real = model.vision_embeds
    w, denom = image_doc_weights(torch, mb, ctx_id)
    seq = eng.seq_ctx(mb)

    def ce(embeds_fn):
        model.vision_embeds = embeds_fn
        try:
            with torch.no_grad():
                out = model.loss(params, seq, mb["shifted_labels"], w, denom,
                                 compute_dtype=eng.compute_dtype, remat="none")
            return float(out.loss)
        finally:
            del model.vision_embeds  # back to the class's method

    got = {"real": ce(real), "real_again": ce(real),
           "zeroed": ce(lambda *a: real(*a) * 0),
           "shifted_one_tile": ce(lambda *a: torch.roll(real(*a), -tpt, dims=0))}
    got["supervised_tokens"] = int(denom)
    return got


def phase_internvl_sft(torch, seed: int, smi: str) -> tuple:
    """BASELINE config 3: InternVL-8B (`recipes/sft_internvl_8b_vlm.py`:
    InternViT-300M frozen, the projector, Qwen3-8B's language model at full
    width cut to 6 layers) in a temporary working directory:
    - export: the recipe's seeded random weights (bf16) written by the
      port's `save_hf_checkpoint` (`write_export`): GiB and seconds;
    - train: the literal `python -m xtuner_tpu_torch.train.cli.sft
      --config recipes/sft_internvl_8b_vlm.py` (in-process, `sft.main`):
      `load_from` loads the export, 4 steps of one micro-batch of 8 rows of
      16384 tokens, the final save skipped (`Trainer._save` a no-op: it
      would write ~31 GB). Per step CE, grad norm, step ms, tgs, pack
      positions/s and the step's peak; per micro-batch its tokens, real and
      padded tiles and image-context tokens (held to the recipe's
      `MICRO_BATCHES`, and context tokens = real tiles x 256);
    - checks: every tower leaf bit-equal to the export after the run, every
      projector and text leaf moved; the exact launches a step (the
      frozen tower's #1 non-causal at 64/64 once a block, no backward; a
      text layer's #1 twice under "save_attn", the forward and its
      re-run for lse, and #2 + #3 once); the vision injection has power:
      CE with the tower's tokens against CE with them zeroed differs by
      more than VISION_CE_FLOOR, and so does a planted scatter shifted by
      one tile, while two runs of the same agree far inside it;
    - timing: the tower's forward alone at the first micro-batch (ms, its
      launches), one profiled step, then the recipe for 1 step under
      `XTUNER_ATTN_BWD=two_pass` (#2 + #4 in the text layers), its step-1
      CE within SWITCHED_LOSS_ATOL of the first run's.
    The export is deleted at the end. -> (both runs' launches, the
    tower's tile segment ids (1, 48 x 1025), the first micro-batch's
    segment ids (8, 16384))."""
    import runpy
    from unittest import mock

    import numpy as np

    from xtuner_tpu_torch.checkpoint.hf import load_hf_checkpoint
    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.model import vision
    from xtuner_tpu_torch.module.params import count_params, tree_paths
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.train.cli import sft
    from xtuner_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    recipe = str(Path(__file__).resolve().parent / INTERNVL_RECIPE)
    micro, batches = [], []
    step = TrainEngine.train_step

    def spy(self, batch, i):  # each micro-batch's tiles, and the step's own peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(self, batch, i)
        peak_s = torch.cuda.max_memory_allocated() / 2**30
        for a in range(batch["input_ids"].shape[0]):
            real = tiles_of(np, batch["pixel_values"][a])
            micro.append({"step": i, "micro_batch": a,
                          "tokens": int((batch["segment_ids"][a] != 0).sum()),
                          "real_tiles": real,
                          "padded_tiles": int(batch["pixel_values"][a].shape[0]) - real,
                          "context_tokens": int((batch["input_ids"][a] == ctx_id).sum()),
                          "step_peak_gib": peak_s})
        if not batches:
            batches.append(batch)
        return out

    with tempfile.TemporaryDirectory(prefix="xt_internvl_") as work, in_dir(work):
        ns = runpy.run_path(recipe)  # writes the demo set under work_dirs/
        ctx_id, tpt = ns["model_cfg"].image_context_token_id, ns["model_cfg"].tokens_per_tile
        t0 = time.perf_counter()
        export = Path(ns["write_export"](seed)).resolve()
        export_s = time.perf_counter() - t0
        gib = sum(f.stat().st_size for f in export.glob("*.safetensors")) / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        say("internvl_sft", export=str(export.name), export_gib=f"{gib:.3f}",
            export_s=f"{export_s:.3f}", dtype="bfloat16", seed=seed)

        reset_train_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(TrainEngine, "train_step", spy), \
                mock.patch.object(Trainer, "_save", lambda self, step, mgr=None: None):
            trainer = sft.main(["--config", recipe])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = train_launches(torch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        recs = tracker(trainer)
        eng = trainer.engine
        cfg = trainer.cfg.model_cfg
        v, t, dl = cfg.vision_cfg, cfg.text_cfg, trainer.cfg.dataloader_cfg
        n = eng.num_params
        card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
        say("internvl_sft", recipe=INTERNVL_RECIPE, params=n,
            trainable=sum(p.numel() for p in eng._leaves),
            vision=f"{v.num_hidden_layers}x{v.hidden_size} {v.num_attention_heads}x{v.head_dim} "
                   f"tile {v.image_size}/{v.patch_size} frozen",
            projector=f"{cfg.projector_cfg.in_dim}->{cfg.projector_cfg.out_dim}",
            text=f"{t.num_hidden_layers} of 36 x{t.hidden_size} {t.attention.num_attention_heads}"
                 f"/{t.attention.num_key_value_heads}x{t.attention.head_dim} mlp "
                 f"{t.intermediate_size}", cut="language model depth 36 -> "
                                               f"{t.num_hidden_layers}, every width kept",
            rows=trainer.cfg.global_batch_rows, micro_rows=trainer.cfg.micro_batch_rows,
            pack=dl.pack_max_length, max_tiles=dl.max_tiles, remat=eng.remat,
            ce=t.lm_loss_cfg.mode, wall_s=f"{wall:.3f}", save="skipped (~31 GB)")
        for r in recs:
            say("internvl_sft", step=r["step"], ce=f"{r['reduced_llm_loss']:.5f}",
                grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
                tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
                tgs=f"{r['tgs']:.1f}",
                pack_positions_s=f"{dl.pack_max_length * trainer.cfg.global_batch_rows / r['step_time']:.1f}",
                data_ms=f"{1e3 * r['data_time']:.1f}", skipped=int(r["skipped"]),
                step_peak_gib=f"{micro[r['step'] - 1]['step_peak_gib']:.3f}", card=repr(smi))
        for m in micro:
            say("internvl_sft", **{k_: v_ for k_, v_ in m.items() if k_ != "step_peak_gib"})
        steady = recs[1:]
        step_s = sum(r["step_time"] for r in steady) / len(steady)
        per_step = {"flash_fwd_noncausal": INTERNVL_VIT_BLOCKS, "flash_bwd": t.num_hidden_layers}
        want = {name: 0 for name in launches}
        want.update({k_: INTERNVL_STEPS * v_ for k_, v_ in per_step.items()})
        fwd = launches["flash_fwd"] + launches["flash_fwd_max_free"]
        got = {k_: v_ for k_, v_ in launches.items()
               if k_ not in ("flash_fwd", "flash_fwd_max_free")}
        want_rest = {k_: v_ for k_, v_ in want.items() if k_ in got}
        fwd_want = 2 * t.num_hidden_layers * INTERNVL_STEPS
        say("internvl_sft", launches={k_: v_ for k_, v_ in launches.items() if v_ or want[k_]},
            expected={**{k_: v_ for k_, v_ in want_rest.items() if v_},
                      "flash_fwd causal (either variant)": fwd_want},
            reruns="save_attn: a text layer's #1 runs twice a step (the forward, and the "
                   "backward's re-run of the attention region for lse); it holds the layer's "
                   "input and attention output (2 x 8 x 16384 x 4096 bf16)",
            steady_step_ms=f"{1e3 * step_s:.1f}", peak_gib=f"{peak:.3f}",
            card_gib=f"{card_gib:.3f}", card=repr(smi))
        check_fit("internvl_sft", recs, INTERNVL_STEPS, INTERNVL_LOSS1)
        if n != ns["PARAMS"] or n != count_params(cfg.build().param_specs()):
            raise AssertionError(f"internvl_sft: {n} params, not the recipe's {ns['PARAMS']}")
        if got != want_rest or fwd != fwd_want:
            raise AssertionError(f"internvl_sft: kernel launches {launches} != what "
                                 f"{INTERNVL_STEPS} steps imply {want} (causal flash forward "
                                 f"{fwd_want})")
        if not peak < card_gib:
            raise AssertionError(f"internvl_sft: peak {peak:.3f} GiB >= the card's {card_gib}")
        seen = tuple((m["tokens"], m["real_tiles"], m["context_tokens"]) for m in micro)
        if seen != tuple(ns["MICRO_BATCHES"]) or any(
                m["context_tokens"] != m["real_tiles"] * tpt or m["real_tiles"] > dl.max_tiles
                for m in micro):
            raise AssertionError(f"internvl_sft: micro-batches {micro} are not the recipe's "
                                 f"{ns['MICRO_BATCHES']} (or tiles and context tokens disagree)")

        # the tower frozen bit for bit, the projector and the text moved
        init = load_hf_checkpoint(export, eng.specs, eng.model.hf_key_map(), "cpu",
                                  torch.float32)
        start = dict(tree_paths(init))
        same = {"vision": [0, 0], "projector": [0, 0], "language": [0, 0]}
        for path, p_ in tree_paths(eng.params):
            same[path[0]][0] += 1
            same[path[0]][1] += int(torch.equal(p_.cpu(), start[path]))
        del init, start
        say("internvl_sft", leaves_bit_equal_to_the_export={k_: f"{s_}/{n_}" for k_, (n_, s_) in
                                                             same.items()})
        if same["vision"][1] != same["vision"][0] or same["projector"][1] or \
                same["language"][1]:
            raise AssertionError(f"internvl_sft: a frozen tower leaf changed, or a trained "
                                 f"leaf did not move: {same}")

        # the vision injection has power, and a misaligned scatter shows
        batch = batches[0]
        mb = {k_: torch.as_tensor(np.asarray(v_[0])).to(dev) for k_, v_ in batch.items()}
        inj = vision_injection(torch, eng, mb, ctx_id, tpt)
        gaps = {"zeroed": abs(inj["real"] - inj["zeroed"]),
                "shifted_one_tile": abs(inj["real"] - inj["shifted_one_tile"]),
                "noise": abs(inj["real"] - inj["real_again"])}
        say("internvl_sft", vision_injection={k_: f"{v_:.6f}" if isinstance(v_, float) else v_
                                              for k_, v_ in inj.items()},
            gaps={k_: f"{v_:.3e}" for k_, v_ in gaps.items()}, floor=VISION_CE_FLOOR)
        if not (gaps["zeroed"] > VISION_CE_FLOOR and gaps["shifted_one_tile"] > VISION_CE_FLOOR
                and gaps["noise"] < VISION_CE_FLOOR / 10):
            raise AssertionError(f"internvl_sft: the vision-injection check has no power or "
                                 f"misses a misaligned scatter: {gaps} (floor "
                                 f"{VISION_CE_FLOOR})")

        # the tower's forward alone at the first micro-batch
        pix = mb["pixel_values"]
        fl.reset_launches()
        with torch.no_grad():
            vision.vit_forward(eng._train_tree["vision"], v, pix, eng.compute_dtype)
        tower_launches = fl.flash_attention.noncausal_launches
        with torch.no_grad():
            tower_ms = cuda_ms(lambda: vision.vit_forward(eng._train_tree["vision"], v, pix,
                                                          eng.compute_dtype), iters=3, warmup=1)
        tiles = int(pix.shape[0])
        say("internvl_sft", run="tower_fwd", tiles=tiles, real_tiles=tiles_of(np, pix.cpu()),
            rows=tiles * (v.num_patches + 1), ms=f"{tower_ms:.3f}",
            launches=f"fwd {tower_launches}", card=repr(smi))
        if tower_launches != INTERNVL_VIT_BLOCKS:
            raise AssertionError(f"internvl_sft: the tower alone launched #1 {tower_launches} "
                                 f"times, not {INTERNVL_VIT_BLOCKS}")
        vit_seg = vision.tile_segments(tiles, v.num_patches + 1, "cpu")
        llm_seg = torch.as_tensor(np.asarray(batch["segment_ids"][0])).to(torch.int32)
        targets = {**MLA_TARGETS,
                   "vit_block": [("xtuner_tpu_torch.model.vision", "_vit_block")],
                   "text_attn_in": [("xtuner_tpu_torch.model.dense", "Dense._attn_in")],
                   "text_post": [("xtuner_tpu_torch.model.dense", "Dense._dense_post")]}
        with annotated(torch, targets):
            profile_window(torch, "internvl_step",
                           lambda: eng.train_step(batch, INTERNVL_STEPS + 1), top=12,
                           annotations=tuple(targets))
        loss1 = recs[0]["reduced_llm_loss"]
        shutil.rmtree(trainer.work_dir)  # the next run's tracker starts empty
        del trainer, eng, batch, batches, mb, pix
        gc.collect()
        torch.cuda.empty_cache()

        # the same recipe, export and data, one step under the two-pass dk/dv
        trainer, trecs, tlaunches, tpeak, _ = fit_recipe(
            torch, INTERNVL_RECIPE, steps=1, env={"XTUNER_ATTN_BWD": "two_pass"}, cwd=work)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        twant = {name: 0 for name in tlaunches}
        twant.update(flash_fwd_noncausal=INTERNVL_VIT_BLOCKS,
                     flash_bwd_two_pass=t.num_hidden_layers)
        for key in ("flash_fwd", "flash_fwd_max_free"):
            twant[key] = tlaunches[key]
        tfwd = tlaunches["flash_fwd"] + tlaunches["flash_fwd_max_free"]
        tdiff = abs(trecs[0]["reduced_llm_loss"] - loss1)
        say("internvl_sft", run="two_pass", switches=repr({"attn_bwd": "two_pass"}),
            loss1=f"{trecs[0]['reduced_llm_loss']:.5f}", grouped_loss1=f"{loss1:.5f}",
            abs_diff=f"{tdiff:.3e}", tol=SWITCHED_LOSS_ATOL,
            step_ms=f"{1e3 * trecs[0]['step_time']:.1f}", peak_gib=f"{tpeak:.3f}",
            launches={k_: v_ for k_, v_ in tlaunches.items() if v_ or twant[k_]})
        if not tdiff <= SWITCHED_LOSS_ATOL:
            raise AssertionError(f"internvl_sft: the two-pass step-1 CE differs by {tdiff}")
        if tlaunches != twant or tfwd != 2 * t.num_hidden_layers:
            raise AssertionError(f"internvl_sft: the two-pass run's launches {tlaunches} != "
                                 f"{twant}")
        shutil.rmtree(export)
        say("internvl_sft", export_deleted=str(export.name))
    return launches, tlaunches, vit_seg, llm_seg


def phase_internvl_kernels(torch, seed: int, smi: str, vit_seg, llm_seg) -> list[dict]:
    """The kernels of the internvl_sft path against their plain versions at
    its shapes: #1 non-causal at (64, 64), 16 heads, on the first
    micro-batch's 48 tiles of 1025 tokens as segments of one row (the
    frozen tower runs no backward); #1 (max-free) and the grouped and
    two-pass backward at 128/128, 32 q over 8 kv heads, on the first
    micro-batch's 8 rows of 16384 (the plain versions a row and a q-head
    group at a time)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 43)
    rows = noncausal_rows(torch, g, smi, (("internvit_tiles", vit_seg),), INTERNVL_HQ,
                          INTERNVL_D, "internvl_sft", fwd_only=True)
    hq, hkv, d = INTERNVL_LLM_DIMS
    rows += flash_path_rows(torch, g, llm_seg, hq, hkv, d, "internvl_sft", "recipe rows", smi,
                            True, "internvl_sft_two_pass", by_row=True)
    return rows


def same_as_init(torch, eng, seed: int, part: str) -> tuple:
    """(leaves, those bit-equal to their init) of one part of an engine
    whose masters `init_random(seed)` drew: the init redrawn leaf by leaf
    in `init_params`'s order (every leaf consumes the generator in turn),
    so no second copy of the model is held."""
    from xtuner_tpu_torch.module.params import ParamSpec, init_params

    gen = torch.Generator(device=eng.device).manual_seed(seed)
    leaves = same = 0

    def walk(spec, path):
        nonlocal leaves, same
        if not isinstance(spec, ParamSpec):
            for k_, v_ in spec.items():
                walk(v_, (*path, k_))
            return
        t = init_params(spec, gen, eng.device, torch.float32)
        if path[0] == part:
            node = eng.params
            for k_ in path:
                node = node[k_]
            leaves += 1
            same += int(torch.equal(node, t))
        del t

    walk(eng.specs, ())
    return leaves, same


def phase_vlm8b_align(torch, seed: int, smi: str) -> tuple:
    """Qwen3-VL-8B whole (`recipes/sft_qwen3_vl_8b_align.py`, 8.77 B
    params: a 27-block tower of 16 heads of 72 with deepstack, the merger
    and 3 deepstack mergers, 36 frozen text layers) through `Trainer.fit`:
    4 steps on the 4B recipe's rows (8192 tokens, 32,768 patch rows), no
    final save (`fit_recipe`). Per step CE, grad norm, step ms, tgs, the
    step's peak and its row's documents, images, patches and image tokens;
    every language leaf bit-equal to its init, every tower and merger leaf
    moved, step 1's row's CE lower under the trained params than at step
    1; the exact launches (per step the tower's #1 non-causal at 72/72
    twice a block, remat "full", and #2 + #3 once; the text layers' #1
    twice and #2 + #3 once: the frozen model still carries the gradient to
    its input embeddings). Then the tower's forward and backward alone at
    the first row (ms, launches), and the recipe for 1 step under
    `XTUNER_ATTN_BWD=two_pass` (#2 + #4 at 72/72 and in the text layers),
    its step-1 CE within SWITCHED_LOSS_ATOL of the first run's. -> (both
    runs' launches, the first row's vision segment ids (1, P))."""
    from unittest import mock

    import numpy as np

    from xtuner_tpu_torch.data_proto import SequenceContext
    from xtuner_tpu_torch.engine.train_engine import VLM_BATCH_KEYS, TrainEngine
    from xtuner_tpu_torch.model import qwen3_vl
    from xtuner_tpu_torch.module.params import count_params, tree_paths
    from xtuner_tpu_torch.ops.attention import flash as fl

    rows, batches, starts = [], [], {}
    step = TrainEngine.train_step

    def spy(self, batch, i):
        vseg = batch["vision_segment_ids"][0]
        if not starts:  # the trained leaves before step 1 (576 M params)
            starts.update({p_: t_.detach().clone() for p_, t_ in tree_paths(self.params)
                           if p_[0] != "language"})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(self, batch, i)
        rows.append({"docs": int(batch["segment_ids"].max()), "images": int(vseg.max()),
                     "patches": int((vseg != 0).sum()),
                     "image_tokens": int(batch["image_token_mask"].sum()),
                     "tokens": int((batch["segment_ids"] != 0).sum()),
                     "step_peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        if not batches:
            batches.append(batch)
        return out

    with mock.patch.object(TrainEngine, "train_step", spy):
        trainer, recs, launches, peak, wall = fit_recipe(torch, VLM8B_RECIPE)
    cfg = trainer.cfg.model_cfg
    v, t, dl = cfg.vision_cfg, cfg.text_cfg, trainer.cfg.dataloader_cfg
    eng = trainer.engine
    n = eng.num_params
    batch = batches[0]
    trainer.dataloader.close()
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    say("vlm8b_align", recipe=VLM8B_RECIPE, params=n, cut="none",
        trainable=sum(p_.numel() for p_ in eng._leaves), frozen="language",
        vision=f"{v.depth}x{v.hidden_size} {v.num_attention_heads}x{v.head_dim} "
               f"mlp {v.intermediate_size} {v.hidden_act}", deepstack=v.deepstack_visual_indexes,
        text=f"{t.num_hidden_layers}x{t.hidden_size} {t.attention.num_attention_heads}/"
             f"{t.attention.num_key_value_heads}x{t.attention.head_dim} mlp "
             f"{t.intermediate_size}", vocab=t.vocab_size, tied=t.tie_word_embeddings,
        pack=dl.pack_max_length, max_patches=dl.max_patches, ce=t.lm_loss_cfg.mode,
        remat=eng.remat, wall_s=f"{wall:.3f}", save="skipped")
    for r, row in zip(recs, rows):
        say("vlm8b_align", step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
            grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
            tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
            tgs=f"{r['tgs']:.1f}", skipped=int(r["skipped"]),
            step_peak_gib=f"{row['step_peak_gib']:.3f}", docs=row["docs"],
            images=row["images"], patches=row["patches"], image_tokens=row["image_tokens"],
            row_tokens=row["tokens"], card=repr(smi))
    steady = recs[1:]
    step_s = sum(r["step_time"] for r in steady) / len(steady)
    tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
    step_want = dict(flash_bwd=VLM8B_TEXT_LAYERS, flash_fwd_noncausal_72=2 * VLM8B_BLOCKS,
                     flash_bwd_noncausal_72=VLM8B_BLOCKS)
    want = {name: 0 for name in launches}
    want.update({k_: VLM8B_STEPS * v_ for k_, v_ in step_want.items()})
    fwd = launches["flash_fwd"] + launches["flash_fwd_max_free"]
    got = {k_: v_ for k_, v_ in launches.items() if k_ not in ("flash_fwd", "flash_fwd_max_free")}
    want_rest = {k_: v_ for k_, v_ in want.items() if k_ in got}
    say("vlm8b_align", launches={k_: v_ for k_, v_ in launches.items() if v_ or want[k_]},
        expected={**{k_: v_ for k_, v_ in want_rest.items() if v_},
                  "flash_fwd causal (either variant)": 2 * VLM8B_TEXT_LAYERS * VLM8B_STEPS},
        steady_step_ms=f"{1e3 * step_s:.1f}", steady_tgs=f"{tokens / step_s:.1f}",
        pack_positions_s=f"{dl.pack_max_length / step_s:.1f}", peak_gib=f"{peak:.3f}",
        card_gib=f"{card_gib:.3f}", card=repr(smi))
    check_recs("vlm8b_align", recs, VLM8B_STEPS)
    loss1 = recs[0]["reduced_llm_loss"]
    if not VLM8B_LOSS1[0] <= loss1 <= VLM8B_LOSS1[1]:
        raise AssertionError(f"vlm8b_align: step-1 CE {loss1} outside {VLM8B_LOSS1}")
    if n != VLM8B_PARAMS or n != count_params(cfg.build().param_specs()):
        raise AssertionError(f"vlm8b_align: {n} params, not the recipe's {VLM8B_PARAMS}")
    if got != want_rest or fwd != 2 * VLM8B_TEXT_LAYERS * VLM8B_STEPS:
        raise AssertionError(f"vlm8b_align: kernel launches {launches} != what {VLM8B_STEPS} "
                             f"steps imply {want}")
    if not peak < card_gib:
        raise AssertionError(f"vlm8b_align: peak {peak:.3f} GiB >= the card's {card_gib:.3f}")

    # the language model bit-unchanged, the tower and the mergers moved, and
    # step 1's row's CE lower under the trained params
    lang, lang_same = same_as_init(torch, eng, trainer.cfg.seed, "language")
    moved = {part: [0, 0] for part in ("vision", "projector")}
    for path, p_ in tree_paths(eng.params):
        if path[0] in moved:
            moved[path[0]][0] += 1
            moved[path[0]][1] += int(not torch.equal(p_, starts[path]))
    starts.clear()
    dev = torch.device("cuda")
    dbatch = {k_: torch.as_tensor(np.asarray(v_[0])).to(dev) for k_, v_ in batch.items()}
    with torch.no_grad():
        _, mets = eng.default_loss(eng._train_tree, dbatch, dbatch["loss_weights"].float().sum())
    after = float(mets["sum_ce"]) / int(mets["num_tokens"])
    say("vlm8b_align", language_leaves_bit_equal=f"{lang_same}/{lang}",
        moved={k_: f"{m_}/{n_}" for k_, (n_, m_) in moved.items()},
        row1_ce_step1=f"{loss1:.5f}", row1_ce_trained=f"{after:.5f}")
    if lang_same != lang or any(m_ != n_ for n_, m_ in moved.values()) or not after < loss1:
        raise AssertionError(f"vlm8b_align: language leaves bit-equal {lang_same}/{lang}, "
                             f"moved {moved}, row-1 CE {loss1} -> {after}")

    # ---- the tower alone, forward and backward, at the first row
    seq = SequenceContext(dbatch["input_ids"], dbatch["segment_ids"], dbatch["position_ids"],
                          **{k_: dbatch[k_] for k_ in VLM_BATCH_KEYS if k_ in dbatch})
    vparams = eng._train_tree["vision"]

    def tower():
        final, ds = qwen3_vl.qwen3vl_vision_forward(vparams, v, seq, eng.compute_dtype)
        loss = final.float().square().mean() + sum(d_.float().square().mean() for d_ in ds)
        loss.backward()
        for p_ in eng._leaves:
            p_.grad = None

    fl.reset_launches()
    tower()
    tower_launches = (fl.flash_attention.noncausal_by_dim.get(72, 0),
                      fl.flash_bwd.noncausal_by_dim.get(("grouped", 72), 0))
    tower_ms = cuda_ms(tower, iters=3, warmup=1)
    vseg = dbatch["vision_segment_ids"]
    say("vlm8b_align", run="tower_fwd_bwd", patches=int((vseg != 0).sum()),
        rows=int(vseg.numel()), images=int(vseg.max()), ms=f"{tower_ms:.3f}",
        launches=f"fwd {tower_launches[0]}, bwd {tower_launches[1]}", card=repr(smi))
    if tower_launches != (2 * VLM8B_BLOCKS, VLM8B_BLOCKS):
        raise AssertionError(f"vlm8b_align: the tower alone launched {tower_launches}")
    vision_seg = vseg[None].to(torch.int32).cpu()
    del trainer, eng, batch, batches, vparams, dbatch, seq
    gc.collect()
    torch.cuda.empty_cache()

    # the same recipe, seed and data, one step under the two-pass dk/dv
    trainer, trecs, tlaunches, tpeak, _ = fit_recipe(torch, VLM8B_RECIPE, steps=1,
                                                     env={"XTUNER_ATTN_BWD": "two_pass"})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    twant = {name: 0 for name in tlaunches}
    twant.update(step_want, flash_bwd=0, flash_bwd_noncausal_72=0,
                 flash_bwd_two_pass=VLM8B_TEXT_LAYERS,
                 flash_bwd_two_pass_noncausal_72=VLM8B_BLOCKS)
    tfwd = tlaunches["flash_fwd"] + tlaunches["flash_fwd_max_free"]
    for key in ("flash_fwd", "flash_fwd_max_free"):
        twant[key] = tlaunches[key]
    tdiff = abs(trecs[0]["reduced_llm_loss"] - loss1)
    say("vlm8b_align", run="two_pass", switches=repr({"attn_bwd": "two_pass"}),
        loss1=f"{trecs[0]['reduced_llm_loss']:.5f}", grouped_loss1=f"{loss1:.5f}",
        abs_diff=f"{tdiff:.3e}", tol=SWITCHED_LOSS_ATOL,
        step_ms=f"{1e3 * trecs[0]['step_time']:.1f}", peak_gib=f"{tpeak:.3f}",
        launches={k_: v_ for k_, v_ in tlaunches.items() if v_ or twant[k_]})
    if not tdiff <= SWITCHED_LOSS_ATOL:
        raise AssertionError(f"vlm8b_align: the two-pass step-1 CE differs by {tdiff}")
    if tlaunches != twant or tfwd != 2 * VLM8B_TEXT_LAYERS:
        raise AssertionError(f"vlm8b_align: the two-pass run's launches {tlaunches} != {twant}")
    return launches, tlaunches, vision_seg


def phase_vlm8b_kernels(torch, seed: int, smi: str, recipe_vseg) -> list[dict]:
    """#1-#4 non-causal at (72, 72), 16 q over 16 kv heads, against their
    plain versions on the align recipe's vision row and on segments of 1,
    100 and 4097 (P4198), as `noncausal_rows` holds them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 47)
    return noncausal_rows(torch, g, smi, (("recipe", recipe_vseg),
                                          ("odd", _segments(torch, VLM_ODD, sum(VLM_ODD), dev))),
                          VLM8B_HQ, VLM8B_D, "vlm8b_align", "vlm8b_align_two_pass")


def phase_gpt_oss_profile(torch, seed: int) -> None:
    """Where gpt-oss-20b's serving time goes (torch.profiler): the model
    and engine of `phase_serve_gpt_oss` made again, then one window of 4
    prefills of 1000-token prompts and one of 16 decode steps over those 4
    slots (#5 as `port_paged_decode_ms`; in the decode window
    `port_kernels_ms` is #6 alone, cuBLAS the attention projections, the
    router and the head). It runs last: a profiler window slows every
    later host launch in the process."""
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import init_params

    dev = torch.device("cuda")
    model = get_model_config(OSS_MODEL).build()
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                         dev, torch.bfloat16)
    rng = np.random.default_rng(seed + 5)
    vocab = model.cfg.vocab_size
    greedy = GenerateConfig(max_length=2048, max_new_tokens=MAX_NEW, do_sample=False,
                            prefill_chunk=0, prefix_cache=False)
    eng = PagedGenerator(model, params, greedy, max_batch=OSS_SLOTS, block_size=128)
    eng.generate([{"prompt_ids": [1, 2, 3], "max_new_tokens": 2}])  # warm-up
    queue = [{"prompt_ids": rng.integers(0, vocab, size=1000).tolist(), "_idx": i}
             for i in range(OSS_SLOTS)]
    results: dict = {}
    profile_window(torch, "gpt_oss_prefill_4x1000",
                   lambda: [eng._admit(i, queue.pop(0)) for i in range(OSS_SLOTS)])
    profile_window(torch, "gpt_oss_decode_16_steps",
                   lambda: [eng.tick(queue, results) for _ in range(16)])


@with_depth("qwen3-4b", RL_LAYERS)
def phase_rl_profile(torch, seed: int) -> None:
    """Where the GRPO rollout's time goes (torch.profiler): Qwen3-4B in bf16
    from the seed, `generate` on the recipe's shape (4 prompts of 128
    tokens x 8 rollouts) for 1 + 16 tokens: the prefill (#1) and 16 decode
    steps over the dense cache, in one window. It runs last, beside the
    gpt-oss profile: a profiler window slows every later host launch."""
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig, generate
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import init_params

    dev = torch.device("cuda")
    model = get_model_config("qwen3-4b").build()
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                         dev, torch.bfloat16)
    rng = np.random.default_rng(seed + 47)
    prompts = np.full((32, 128), 0, np.int64)
    for i in range(4):
        n = int(rng.integers(60, 128))
        prompts[8 * i:8 * (i + 1), -n:] = rng.integers(1, model.cfg.vocab_size, n)
    gcfg = GenerateConfig(max_new_tokens=17, temperature=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    generate(model, params, prompts, gcfg, generator=gen, prompt_group_size=8)  # warm-up
    profile_window(torch, "rl_rollout_prefill_and_16_decode_steps",
                   lambda: generate(model, params, prompts, gcfg, generator=gen,
                                    return_logprobs=True, prompt_group_size=8), top=10)
    del params


class _Timed:
    """Wraps an engine step method: host clock around the call, ending in a
    device synchronize, so the time is device work plus launch overhead."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.seconds, self.calls = torch, fn, 0.0, 0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def teacher_forced(torch, model, params, prompt: list, toks: list, extra_pad: int = 0):
    """The bf16 log-probabilities of `toks` after `prompt` from one flash
    prefill of both on the card (right-padded to a 64-token bucket, plus
    `extra_pad`), returned on the host."""
    from xtuner_tpu_torch.model.generate import _forward_cached, init_cache

    dev = torch.device("cuda")
    ids = prompt + toks
    n = len(ids)
    pb = -(-n // 64) * 64 + extra_pad
    padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
    padded[0, :n] = torch.tensor(ids, device=dev)
    pos = torch.clamp(torch.arange(pb, device=dev), max=n - 1)[None]
    mask = (torch.arange(pb, device=dev) < n)[None]
    logits, _, _ = _forward_cached(model, params, padded, pos,
                                   init_cache(model, 1, pb, torch.bfloat16, dev),
                                   0, torch.bfloat16, mask)
    p = len(prompt)
    lps = torch.log_softmax(logits[0, p - 1:p - 1 + len(toks)], dim=-1)
    return lps.gather(1, torch.tensor(toks, device=dev)[:, None])[:, 0].cpu()


@with_depth(SERVE_MODEL, SERVE_LAYERS)
def phase_engine(torch, seed: int, smi: str) -> dict:
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import count_params, init_params
    from xtuner_tpu_torch.ops.attention.flash import flash_attention
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn

    dev = torch.device("cuda")
    cfg = get_model_config("qwen3-8b")
    model = cfg.build()
    t0 = time.perf_counter()
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                         dev, torch.bfloat16)
    torch.cuda.synchronize()
    say("engine", model="qwen3-8b", params=count_params(model.param_specs()),
        layers=cfg.num_hidden_layers, hidden=cfg.hidden_size, dtype="bf16",
        init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")

    rng = np.random.default_rng(seed)
    lens = [1000, 1, *rng.integers(2, 1000, size=3).tolist()]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    # 6 requests: the 5 prompts plus a GRPO sibling of the longest one
    reqs = [{"prompt_ids": prompts[0], "group": "g0"}, {"prompt_ids": prompts[0], "group": "g0"},
            *[{"prompt_ids": p} for p in prompts[1:]]]
    greedy = GenerateConfig(max_length=2048, max_new_tokens=MAX_NEW, do_sample=False,
                            prefill_chunk=0, prefix_cache=False)

    eng = PagedGenerator(model, params, greedy, max_batch=4, block_size=128)
    eng.generate([{"prompt_ids": prompts[1], "max_new_tokens": 2}])  # warm-up
    eng._prefill = _Timed(torch, eng._prefill)
    eng._decode_step = _Timed(torch, eng._decode_step)
    flash_attention.launches = 0
    paged_decode_attn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "paged_decode": paged_decode_attn.launches}
    n_gen = [len(o["token_ids"]) for o in outs]
    if eng._prefill.calls != len(prompts):
        raise AssertionError(f"{eng._prefill.calls} prefills for {len(prompts)} prompts: "
                             f"the GRPO sibling did not share its leader's prompt")
    prefilled = sum(lens)  # prompt tokens actually prefilled (the sibling shares)
    decoded = sum(n_gen) - len(outs)  # first tokens come from prefill
    say("engine", requests=len(reqs), slots=4, wall_s=f"{wall:.3f}",
        prefill_calls=eng._prefill.calls, prefill_s=f"{eng._prefill.seconds:.4f}",
        decode_steps=eng._decode_step.calls, decode_s=f"{eng._decode_step.seconds:.4f}",
        generated=n_gen, launches=launches,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    for o in outs:
        if not o["token_ids"] or len(o["logprobs"]) != len(o["token_ids"]) or \
                not all(0 <= t < cfg.vocab_size for t in o["token_ids"]) or \
                not np.isfinite(o["logprobs"]).all():
            raise AssertionError(f"bad output {o['finish_reason']} {o['token_ids'][:8]}")
        if o["finish_reason"] == "length" and len(o["token_ids"]) != MAX_NEW:
            raise AssertionError(f"length finish with {len(o['token_ids'])} tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    eng.check_block_conservation()
    if eng.cache.tables:
        raise AssertionError("sequences left in the pool")
    prefill_tps = prefilled / eng._prefill.seconds
    decode_tps = decoded / eng._decode_step.seconds
    say("engine", prefill_tokens=prefilled, prefill_tok_s=f"{prefill_tps:.1f}",
        decode_tokens=decoded, decode_tok_s=f"{decode_tps:.1f}",
        decode_ms_per_step=f"{1e3 * eng._decode_step.seconds / eng._decode_step.calls:.3f}",
        card=repr(smi))

    # teacher-forced re-check: prompt + generated tokens in one flash prefill
    diffs, floor = [], []
    for req, o in zip(reqs, outs):
        tf = teacher_forced(torch, model, params, req["prompt_ids"], o["token_ids"])
        diffs.append((tf - torch.tensor(o["logprobs"])).abs())
        floor.append((tf - teacher_forced(torch, model, params, req["prompt_ids"],
                                          o["token_ids"], 64)).abs())
    diffs, floor = torch.cat(diffs), torch.cat(floor)
    tf_max, tf_mean = diffs.max().item(), diffs.mean().item()
    say("engine", teacher_forced_max_abs=f"{tf_max:.4e}", mean_abs=f"{tf_mean:.4e}",
        tol=f"max<={TF_MAX_ATOL},mean<={TF_MEAN_ATOL}",
        prefill_vs_prefill_max_abs=f"{floor.max().item():.4e}",
        prefill_vs_prefill_mean_abs=f"{floor.mean().item():.4e}")
    if not (tf_max <= TF_MAX_ATOL and tf_mean <= TF_MEAN_ATOL):
        raise AssertionError(f"teacher-forced logprobs disagree with decode: max "
                             f"{tf_max}, mean {tf_mean}")

    # one sampled run, serve.py's defaults
    sampled_cfg = GenerateConfig(max_length=2048, max_new_tokens=MAX_NEW, do_sample=True,
                                 temperature=0.7, top_p=0.95, prefill_chunk=0,
                                 prefix_cache=False)
    runs = []
    for _ in range(2):
        eng_s = PagedGenerator(model, params, sampled_cfg, max_batch=4, block_size=128,
                               rng=torch.Generator(device=dev).manual_seed(seed))
        runs.append([o["token_ids"] for o in eng_s.generate(reqs)])
    if runs[0] != runs[1]:
        raise AssertionError("sampled decode is not deterministic under one seed")
    if not all(0 <= t < cfg.vocab_size for toks in runs[0] for t in toks):
        raise AssertionError("sampled token out of range")
    say("engine", sampled_tokens=sum(map(len, runs[0])), deterministic=True,
        differs_from_greedy=runs[0] != [o["token_ids"] for o in outs])

    # where the time goes: two profiled windows on the greedy engine
    windows = {
        "prefill": [{"prompt_ids": p, "max_new_tokens": 1} for p in prompts[:4]],
        "decode": [{"prompt_ids": p[:1], "max_new_tokens": 17} for p in prompts[:4]],
    }
    for name, wreqs in windows.items():
        profile_window(torch, name, lambda: eng.generate(wreqs))
    return launches


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(url: str, payload=None, timeout: float = 900):
    """POST `payload` as JSON (GET without one); the JSON answer, or the
    text of a non-JSON one (/metrics)."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
    return json.loads(body) if resp.headers.get_content_type() == "application/json" else body


def http_stream(url: str, payload: dict, timeout: float = 900) -> dict:
    """A streamed completion: its token ids and logprobs, the seconds to
    the first token frame and from the first to the last."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, lps, stamps, finish = [], [], [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "error" in ev:
                raise AssertionError(f"stream error frame: {ev['error']}")
            ev = ev["choices"][0]
            if "token_id" in ev:
                stamps.append(time.perf_counter() - t0)
                toks.append(ev["token_id"])
                lps.append(ev["logprob"])
            finish = ev.get("finish_reason", finish)
    return {"token_ids": toks, "logprobs": lps, "finish_reason": finish,
            "ttft_s": stamps[0], "decode_s": stamps[-1] - stamps[0]}


def metric_sum(text: str, name: str) -> int:
    """The sum over engines of one /metrics counter."""
    return sum(int(float(ln.rsplit(" ", 1)[1])) for ln in text.splitlines()
               if ln.split("{")[0].split(" ")[0] == name)


def check_choice(label: str, ch: dict, vocab: int, max_new: int) -> None:
    toks, lps = ch["token_ids"], ch["logprobs"]["token_logprobs"]
    if not (0 < len(toks) <= max_new and len(lps) == len(toks)
            and all(0 <= t < vocab for t in toks) and all(math.isfinite(x) for x in lps)):
        raise AssertionError(f"serve_cli {label}: bad choice {ch['finish_reason']} "
                             f"{toks[:8]} {lps[:4]}")


@with_depth(SERVE_MODEL, SERVE_LAYERS)
def phase_serve_cli(torch, seed: int, smi: str) -> dict:
    """Qwen3-8B whole, exported in HF safetensors layout, served through
    the serve CLI's own code with its defaults (chunked prefill 2048, the
    prefix cache, 16 slots); then the literal `python -m
    xtuner_tpu_torch.train.cli.serve` answers one request. Returns the
    launches of #1 and #5 over the in-process server's requests."""
    import shutil
    from pathlib import Path

    from xtuner_tpu_torch.checkpoint.hf import load_hf_checkpoint, save_hf_checkpoint
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import count_params, init_params, tree_paths
    from xtuner_tpu_torch.ops.attention.flash import flash_attention
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn
    from xtuner_tpu_torch.train.cli import serve

    dev = torch.device("cuda")
    cfg = get_model_config(SERVE_MODEL)
    model = cfg.build()
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                         dev, torch.bfloat16)
    export = tempfile.mkdtemp(prefix="xt_serve_cli_")
    try:
        # 1. the export, and every leaf loaded back bit for bit
        t0 = time.perf_counter()
        save_hf_checkpoint(export, params, model.hf_key_map(), cfg)
        save_s = time.perf_counter() - t0
        gib = sum(f.stat().st_size for f in Path(export).glob("*.safetensors")) / 2**30
        t0 = time.perf_counter()
        loaded = load_hf_checkpoint(export, model.param_specs(), model.hf_key_map(), dev,
                                    torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        differ = [".".join(p) for (p, a), (_, b) in zip(tree_paths(loaded), tree_paths(params))
                  if not torch.equal(a, b)]
        say("serve_cli", model=SERVE_MODEL, params=count_params(model.param_specs()),
            export_gib=f"{gib:.3f}", export_s=f"{save_s:.3f}",
            export_gb_s=f"{gib * 2**30 / 1e9 / save_s:.3f}", load_s=f"{load_s:.3f}",
            leaves=len(list(tree_paths(loaded))), leaves_differ=len(differ), card=repr(smi))
        if differ:
            raise AssertionError(f"loaded leaves differ from the export: {differ[:5]}")
        del loaded
        gc.collect()
        torch.cuda.empty_cache()

        # 2. the server through the CLI's own code, on a free local port
        args = serve.build_parser().parse_args(["--model", export, "--host", "127.0.0.1",
                                                "--port", str(free_port())])
        t0 = time.perf_counter()
        worker = serve.build_worker(args)
        url = worker.start()
        say("serve_cli", server_load_s=f"{time.perf_counter() - t0:.3f}",
            prefill_chunk=args.prefill_chunk, max_batch=args.max_batch,
            max_length=args.max_length, tokenizer=type(worker.tokenizer).__name__)
        try:
            results = serve_cli_requests(torch, cfg, url, seed, flash_attention,
                                         paged_decode_attn)
        finally:
            worker.stop()
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_decode": paged_decode_attn.launches}
        del worker
        # the engine thread's cuBLAS handle took a workspace of its own
        # (32 MiB on sm_90), which PyTorch keeps after the thread ends: left
        # allocated, it raised a later phase's peak (qwen35_train's, at ~70
        # of 79 GiB) by as much
        gc.collect()
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        say("serve_cli", cublas_workspaces_freed_gib=(
            f"{(held - torch.cuda.memory_allocated()) / 2**30:.4f}"))
        results["hit_floor"] = serve_cli_hit_floor(torch, model, params, seed)
        serve_cli_checks(torch, model, params, results, launches)
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # 3. the literal CLI in a process of its own
        serve_cli_subprocess(export, results["short"][0]["prompt_ids"], cfg.vocab_size)
    finally:
        shutil.rmtree(export, ignore_errors=True)
    return launches


@contextlib.contextmanager
def engine_clock(torch):
    """Calls and host seconds of PagedGenerator's whole prefills, prefill
    chunks and decode steps, summed over every engine, while the block
    runs (each timed call ends in a synchronize; engines on other threads
    overlap, so the sums can exceed the wall time)."""
    import threading

    from xtuner_tpu_torch.model.paged_generate import PagedGenerator

    stats = {k: [0, 0.0] for k in ("_prefill", "_advance_prefill", "_decode_step")}
    orig = {k: getattr(PagedGenerator, k) for k in stats}
    lock = threading.Lock()

    def timed(name, fn):
        def call(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            with lock:
                stats[name][0] += 1
                stats[name][1] += time.perf_counter() - t0
            return out
        return call

    for k, fn in orig.items():
        setattr(PagedGenerator, k, timed(k, fn))
    try:
        yield stats
    finally:
        for k, fn in orig.items():
            setattr(PagedGenerator, k, fn)


def serve_cli_requests(torch, cfg, url: str, seed: int, flash_attention,
                       paged_decode_attn) -> dict:
    """Wave 1 from concurrent client threads: 4 short and 4 long
    completions (the long ones sharing a SERVE_PREFIX-token prefix, with
    top_logprobs 5), one chat, one streamed, one with a penalty,
    min_tokens, a stop id and top_logprobs 5; wave 2: the long ones again
    (prefix-cache hits); then a solo long prompt of one token (the
    prefill). Launch counts start at 0 here."""
    import threading

    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size

    def ids(n):
        return rng.integers(0, vocab, n).tolist()

    greedy = {"max_tokens": SERVE_NEW, "temperature": 0.0}
    prefix = ids(SERVE_PREFIX)
    short = [{"prompt_ids": ids(SERVE_SHORT), **greedy} for _ in range(4)]
    long = [{"prompt_ids": prefix + ids(SERVE_LONG - SERVE_PREFIX), **greedy,
             "top_logprobs": 5} for _ in range(4)]
    chat = {"messages": [{"role": "system", "content": "You are brief."},
                         {"role": "user", "content": "Name one use of an H100."}], **greedy}
    stream = {"prompt_ids": ids(SERVE_SHORT), **greedy, "stream": True}
    options = {"prompt_ids": ids(SERVE_SHORT), **greedy, "repetition_penalty": 1.3,
               "min_tokens": 8, "stop_token_ids": [vocab - 1], "top_logprobs": 5}
    out: dict = {"short": short, "long": long}

    def wave(label, jobs):
        answers, errors = {}, []

        def run(name, path, payload):
            t0 = time.perf_counter()
            try:
                res = (http_stream(url + path, payload) if payload.get("stream")
                       else http(url + path, payload))
                answers[name] = (res, t0, time.perf_counter())
            except Exception as e:  # surfaced below, after every thread joined
                errors.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=run, args=job) for job in jobs]
        t0 = time.perf_counter()
        with engine_clock(torch) as clock:
            [t.start() for t in threads]
            [t.join() for t in threads]
        wall = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"serve_cli requests failed: {errors}")
        say("serve_cli", wave=label, wall_s=f"{wall:.3f}",
            latency_s={k: round(e - t0, 3) for k, (_, _, e) in sorted(answers.items())},
            **{f"{k.strip('_')}": f"{n} calls {sec:.3f} s" for k, (n, sec) in clock.items()})
        return answers, wall

    flash_attention.launches = 0
    paged_decode_attn.launches = 0
    jobs = ([(f"short{i}", "/v1/completions", r) for i, r in enumerate(short)]
            + [(f"long{i}", "/v1/completions", r) for i, r in enumerate(long)]
            + [("chat", "/v1/chat/completions", chat), ("stream", "/v1/completions", stream),
               ("options", "/v1/completions", options)])
    out["wave1"], wall1 = wave(1, jobs)
    metrics1 = http(url + "/metrics")
    out["wave2"], wall2 = wave(2, [(f"long{i}", "/v1/completions", r)
                                   for i, r in enumerate(long)])
    metrics2 = http(url + "/metrics")
    t0 = time.perf_counter()
    http(url + "/v1/completions", {"prompt_ids": ids(SERVE_LONG), "max_tokens": 1,
                                   "temperature": 0.0, "top_logprobs": 5})
    prefill_s = time.perf_counter() - t0
    health = http(url + "/health")

    w1 = out["wave1"]
    gen1 = sum(len(ch["token_ids"]) for name, (res, _, _) in w1.items() if name != "stream"
               for ch in res["choices"] if "token_ids" in ch) + len(w1["stream"][0]["token_ids"])
    prompt1 = sum(len(r["prompt_ids"]) for r in short + long) + 2 * SERVE_SHORT
    st = w1["stream"][0]
    say("serve_cli", wave1_requests=len(w1), wave1_wall_s=f"{wall1:.3f}",
        wave1_prompt_tokens=prompt1, wave1_generated_tokens=gen1,
        wave1_generated_tok_s=f"{gen1 / wall1:.1f}",
        ttft_s=f"{st['ttft_s']:.3f}", stream_tokens=len(st["token_ids"]),
        stream_decode_tok_s=f"{(len(st['token_ids']) - 1) / max(st['decode_s'], 1e-9):.1f}",
        wave2_wall_s=f"{wall2:.3f}", solo_prefill_s=f"{prefill_s:.3f}",
        solo_prefill_tok_s=f"{SERVE_LONG / prefill_s:.1f}", health=health)
    out["chunked"] = (metric_sum(metrics1, "xtuner_engine_chunked_prefills"),
                      metric_sum(metrics2, "xtuner_engine_chunked_prefills"))
    out["cached_tokens"] = (metric_sum(metrics1, "xtuner_prefix_cache_cached_tokens"),
                            metric_sum(metrics2, "xtuner_prefix_cache_cached_tokens"))
    say("serve_cli", chunked_prefills=out["chunked"], prefix_cached_tokens=out["cached_tokens"],
        prefix_hits=metric_sum(metrics2, "xtuner_prefix_cache_hits"),
        engines=metric_sum(metrics2, "xtuner_engine_slots_total") // 16)
    return out


def top_gap(miss: dict, hit: dict) -> tuple:
    """(ids the two top-5 sets share, the largest logprob gap over them)."""
    common = set(miss) & set(hit)
    return len(common), max((abs(miss[t] - hit[t]) for t in common), default=math.inf)


def hit_agrees(reading: tuple) -> bool:
    common, gap = reading
    return common >= SERVE_HIT_SHARED and gap <= SERVE_HIT_ATOL


def serve_cli_hit_floor(torch, model, params, seed: int, seeds: int = SERVE_HIT_SEEDS) -> dict:
    """Where SERVE_HIT_ATOL sits: the hit-vs-miss reading of a long prompt
    (first-token top-5 logprobs: the ids both share, the largest gap over
    them) on an engine of the CLI's settings, for `seeds` prompts, and with
    the adopted blocks planted wrong before the hit reads them: zeroed (a
    table at the trash block), rolled by one block, another prompt's
    blocks, and another prompt's last block alone."""
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator

    cfg, dev = model.cfg, params["embed"]["w"].device
    g = GenerateConfig(max_new_tokens=1, do_sample=False, temperature=0.0,
                       eos_token_id=cfg.eos_token_id, max_length=4096,
                       prefill_chunk=SERVE_PREFILL_CHUNK, top_logprobs=5)
    pg = PagedGenerator(model, params, g, max_batch=2, block_size=128,
                        compute_dtype=torch.bfloat16,
                        rng=torch.Generator(device=dev).manual_seed(seed))
    pool = (pg.cache.pool_k, pg.cache.pool_v)

    def top(prompt):
        out = pg.generate([{"prompt_ids": prompt}])[0]
        return dict(zip(out["top_logprob_ids"][0].tolist(), out["top_logprobs"][0].tolist()))

    def blocks(prompt):
        ids = pg.prefix_cache.lookup(prompt, len(prompt) - 1)
        pg.cache.allocator.release(ids)
        return torch.as_tensor(ids, device=dev)

    readings: dict = {}
    kinds = ["seed"] * seeds + ["zeroed", "rolled", "other", "one_block"]
    for k, kind in enumerate(kinds):
        rng = np.random.default_rng(seed + 100 + k)
        prompt = rng.integers(0, cfg.vocab_size, SERVE_LONG).tolist()
        pg.prefix_cache.flush()
        miss = top(prompt)
        if kind != "seed":
            ids = blocks(prompt)
            if kind in ("other", "one_block"):
                other = rng.integers(0, cfg.vocab_size, SERVE_LONG).tolist()
                top(other)
                src = blocks(other)
            if kind == "one_block":
                ids, src = ids[-1:], src[-1:]
            for p in pool:
                p[:, ids] = (0 if kind == "zeroed" else
                             p[:, ids.roll(1)] if kind == "rolled" else p[:, src])
        readings.setdefault(kind, []).append(top_gap(miss, top(prompt)))
    del pg, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("serve_cli", hit_floor=readings, hit_tol=(SERVE_HIT_SHARED, SERVE_HIT_ATOL))
    return readings


def serve_cli_checks(torch, model, params, out: dict, launches: dict) -> None:
    """Every answer well formed; the options request honoured min_tokens and
    its stop id; chunked prefills and prefix-cached tokens counted; #1 and
    #5 launched; a long and a short greedy answer's logprobs against a
    teacher-forced forward; each long prompt's first-token top-5 logprobs
    from the hit against the miss, and the floor's readings (`hit_agrees`):
    the seeds' pass, every gather planted wrong in content fails."""
    vocab = model.cfg.vocab_size
    w1, w2 = out["wave1"], out["wave2"]
    for name, (res, _, _) in list(w1.items()) + [(f"{k}'", v) for k, v in w2.items()]:
        if name == "stream":
            if not res["token_ids"] or res["finish_reason"] not in ("stop", "length"):
                raise AssertionError(f"serve_cli stream: {res}")
        elif name == "chat":
            if not isinstance(res["choices"][0]["message"]["content"], str):
                raise AssertionError(f"serve_cli chat: {res}")
        else:
            check_choice(name, res["choices"][0], vocab, SERVE_NEW)
    opt = w1["options"][0]["choices"][0]
    stops = {vocab - 1, model.cfg.eos_token_id}
    if stops & set(opt["token_ids"][:8]) or (opt["finish_reason"] == "stop") != \
            (opt["token_ids"][-1] in stops):
        raise AssertionError(f"serve_cli options: min_tokens / stop id not honoured {opt}")
    if not (out["chunked"][0] > 0 and out["cached_tokens"][1] > out["cached_tokens"][0]):
        raise AssertionError(f"serve_cli: chunked prefills {out['chunked']}, prefix-cached "
                             f"tokens {out['cached_tokens']}")
    say("serve_cli", launches=launches)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the serve CLI's path never launched: {launches}")
    diffs = []
    for req, name in ((out["long"][0], "long0"), (out["short"][0], "short0")):
        ch = w1[name][0]["choices"][0]
        tf = teacher_forced(torch, model, params, req["prompt_ids"], ch["token_ids"])
        diffs.append((tf - torch.tensor(ch["logprobs"]["token_logprobs"])).abs())
    diffs = torch.cat(diffs)
    hit = []
    for i in range(4):
        miss = w1[f"long{i}"][0]["choices"][0]["logprobs"]["top_logprobs"][0]
        again = w2[f"long{i}"][0]["choices"][0]["logprobs"]["top_logprobs"][0]
        hit.append(top_gap({int(t): v for t, v in miss.items()},
                           {int(t): v for t, v in again.items()}))
    floor = out["hit_floor"]
    if not all(map(hit_agrees, hit + floor["seed"])):
        raise AssertionError(f"serve_cli: a hit's top-5 logprobs off its miss's: served {hit}, "
                             f"floor {floor}")
    # the check must see a gather planted wrong in content
    if any(hit_agrees(r) for k in ("zeroed", "other", "one_block") for r in floor[k]):
        raise AssertionError(f"serve_cli: a planted wrong gather passed the hit check: {floor}")
    say("serve_cli", teacher_forced_max_abs=f"{diffs.max().item():.4e}",
        teacher_forced_mean_abs=f"{diffs.mean().item():.4e}",
        tol=f"max<={TF_MAX_ATOL},mean<={TF_MEAN_ATOL}",
        hit_vs_miss_top5=hit, hit_tol=(SERVE_HIT_SHARED, SERVE_HIT_ATOL))
    if not (diffs.max().item() <= TF_MAX_ATOL and diffs.mean().item() <= TF_MEAN_ATOL):
        raise AssertionError(f"serve_cli: served logprobs disagree with the teacher-forced "
                             f"forward: max {diffs.max().item()}, mean {diffs.mean().item()}")


def serve_cli_subprocess(export: str, prompt: list, vocab: int) -> None:
    """`python -m xtuner_tpu_torch.train.cli.serve --model <dir> --port <p>`
    from the repository's root: wait for /health, one completion, stop."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log = os.path.join(export, "serve.log")
    t0 = time.perf_counter()
    with open(log, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", "xtuner_tpu_torch.train.cli.serve",
                                 "--model", export, "--port", str(port)],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=logf, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"the serve CLI exited with {proc.returncode}: "
                                         f"{open(log).read()[-3000:]}")
                if time.perf_counter() - t0 > SERVE_HEALTH_S:
                    raise AssertionError(f"the serve CLI gave no /health in {SERVE_HEALTH_S} s")
                try:
                    health = http(url + "/health", timeout=5)
                    break
                except OSError:
                    time.sleep(1.0)
            up_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            res = http(url + "/v1/completions", {"prompt_ids": prompt, "max_tokens": 8,
                                                 "temperature": 0.0})
            check_choice("subprocess", res["choices"][0], vocab, 8)
            say("serve_cli", subprocess_health=health, subprocess_up_s=f"{up_s:.3f}",
                subprocess_request_s=f"{time.perf_counter() - t1:.3f}",
                subprocess_tokens=res["choices"][0]["token_ids"])
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def ce_chunks(n: int, vocab: int) -> int:
    """Row chunks of one fused-CE backward over n rows: its coefficient
    kernel's launches."""
    from xtuner_tpu_torch.ops.fused_ce import ce_chunk_plan

    return len(ce_chunk_plan(n, vocab).chunks)


def reset_train_launches() -> None:
    from xtuner_tpu_torch.ops import bf16_grouped, fp8_gemm, fp8_grouped, fused_ce, fused_moe_mlp
    from xtuner_tpu_torch.ops.attention import block_sparse, flash

    for mod in (flash, bf16_grouped, fused_ce, fp8_gemm, fp8_grouped, block_sparse,
                fused_moe_mlp):
        mod.reset_launches()


def train_launches(torch) -> dict:
    """Every training kernel's launches since `reset_train_launches`."""
    from xtuner_tpu_torch.ops import fused_ce as fc
    from xtuner_tpu_torch.ops.attention import block_sparse as bs
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.ops.bf16_grouped import grouped_gemm_bf16, grouped_gemm_bf16_dw
    from xtuner_tpu_torch.ops.fp8_gemm import fp8_gemm_tilewise
    from xtuner_tpu_torch.ops.fp8_grouped import fp8_grouped_gemm, fp8_grouped_gemm_dw
    from xtuner_tpu_torch.ops.fused_moe_mlp import fused_moe_mlp_fwd

    nc, nc_bwd = fl.flash_attention.noncausal_launches, fl.flash_bwd.noncausal_launches
    nc72 = fl.flash_attention.noncausal_by_dim.get(72, 0)
    nc72_bwd = {k: fl.flash_bwd.noncausal_by_dim.get((k, 72), 0) for k in nc_bwd}
    # the non-causal forward (the vision towers) takes no max-logit bound:
    # the running-max variant; "_noncausal" counts 64/64 (Qwen3-VL-4B's and
    # InternViT's heads), "_noncausal_72" 72/72 (Qwen3-VL-8B's)
    return {"flash_fwd": fl.flash_attention.launches - fl.max_free_launches() - nc,
            "flash_fwd_max_free": fl.max_free_launches(),
            "flash_fwd_noncausal": nc - nc72,
            "flash_fwd_noncausal_72": nc72,
            "flash_bwd": fl.flash_bwd.launches["grouped"] - nc_bwd["grouped"],
            "flash_bwd_two_pass": fl.flash_bwd.launches["two_pass"] - nc_bwd["two_pass"],
            "flash_bwd_noncausal": nc_bwd["grouped"] - nc72_bwd["grouped"],
            "flash_bwd_two_pass_noncausal": nc_bwd["two_pass"] - nc72_bwd["two_pass"],
            "flash_bwd_noncausal_72": nc72_bwd["grouped"],
            "flash_bwd_two_pass_noncausal_72": nc72_bwd["two_pass"],
            "fused_moe_mlp": fused_moe_mlp_fwd.launches,
            "grouped_gemm_nn": grouped_gemm_bf16.launches["nn"],
            "grouped_gemm_nt": grouped_gemm_bf16.launches["nt"],
            "grouped_gemm_dw": grouped_gemm_bf16_dw.launches,
            "ce_fwd": fc.ce_fwd.launches, "ce_coeff": fc.ce_coeff.launches,
            "ce_dh": fc.ce_dh.launches, "ce_dw": fc.ce_dw.launches,
            "fp8_gemm": fp8_gemm_tilewise.launches, "fp8_grouped_gemm": fp8_grouped_gemm.launches,
            "fp8_grouped_dw": fp8_grouped_gemm_dw.launches,
            "block_sparse_fwd": bs.block_sparse_fwd.launches,
            "block_sparse_bwd": bs.block_sparse_bwd.launches}


def phase_train(torch, seed: int, smi: str) -> dict:
    import numpy as np

    from xtuner_tpu_torch.config.optim import AdamWConfig, LRConfig
    from xtuner_tpu_torch.datasets.collator import sft_llm_collator
    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.parallel.mesh import MeshConfig

    dev = torch.device("cuda")
    cfg = get_model_config("qwen3-moe-30b-a3")
    full_layers = cfg.num_hidden_layers
    cfg.num_hidden_layers = TRAIN_LAYERS
    eng = TrainEngine(cfg, AdamWConfig(lr=1e-4),
                      LRConfig(lr_type="constant", warmup_steps=1),
                      MeshConfig(param_dtype="bfloat16", remat_policy="full"), TRAIN_STEPS,
                      device=dev)
    n = eng.num_params
    say("train", model="qwen3-moe-30b-a3", layers=f"{TRAIN_LAYERS}/{full_layers}",
        reason=repr(f"f32 master + grad + Adam m and v take 16 B/param: "
                    f"{TRAIN_LAYERS} layers are {n / 1e9:.2f} B params = "
                    f"{16 * n / 1e9:.1f} GB; {full_layers} would need "
                    f"{16 * n / 1e9 * full_layers / TRAIN_LAYERS:.0f} GB"),
        hidden=cfg.hidden_size, heads=f"{cfg.attention.num_attention_heads}/"
        f"{cfg.attention.num_key_value_heads}", experts=f"{cfg.n_routed_experts}"
        f"/top{cfg.num_experts_per_tok}", moe_inter=cfg.moe_intermediate_size,
        vocab=cfg.vocab_size, ce=cfg.lm_loss_cfg.mode, remat="full", compute="bf16")
    t0 = time.perf_counter()
    eng.init_random(seed)
    torch.cuda.synchronize()
    say("train", init_s=f"{time.perf_counter() - t0:.3f}",
        state_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")

    rng = np.random.default_rng(seed)
    lens = doc_lengths(rng, SEQ, 5, int(rng.integers(100, 400)))
    docs = [rng.integers(1, cfg.vocab_size, size=k).astype(np.int32) for k in lens]
    row = sft_llm_collator([[{"input_ids": d_, "labels": d_} for d_ in docs]], SEQ,
                           pad_token_id=cfg.pad_token_id)
    batch = {k: v[None] for k, v in row.items()}  # (A=1, B=1, L)
    say("train", seq=SEQ, docs=",".join(map(str, lens)), pad=SEQ - sum(lens),
        supervised=int(row["loss_weights"].sum()))

    reset_train_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for step in range(1, TRAIN_STEPS + 1):
        t0 = time.perf_counter()
        m = eng.train_step(batch, step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist.append((m, dt))
        say("train", step=step, loss=f"{m['reduced_llm_loss']:.5f}",
            total_loss=f"{m['total_loss']:.5f}", grad_norm=f"{m['grad_norm']:.5f}",
            lr=f"{m['lr']:.3e}", maxvio=f"{m['maxvio']:.3f}", skipped=m["skipped"],
            step_ms=f"{1e3 * dt:.1f}", tok_s=f"{SEQ / dt:.1f}",
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    launches = train_launches(torch)
    per = TRAIN_LAYERS * TRAIN_STEPS
    want = {"flash_fwd": 0, "flash_fwd_max_free": 2 * per, "flash_fwd_noncausal": 0,
            "flash_bwd": per, "flash_bwd_two_pass": 0, "flash_bwd_noncausal": 0,
            "flash_bwd_two_pass_noncausal": 0, "flash_fwd_noncausal_72": 0,
            "flash_bwd_noncausal_72": 0, "flash_bwd_two_pass_noncausal_72": 0,
            "fused_moe_mlp": 0, "grouped_gemm_nn": 4 * per, "grouped_gemm_nt": 2 * per,
            "grouped_gemm_dw": 2 * per, "ce_fwd": 0, "ce_coeff": 0, "ce_dh": 0, "ce_dw": 0,
            "fp8_gemm": 0, "fp8_grouped_gemm": 0, "fp8_grouped_dw": 0,
            "block_sparse_fwd": 0, "block_sparse_bwd": 0}
    steady = [dt for _, dt in hist[1:]]
    say("train", launches=launches, expected=want,
        steady_step_ms=f"{1e3 * sum(steady) / len(steady):.1f}",
        steady_tok_s=f"{SEQ * len(steady) / sum(steady):.1f}", card=repr(smi))
    losses = [m["reduced_llm_loss"] for m, _ in hist]
    norms = [m["grad_norm"] for m, _ in hist]
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
    if not TRAIN_LOSS1[0] <= losses[0] <= TRAIN_LOSS1[1]:
        raise AssertionError(f"step-1 loss {losses[0]} outside {TRAIN_LOSS1}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if any(m["skipped"] for m, _ in hist):
        raise AssertionError("a step was skipped")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != what the step implies {want}")

    profile_window(torch, "train_step", lambda: eng.train_step(batch, TRAIN_STEPS + 1),
                   top=16)
    return launches


def phase_sft(torch, smi: str, breakdown: bool, fp8_ref_loss1=None,
              switched_ref=None) -> tuple[dict, list]:
    """The port's SFT entry point as a user runs it: the `sft` CLI's
    `main(["--config", <recipe>])` in a temporary working directory, 6
    steps at full width and depth. Reads its tracker and its final
    checkpoint, and counts every kernel launch of the run. With
    `fp8_ref_loss1` (the bf16 run's step-1 loss) it runs the fp8 recipe and
    holds its step-1 loss within SFT_FP8_LOSS1_RTOL of that. With
    `switched_ref` (the bf16 run's losses) it runs the bf16 recipe under
    `XTUNER_ATTN_BWD=two_pass` and `XTUNER_FUSED_MLP=1` and holds every
    step's loss within SWITCHED_LOSS_ATOL of that run's. Returns the
    launches and the losses."""
    import os
    from unittest import mock

    from xtuner_tpu_torch.recipes.bench_longctx_64k import SWITCHES

    with mock.patch.dict(os.environ, SWITCHES if switched_ref is not None else {}):
        return _sft_run(torch, smi, breakdown, fp8_ref_loss1, switched_ref)


def _sft_run(torch, smi: str, breakdown: bool, fp8_ref_loss1, switched_ref):
    import os
    import tempfile
    from pathlib import Path

    import numpy as np

    from xtuner_tpu_torch.checkpoint.torch_io import TrainCheckpointManager
    from xtuner_tpu_torch.train.cli import sft

    fp8 = fp8_ref_loss1 is not None
    switched = switched_ref is not None
    phase, rel_recipe = (("sft_fp8", SFT_FP8_RECIPE) if fp8 else
                         ("sft_switched", SFT_RECIPE) if switched else ("sft", SFT_RECIPE))
    recipe = str(Path(__file__).resolve().parent / rel_recipe)
    save_s: list = []
    real_save = TrainCheckpointManager.save

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        real_save(self, *a, **kw)
        save_s.append(time.perf_counter() - t0)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="xt_sft_") as tmp:
        os.chdir(tmp)
        TrainCheckpointManager.save = timed_save
        try:
            reset_train_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = sft.main(["--config", recipe])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = train_launches(torch)
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            TrainCheckpointManager.save = real_save
            os.chdir(cwd)
        work = Path(tmp) / trainer.cfg.work_dir / trainer.cfg.exp_name
        recs = [json.loads(x) for x in (work / "tracker.jsonl").read_text().splitlines()]
        step_dir = work / "checkpoints" / f"step-{SFT_STEPS}"
        committed = (step_dir / "train_state.json").exists()
        ckpt_gib = sum(p.stat().st_size for p in step_dir.iterdir()) / 2**30 \
            if step_dir.exists() else 0.0
        cfg = trainer.cfg.model_cfg
        say(phase, recipe=rel_recipe, params=trainer.engine.num_params,
            layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
            heads=f"{cfg.attention.num_attention_heads}/{cfg.attention.num_key_value_heads}",
            experts=f"{cfg.n_routed_experts}/top{cfg.num_experts_per_tok}",
            moe_inter=cfg.moe_intermediate_size, vocab=cfg.vocab_size,
            ce=cfg.lm_loss_cfg.mode, remat=trainer.engine.remat,
            compute=str(trainer.engine.compute_dtype), float8=repr(cfg.float8_cfg),
            switches=repr(switch_state()), wall_s=f"{wall:.3f}")
        for r in recs:
            say(phase, step=r["step"], loss=f"{r['reduced_llm_loss']:.5f}",
                grad_norm=f"{r['grad_norm']:.5f}", lr=f"{r['lr']:.3e}",
                tokens=int(r["consumed_tokens"]), step_ms=f"{1e3 * r['step_time']:.1f}",
                tgs=f"{r['tgs']:.1f}", data_ms=f"{1e3 * r['data_time']:.2f}",
                skipped=int(r["skipped"]))
        steady = recs[1:]
        step_s = sum(r["step_time"] for r in steady) / len(steady)
        tokens = sum(r["consumed_tokens"] for r in steady) / len(steady)
        per = SFT_STEPS * SFT_LAYERS
        # per layer and step: flash once each (its residuals are kept); bf16
        # experts: gate|up and down forward, recompute and backward; fp8:
        # q, k, v and o forward and recompute (8 of #11), gate, up and down
        # forward, recompute and dgrad (9 of #12), their wgrads (3 of #13);
        # switched: the two-pass backward in place of the grouped one, the
        # fused MLP (forward and recompute) in place of the nn GEMMs
        want = {"flash_fwd": 0, "flash_fwd_max_free": per, "flash_fwd_noncausal": 0,
                "flash_bwd": 0 if switched else per,
                "flash_bwd_two_pass": per if switched else 0, "flash_bwd_noncausal": 0,
                "flash_bwd_two_pass_noncausal": 0, "flash_fwd_noncausal_72": 0,
                "flash_bwd_noncausal_72": 0, "flash_bwd_two_pass_noncausal_72": 0,
                "fused_moe_mlp": 2 * per if switched else 0,
                "grouped_gemm_nn": 0 if fp8 or switched else 4 * per,
                "grouped_gemm_nt": 0 if fp8 else 2 * per,
                "grouped_gemm_dw": 0 if fp8 else 2 * per, "ce_fwd": SFT_STEPS,
                "ce_coeff": SFT_STEPS * ce_chunks(SFT_ROWS * SEQ, cfg.vocab_size),
                "ce_dh": SFT_STEPS, "ce_dw": SFT_STEPS, "fp8_gemm": 8 * per if fp8 else 0,
                "fp8_grouped_gemm": 9 * per if fp8 else 0,
                "fp8_grouped_dw": 3 * per if fp8 else 0, "block_sparse_fwd": 0,
                "block_sparse_bwd": 0}
        say(phase, launches=launches, expected=want, steady_step_ms=f"{1e3 * step_s:.1f}",
            steady_tok_s=f"{tokens / step_s:.1f}",
            pack_positions_s=f"{SFT_ROWS * SEQ / step_s:.1f}", peak_gib=f"{peak:.3f}",
            ckpt_committed=committed, ckpt_gib=f"{ckpt_gib:.3f}",
            save_s=",".join(f"{s:.3f}" for s in save_s), card=repr(smi))
        losses = [r["reduced_llm_loss"] for r in recs]
        norms = [r["grad_norm"] for r in recs]
        if len(recs) != SFT_STEPS or [r["step"] for r in recs] != list(range(1, SFT_STEPS + 1)):
            raise AssertionError(f"tracker.jsonl has steps {[r['step'] for r in recs]}")
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"non-finite loss or grad norm: {losses}, {norms}")
        if not SFT_LOSS1[0] <= losses[0] <= SFT_LOSS1[1]:
            raise AssertionError(f"step-1 loss {losses[0]} outside {SFT_LOSS1}")
        if fp8:
            rel = abs(losses[0] - fp8_ref_loss1) / fp8_ref_loss1
            say(phase, loss1=f"{losses[0]:.5f}", bf16_loss1=f"{fp8_ref_loss1:.5f}",
                rel=f"{rel:.3e}", tol=SFT_FP8_LOSS1_RTOL)
            if not rel <= SFT_FP8_LOSS1_RTOL:
                raise AssertionError(f"fp8 step-1 loss {losses[0]} is {rel} from the bf16 "
                                     f"run's {fp8_ref_loss1} (<= {SFT_FP8_LOSS1_RTOL})")
        if switched:
            diff = max(abs(a - b) for a, b in zip(losses, switched_ref))
            say(phase, losses=",".join(f"{x:.5f}" for x in losses),
                sft_losses=",".join(f"{x:.5f}" for x in switched_ref),
                max_abs_diff=f"{diff:.3e}", tol=SWITCHED_LOSS_ATOL)
            if not diff <= SWITCHED_LOSS_ATOL:
                raise AssertionError(f"the switched run's losses {losses} differ from the sft "
                                     f"run's {switched_ref} by {diff} (> {SWITCHED_LOSS_ATOL})")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall over {SFT_STEPS} steps: {losses}")
        if any(r["skipped"] for r in recs):
            raise AssertionError("a step was skipped")
        if not committed:
            raise AssertionError(f"no committed checkpoint at {step_dir}")
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != what 6 steps imply {want}")

        batch = next(iter(trainer.dataloader))
        with annotated(torch, QUANTISE_TARGETS if fp8 else {}):
            profile_window(torch, f"{phase}_step",
                           lambda: trainer.engine.train_step(batch, SFT_STEPS + 1), top=16,
                           annotations=(QUANTISE, LAYOUT) if fp8 else ())
        if breakdown and phase == "sft":
            sft_memory(torch, trainer.engine, batch, smi)
        trainer.dataloader.close()
    return launches, losses


QUANTISE = "fp8_quantise"
LAYOUT = "fp8_layout"
# the fp8 quantisers of the port, and its K-major and row-tile copies of the
# codes (`_row_tiles_k_major` calls the module's `k_major`)
QUANTISE_TARGETS = {
    QUANTISE: [(f"xtuner_tpu_torch.ops.{mod}", name)
               for mod, names in (("fp8_gemm", ("quantize_tilewise", "quantize_blockwise")),
                                  ("fp8_grouped", ("quantize_tilewise",
                                                   "quantize_blockwise_stack",
                                                   "quantize_rowtile")),
                                  ("float8", ("quantize_tilewise", "quantize_blockwise")))
               for name in names],
    LAYOUT: [("xtuner_tpu_torch.ops.fp8_gemm", "k_major"),
             ("xtuner_tpu_torch.ops.fp8_grouped", "k_major")]}


class annotated:
    """While on, every function named in `targets` ({label: [(module, attr)]},
    attr may be "Class.method") runs inside
    `torch.profiler.record_function(label)`, so that a profile can sum the
    device time of what it launches. The attributes are swapped back on
    exit."""

    def __init__(self, torch, targets: dict):
        self.torch, self.targets, self.saved = torch, targets, []

    def __enter__(self):
        import importlib

        for label, where in self.targets.items():
            for mod_name, attr in where:
                owner = importlib.import_module(mod_name)
                *path, name = attr.split(".")
                for part in path:
                    owner = getattr(owner, part)
                fn = getattr(owner, name)
                self.saved.append((owner, name, fn))
                setattr(owner, name, self._wrap(fn, label))
        return self

    def _wrap(self, fn, label):
        record_function = self.torch.profiler.record_function

        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        return False


def sft_memory(torch, eng, batch, smi: str) -> None:
    """Where the moe_heavy step's device memory and time go: under the
    recipe (remat "save_attn_residuals", fused CE), under remat "full", and
    with the plain chunked CE in place of the fused kernels. For each, the
    state resident between steps, what the forward holds for the backward,
    the forward's and the backward's peaks and the gradients, with forward
    and backward times from CUDA events (the second of two runs). One
    micro-batch, as the recipe's step (A = 1)."""
    from xtuner_tpu_torch.data_proto import SequenceContext

    gib = 2**30
    mb = {k: v[0] for k, v in eng._to_device(batch).items()}
    seq_ctx = SequenceContext(mb["input_ids"], mb["segment_ids"], mb["position_ids"])
    denom = mb["loss_weights"].float().sum()
    ce_cfg = eng.model.cfg.lm_loss_cfg
    recipe_mode = ce_cfg.mode
    try:
        for remat, mode in ((eng.remat, recipe_mode), ("full", recipe_mode),
                            (eng.remat, "chunk")):
            ce_cfg.mode = mode
            for _ in range(2):
                for p in eng._leaves:
                    p.grad = None
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0, t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
                t0.record()
                out = eng.model.loss(eng._train_tree, seq_ctx, mb["shifted_labels"],
                                     mb["loss_weights"], denom,
                                     compute_dtype=eng.compute_dtype, remat=remat)
                total = out.total_loss()
                t1.record()
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated() - resident
                fwd_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                total.backward()
                t2.record()
                torch.cuda.synchronize()
                bwd_peak = torch.cuda.max_memory_allocated()
                grads = sum(p.grad.numel() * p.grad.element_size() for p in eng._leaves
                            if p.grad is not None)
                del out, total
            say("sft", step_variant=f"remat={remat},ce={mode}",
                resident_gib=f"{resident / gib:.3f}", held_for_backward_gib=f"{held / gib:.3f}",
                fwd_peak_gib=f"{fwd_peak / gib:.3f}", bwd_peak_gib=f"{bwd_peak / gib:.3f}",
                grads_gib=f"{grads / gib:.3f}", fwd_ms=f"{t0.elapsed_time(t1):.1f}",
                bwd_ms=f"{t1.elapsed_time(t2):.1f}", card=repr(smi))
    finally:
        ce_cfg.mode = recipe_mode
        for p in eng._leaves:
            p.grad = None


def profile_window(torch, name: str, fn, top: int = 8, annotations=()) -> None:
    """Wall time, device-busy time (sum of kernel durations), kernel count,
    device time by kind (the port's fp8 kernels #11, #12 and #13 each, its
    paged decode #5, its block-sparse forward #14 and backward #15 each,
    and its others, cuBLAS GEMMs, the rest) and the top kernels by device
    time of one call under torch.profiler. For each name in `annotations`,
    the device time of the kernels launched inside `record_function(name)`
    ranges is its own kind, each kernel taken out of the kind it would
    have had."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def kind(k: str) -> str:
        # the port's kernels sit in a top-level anonymous namespace;
        # PyTorch's own sit in at::native::(anonymous namespace)
        own = k.removeprefix("void ").startswith("(anonymous namespace)::")
        if own and "::fp8_grouped_kernel<2" in k:  # #11, the dense mode
            return "port_fp8_gemm"
        if own and "::fp8_grouped_kernel<0" in k:  # #12, forward and dgrad
            return "port_fp8_grouped"
        if own and "::fp8_grouped_kernel<1" in k:  # #13, the wgrad
            return "port_fp8_wgrad"
        if own and "::paged_decode_kernel" in k:  # #5
            return "port_paged_decode"
        if own and "::bs_fwd_kernel" in k:  # #14
            return "port_block_sparse_fwd"
        if own and "::bs_" in k:  # #15: delta, the inverse table, dq, dk/dv
            return "port_block_sparse_bwd"
        if own:
            return "port_kernels"
        if k.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in k.lower():
            return "cublas"
        return "other"

    def kernels_under(e):  # (name, ms) of the kernels a CPU range launched
        for kern in e.kernels:
            yield kern.name, kern.duration / 1e3
        for ch in e.cpu_children:
            yield from kernels_under(ch)

    by_name: dict = defaultdict(lambda: [0.0, 0])
    kinds: dict = defaultdict(float)
    for e in prof.events():
        if e.name in annotations:
            if e.device_type != DeviceType.CUDA:  # the CPU range: move its kernels
                for k, ms in kernels_under(e):
                    kinds[e.name] += ms
                    kinds[kind(k)] -= ms
            continue  # the range's own device-side span is not a kernel
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    for k, (ms, _) in by_name.items():
        kinds[kind(k)] += ms
    say("profile", window=name, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        kernels=sum(v[1] for v in by_name.values()),
        **{f"{k}_ms": f"{v:.3f}" for k, v in sorted(kinds.items())})
    for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {k[:100]}", flush=True)



# ---- GRPO RL (`rl/trainer.py` behind the `rl` CLI) --------------------------
RL_RECIPE = "xtuner_tpu_torch/recipes/rl_qwen3_4b_grpo.py"
RL_R3_RECIPE = "xtuner_tpu_torch/recipes/rl_qwen3_moe_head_r3.py"
RL_STEPS = 2
RL_PARAMS = 1_600_128_512  # Qwen3-4B at 12 of its 36 layers (`with_depth`)
RL_HQ, RL_HKV, RL_D, RL_H, RL_V = 32, 8, 128, 2560, 151936
RL_R3_E, RL_R3_TOPK, RL_R3_H, RL_R3_F = 128, 8, 2048, 768
# step 1's ratio_mean: the rollout's logprobs (the bf16 decode over the
# dense cache) against the training forward's (bf16, flash, remat) on the
# same params: the train/inference mismatch of one policy
RL_RATIO_TOL = 2e-2
# per_token_logprobs fused (#8-#10) against the chunk mode: the CE
# statistics' bound on values, the bf16 products' on gradients
RL_LOGPROB_ATOL = 2 * CE_STAT_ATOL


def run_rl_cli(torch, recipe: str, work: str, name: str, **overrides):
    """`python -m xtuner_tpu_torch.train.cli.rl --config <cfg>` in-process
    (`rl.main`), where <cfg> is a file in `work` that loads `recipe` and
    replaces `overrides` (work_dir `work`, exp_name `name`). The rollout's
    `generate` is wrapped to split the launch counters into the rollout's
    and the rest of the step's. -> (trainer, tracker records, rollout
    launches, step launches, wall s)."""
    from pathlib import Path
    from unittest import mock

    from xtuner_tpu_torch.rl import trainer as rt
    from xtuner_tpu_torch.train.cli import rl

    recipe = str(Path(__file__).resolve().parent / recipe)
    cfg_path = Path(work) / f"{name}_cfg.py"
    kw = ", ".join(f"{k}={v!r}" for k, v in {"work_dir": work, "exp_name": name,
                                              **overrides}.items())
    cfg_path.write_text("import dataclasses\n"
                        "from xtuner_tpu_torch.train.cli.rl import load_config\n"
                        f"trainer = dataclasses.replace(load_config({recipe!r}), {kw})\n")
    roll = {}
    orig = rt.generate

    def counted(*a, **k):
        before = train_launches(torch)
        out = orig(*a, **k)
        for key, n in train_launches(torch).items():
            roll[key] = roll.get(key, 0) + n - before[key]
        return out

    reset_train_launches()
    t0 = time.perf_counter()
    with mock.patch.object(rt, "generate", counted):
        trainer = rl.main(["--config", str(cfg_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = train_launches(torch)
    step = {k: n - roll.get(k, 0) for k, n in total.items()}
    recs = [json.loads(x) for x in (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]
    return trainer, recs, roll, step, wall


def say_rl_steps(phase: str, recs: list, smi: str) -> None:
    for r in recs:
        say(phase, step=r["step"], rollout_s=f"{r['rollout_time']:.3f}",
            rollout_tokens=int(r["rollout_tokens"]),
            rollout_tok_s=f"{r['rollout_tokens'] / max(r['rollout_time'], 1e-9):.1f}",
            logprob_s=f"{r['logprob_time']:.3f}", train_s=f"{r['train_time']:.3f}",
            step_s=f"{r['step_time']:.3f}", pg_loss=f"{r['pg_loss']:.6g}",
            ratio_mean=f"{r['ratio_mean']:.6f}", clip_frac=f"{r['clip_frac']:.6f}",
            kl=f"{r.get('kl', float('nan')):.6g}", grad_norm=f"{r['grad_norm']:.6g}",
            mean_reward=f"{r['mean_reward']:.3f}",
            rollout_peak_gib=f"{r['rollout_peak_gib']:.3f}",
            step_peak_gib=f"{r['step_peak_gib']:.3f}", card=repr(smi))


def check_rl_recs(phase: str, recs: list, keys=("pg_loss", "ratio_mean", "clip_frac",
                                                    "grad_norm", "total_loss")) -> None:
    import numpy as np

    if [r["step"] for r in recs] != list(range(1, RL_STEPS + 1)):
        raise AssertionError(f"{phase}: tracker.jsonl has steps {[r['step'] for r in recs]}")
    vals = [r[k] for r in recs for k in keys if k in r]
    if not np.all(np.isfinite(vals)) or any(r["skipped"] for r in recs):
        raise AssertionError(f"{phase}: non-finite metrics or a skipped step: {recs}")


def rl_segments(torch, trainer, rows_from: list) -> tuple:
    """The segment ids of the recipe's own shapes from a captured step: the
    rollout prefill's left-padded unique prompts (B / g, P) and the packed
    step's rows (B, L), 1 on each row's tokens and 0 on its padding."""
    cfg = trainer.cfg
    p = cfg.max_prompt_length
    prompts = [s["prompt_ids"] for s in rows_from[::cfg.group_size]]
    roll = torch.zeros((len(prompts), p), dtype=torch.int32)
    for i, ids in enumerate(prompts):
        roll[i, p - len(ids):] = 1
    from xtuner_tpu_torch.rl.replay_buffer import SampleGroup

    packed = torch.as_tensor(trainer._pack([SampleGroup(0, rows_from)])["segment_ids"][0])
    return roll, packed


@with_depth("qwen3-4b", RL_LAYERS)
def phase_rl_grpo(torch, work: str, smi: str) -> tuple:
    """The rl CLI on `RL_RECIPE`, Qwen3-4B whole, `RL_STEPS` steps with the
    rollout captured: per step the split (rollout, teacher-forced logprobs,
    train step), rollout tokens/s, the GRPO metrics and the peaks of the
    rollout and of the rest of the step; step 1's ratio_mean within
    `RL_RATIO_TOL` of 1; #1 launched once a layer in each rollout's
    prefill (never in the decode), the backward kernel once a layer in
    each train step, no fused-CE kernel (the chunk mode). -> (launches of
    the rollout, of the step, the capture's directory, the segment ids of
    the prefill and of the packed rows)."""
    from xtuner_tpu_torch.module.params import count_params

    trainer, recs, roll, step, wall = run_rl_cli(torch, RL_RECIPE, work, "rl_grpo",
                                                 total_steps=RL_STEPS,
                                                 debug_rollout_capture=True)
    n = count_params(trainer.engine.specs)
    cfg = trainer.cfg
    say("rl_grpo", recipe=RL_RECIPE, params=n, layers=cfg.model_cfg.num_hidden_layers,
        rows=cfg.prompts_per_step * cfg.group_size,
        pack=cfg.max_prompt_length + cfg.gen_cfg.max_new_tokens, wall_s=f"{wall:.3f}",
        card=repr(smi))
    say_rl_steps("rl_grpo", recs, smi)
    say("rl_grpo", rollout_launches={k: v for k, v in roll.items() if v},
        step_launches={k: v for k, v in step.items() if v})
    check_rl_recs("rl_grpo", recs, ("pg_loss", "ratio_mean", "clip_frac", "grad_norm",
                                    "total_loss", "kl"))
    ratio1 = recs[0]["ratio_mean"]
    want_roll = RL_LAYERS * RL_STEPS
    problems = []
    if n != RL_PARAMS:
        problems.append(f"{n} params, want {RL_PARAMS}")
    if abs(ratio1 - 1.0) > RL_RATIO_TOL:
        problems.append(f"step-1 ratio_mean {ratio1} off 1 by more than {RL_RATIO_TOL}")
    if roll["flash_fwd"] + roll["flash_fwd_max_free"] != want_roll:
        problems.append(f"#1 launched {roll} in the rollouts, want {want_roll} (prefill)")
    if step["flash_bwd"] != RL_LAYERS * RL_STEPS:
        problems.append(f"the backward kernel launched {step['flash_bwd']} times in the "
                        f"steps, want {RL_LAYERS * RL_STEPS}")
    if any(step[k] or roll[k] for k in ("ce_fwd", "ce_coeff", "ce_dh", "ce_dw")):
        problems.append("a fused-CE kernel launched in the chunk-mode path")
    if problems:
        raise AssertionError("rl_grpo: " + "; ".join(problems))
    from xtuner_tpu_torch.rl.trace import RolloutTraceStore

    capture = trainer.work_dir
    rows = RolloutTraceStore(capture).load_step(1)
    segs = rl_segments(torch, trainer, rows)
    del trainer
    return roll, step, str(capture), segs


@with_depth("qwen3-4b", RL_LAYERS)
def phase_rl_replay(torch, work: str, capture: str, smi: str, seed: int) -> None:
    """Random weights give every sample reward 0, so GRPO's advantages and
    the policy gradient are 0: rewrite the captured shards' advantages
    with seeded, zero-mean +-1 per group, replay them through the CLI
    (`debug_rollout_replay_from`), and require a nonzero gradient, a
    nonzero policy loss, and parameters that moved beyond what weight
    decay alone would move them."""
    import numpy as np
    from pathlib import Path
    from unittest import mock

    from xtuner_tpu_torch.engine.train_engine import TrainEngine

    rng = np.random.default_rng(seed + 41)
    for shard in sorted((Path(capture) / "rollout_traces").glob("step-*.jsonl")):
        recs = [json.loads(x) for x in shard.read_text().splitlines() if x]
        by_group: dict = {}
        for r in recs:
            by_group.setdefault(r["prompt_id"], []).append(r)
        for group in by_group.values():
            signs = rng.permutation([1.0, -1.0] * (len(group) // 2) + [0.0] * (len(group) % 2))
            for r, a in zip(group, signs):
                r["advantage"] = float(a)
        shard.write_text("".join(json.dumps(r) + "\n" for r in recs))
    snap = {}
    orig = TrainEngine.train_step

    def probed(self, batch, step, loss_fn=None):
        if not snap:
            snap["q0"] = self.params["layers"]["attn"]["q_proj"]["w"][0].detach().clone()
            snap["emb"] = self.params["embed"]["w"][:4096].detach().clone()
        return orig(self, batch, step, loss_fn)

    with mock.patch.object(TrainEngine, "train_step", probed):
        trainer, recs, _, _, wall = run_rl_cli(torch, RL_RECIPE, work, "rl_replay",
                                               total_steps=RL_STEPS,
                                               debug_rollout_replay_from=capture)
    moved = max(float((trainer.engine.params["layers"]["attn"]["q_proj"]["w"][0]
                       - snap["q0"]).abs().max()),
                float((trainer.engine.params["embed"]["w"][:4096] - snap["emb"]).abs().max()))
    say("rl_replay", wall_s=f"{wall:.3f}", max_param_move=f"{moved:.3e}", card=repr(smi))
    say_rl_steps("rl_replay", recs, smi)
    check_rl_recs("rl_replay", recs)
    # decay alone moves a weight by lr * wd * |w| ~ 1e-6 * 0.01 * 0.1 per step
    if not (all(r["grad_norm"] > 0 and r["pg_loss"] != 0 for r in recs) and moved > 1e-7):
        raise AssertionError(f"rl_replay: grad_norm {[r['grad_norm'] for r in recs]}, "
                             f"pg_loss {[r['pg_loss'] for r in recs]}, moved {moved}")
    del trainer, snap


def phase_rl_moe_r3(torch, work: str, smi: str) -> tuple:
    """The rl CLI on `RL_R3_RECIPE` (Qwen3-30B-A3B's first 4 layers, R3) for
    `RL_STEPS` steps. The training forward's `moe_mlp_forward` is probed:
    wherever `rollout_routed_experts` is not -1 the router's ids must be
    the recorded ones; beside them the share of response tokens whose
    fresh routing (the router on the same input, unforced) differs from
    the recorded set. #6 launches in the rollout (prefill and decode), #6
    and #7 in the step. -> (rollout launches, step launches)."""
    from unittest import mock

    from xtuner_tpu_torch.model import moe as moe_mod
    from xtuner_tpu_torch.module.router import route

    stats = {"calls": 0, "forced_rows": 0, "forced_ok": True, "differ": 0}
    orig = moe_mod.moe_mlp_forward

    def probe(p, router_p, router_cfg, x, *, top_k, forced_topk_idx=None, **kw):
        out = orig(p, router_p, router_cfg, x, top_k=top_k, forced_topk_idx=forced_topk_idx,
                   **kw)
        if forced_topk_idx is not None:
            with torch.no_grad():
                f = forced_topk_idx.long()
                rec = (f >= 0).all(-1)
                used = out[1].topk_idx.long()
                fresh = route(router_p, router_cfg, x.reshape(-1, x.shape[-1]), top_k).topk_idx
                stats["calls"] += 1
                stats["forced_rows"] += int(rec.sum())
                stats["forced_ok"] &= bool(torch.equal(used[rec], f[rec]))
                stats["differ"] += int((fresh.long()[rec].sort(-1).values
                                        != f[rec].sort(-1).values).any(-1).sum())
        return out

    with mock.patch.object(moe_mod, "moe_mlp_forward", probe):
        trainer, recs, roll, step, wall = run_rl_cli(torch, RL_R3_RECIPE, work, "rl_moe_r3",
                                                     total_steps=RL_STEPS)
    share = stats["differ"] / max(stats["forced_rows"], 1)
    say("rl_moe_r3", recipe=RL_R3_RECIPE, params=trainer.engine.num_params,
        wall_s=f"{wall:.3f}", probed_calls=stats["calls"], forced_rows=stats["forced_rows"],
        forced_used=stats["forced_ok"], fresh_differs_share=f"{share:.4f}", card=repr(smi))
    say_rl_steps("rl_moe_r3", recs, smi)
    say("rl_moe_r3", rollout_launches={k: v for k, v in roll.items() if v},
        step_launches={k: v for k, v in step.items() if v})
    check_rl_recs("rl_moe_r3", recs)
    if not (stats["forced_ok"] and stats["forced_rows"] > 0):
        raise AssertionError(f"rl_moe_r3: the training forward did not use the recorded "
                             f"routing: {stats}")
    if not (roll["grouped_gemm_nn"] > 0 and step["grouped_gemm_nt"] > 0
            and step["grouped_gemm_dw"] > 0):
        raise AssertionError(f"rl_moe_r3: #6/#7 not launched: rollout {roll}, step {step}")
    del trainer
    return roll, step


def phase_rl_kernels(torch, seed: int, smi: str, segs) -> tuple[list[dict], dict]:
    """The RL path's kernels against their plain versions at its own shapes:
    #1 at the rollout prefill (the recipe's left-padded unique prompts,
    B4 P128 Hq32/8 D128) and at the packed step (B32 L512, one document and
    padding a row), the one-pass backward (#2 + #3) at the packed step;
    `per_token_logprobs(mode="fused")` (#8-#10) against the chunk mode at
    N16384 H2560 V151936 on a tied head, values and gradients, and each CE
    kernel against its plain version there; the R3 recipe's expert GEMMs
    (#6 nn at a decode step's and a prefill's routed rows, #6 nn/nt and #7
    at the step's) at E128 H2048 F768. -> (rows, the fused-mode call's CE
    launches)."""
    import numpy as np

    from xtuner_tpu_torch.loss.ce_loss import per_token_logprobs
    from xtuner_tpu_torch.ops import fused_ce as fc
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 43)
    rng = np.random.default_rng(seed + 43)
    src = "xtuner_tpu_torch/csrc/"
    scale = RL_D ** -0.5
    rows = []
    roll_seg, pack_seg = (s.to(dev).contiguous() for s in segs)
    for label, seg, path in (("rollout_prefill", roll_seg, "rl_grpo_rollout"),
                             ("packed_step", pack_seg, "rl_grpo_step")):
        b, l = seg.shape
        q = torch.randn((b, l, RL_HQ, RL_D), generator=g, device=dev).bfloat16()
        k, v, = (torch.randn((b, l, RL_HKV, RL_D), generator=g, device=dev).bfloat16()
                 for _ in range(2))
        valid = seg != 0
        pairs = causal_pairs(torch, seg)
        shape = f"B{b}xL{l}xHq{RL_HQ}xHkv{RL_HKV}xD{RL_D}, {int(valid.sum())} rows ({label})"
        # the step's training forward takes qk-norm's proven bound (sqrt(D) at
        # the init's unit norms): the max-free variant; the prefill takes none
        free = label == "packed_step"
        bound = torch.tensor(RL_D ** 0.5, device=dev) if free else None
        name = "flash_fwd_max_free" if free else "flash_fwd"
        (ro, rlse), plain = timed_once(torch, lambda: fl.flash_attention_plain(
            q, k, v, seg, scale, max_free=free))
        fl.reset_launches()
        out, lse = fl.flash_attention(q, k, v, seg, max_logit=bound)
        if fl.max_free_launches() != int(free):
            raise AssertionError(f"#1 at the RL {label} shape took the wrong variant")
        err = max(_abs(out[valid], ro[valid]), _abs(lse.transpose(1, 2)[valid],
                                                    rlse.transpose(1, 2)[valid]))
        ok = _abs(out[valid], ro[valid]) <= FLASH_OUT_ATOL and \
            _abs(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid]) <= FLASH_LSE_ATOL
        ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=10)
        lib = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg))[0]
        fb = least_ms(2 * pairs * RL_HQ * 2 * RL_D, flash_bytes(q, k), PEAK_BF16)
        say("kernel", name=name, path=path, shape=shape, pairs=pairs, err=f"{err:.3e}",
            ok=ok, ms=f"{ms:.4f}", plain_ms=f"{plain:.3f}", bound_ms=f"{fb['bound_ms']:.4f}",
            bound_by=fb["bound_by"], share_of_bound=f"{fb['bound_ms'] / ms:.3f}",
            sdpa_ms=lib, card=repr(smi))
        if not ok:
            raise AssertionError(f"#1 at the RL {label} shape disagrees: {err}")
        rows.append({"name": name, "route": "cuda", "source": src + "flash_fwd.cu",
                     "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": path,
                     "shape": f"{shape}, {'max-free' if free else 'running max'}", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, **fb, "library_ms": lib,
                     "library_is": "SDPA, block-causal dense mask"})
        if label == "packed_step":
            do = torch.randn_like(q)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, seg, lse, delta, do, scale)
            want, bplain = timed_once(torch, lambda: fl.flash_bwd_plain(*args))
            got = fl.flash_bwd(*args)
            rels = [_rel(t[valid], w[valid]) for t, w in zip(got, want)]
            berr = max(_abs(t[valid], w[valid]) for t, w in zip(got, want))
            del want, got
            bms = cuda_ms(lambda: fl.flash_bwd(*args), iters=10)
            blib = sdpa_ms(torch, q, k, v, block_causal_mask(torch, seg), do)[0]
            bnd = bwd_bound(q, k, pairs)
            say("kernel", name="flash_bwd", path=path, shape=shape,
                dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels), err=f"{berr:.3e}",
                ms=f"{bms:.4f}", plain_ms=f"{bplain:.3f}", bound_ms=f"{bnd['bound_ms']:.4f}",
                bound_by=bnd["bound_by"], share_of_bound=f"{bnd['bound_ms'] / bms:.3f}",
                sdpa_bwd_ms=blib, card=repr(smi))
            if max(rels) > FLASH_GRAD_RTOL:
                raise AssertionError(f"the backward kernel at the RL packed shape: {rels}")
            for row in bwd_rows(path, {"shape": shape, "max_abs_err": berr, "ms": bms,
                                       "plain_ms": bplain, **bnd, "library_ms": blib,
                                       "library_is": "SDPA backward, block-causal dense mask"}):
                rows.append(row)
            del do, delta, args
        del q, k, v, out, lse, ro, rlse
    fl.reset_launches()

    # ---- per_token_logprobs: fused (#8-#10) against chunk at the step's N
    b, l = pack_seg.shape
    n, hd, vocab = b * l, RL_H, RL_V
    h = torch.randn((b, l, hd), generator=g, device=dev).bfloat16()
    emb = (torch.randn((vocab, hd), generator=g, device=dev) * 0.02).bfloat16()
    labels = torch.randint(0, vocab, (b, l), generator=g, device=dev, dtype=torch.int32)
    labels = torch.where(pack_seg != 0, labels, torch.full_like(labels, -100))
    cot = torch.randn((b, l), generator=g, device=dev)
    res, launches = {}, {}
    for mode in ("chunk", "fused"):
        hl, el = h.clone().requires_grad_(True), emb.clone().requires_grad_(True)

        def fwd_bwd():
            hl.grad = el.grad = None
            lp = per_token_logprobs(hl, el.T, labels, 1024, mode=mode)
            (lp * cot).sum().backward()
            return lp.detach()

        fc.reset_launches()
        lp = fwd_bwd()
        torch.cuda.synchronize()
        launches[mode] = {"ce_fwd": fc.ce_fwd.launches, "ce_coeff": fc.ce_coeff.launches,
                          "ce_dh": fc.ce_dh.launches, "ce_dw": fc.ce_dw.launches}
        res[mode] = (lp, hl.grad.clone(), el.grad.clone(), cuda_ms(fwd_bwd, iters=3, warmup=1))
        del hl, el
    (lp_c, dh_c, de_c, ms_c), (lp_f, dh_f, de_f, ms_f) = res["chunk"], res["fused"]
    lp_err = _abs(lp_f, lp_c)
    dh_rel, de_rel = _rel(dh_f, dh_c), _rel(de_f, de_c)
    chunks = ce_chunks(n, vocab)
    say("kernel", name="per_token_logprobs_fused", shape=f"N{n} H{hd} V{vocab} tied",
        logprob_err=f"{lp_err:.3e}", dh_rel=f"{dh_rel:.3e}", dembed_rel=f"{de_rel:.3e}",
        fused_fwd_bwd_ms=f"{ms_f:.3f}", chunk_fwd_bwd_ms=f"{ms_c:.3f}",
        launches=launches["fused"], card=repr(smi))
    if not (lp_err <= RL_LOGPROB_ATOL and dh_rel <= GG_RTOL and de_rel <= GG_RTOL and
            launches["fused"] == {"ce_fwd": 1, "ce_coeff": chunks, "ce_dh": 1, "ce_dw": 1}
            and not any(launches["chunk"].values())):
        raise AssertionError(f"per_token_logprobs fused vs chunk at N{n}: err {lp_err}, dh "
                             f"{dh_rel}, dW {de_rel}, launches {launches}")
    del res, lp_c, dh_c, de_c, lp_f, dh_f, de_f
    # each CE kernel alone against its plain version (the rows of the table)
    h2, safe = h.reshape(n, hd), torch.where(labels < 0, 0, labels).reshape(n)
    ref_lse, ref_lab = fc.ce_fwd_plain(h2, emb, safe)
    g_lse = torch.where(labels.reshape(n) >= 0, -cot.reshape(n), 0.0).contiguous()
    g_lab = (-g_lse).contiguous()
    args = (h2, emb, safe, ref_lse, g_lse, g_lab)
    lse, lab = fc.ce_fwd(h2, emb, safe)
    stat_err = max(_abs(lse, ref_lse), _abs(lab, ref_lab))
    plan = fc.ce_chunk_plan(n, vocab)

    def sweep(kernel: bool):
        c = torch.empty((plan.rows, plan.v_pad), device=dev, dtype=torch.bfloat16)
        for s0, r in plan.chunks:
            sl = slice(s0, s0 + r)
            part = (h2[sl], emb, safe[sl], ref_lse[sl], g_lse[sl], g_lab[sl], plan.v_pad)
            if kernel:
                fc.ce_coeff(*part, out=c[:r])
            else:
                c[:r] = fc.ce_coeff_plain(*part)
        return c

    c_err = _abs(sweep(True), sweep(False))
    dh_err = _abs(fc.ce_dh(*args), fc.ce_dh_plain(*args))
    dw_err = _abs(fc.ce_dw(*args), fc.ce_dw_plain(*args))
    ins = 2 * n * hd + 2 * vocab * hd + 4 * n
    timed = {"ce_fwd": (lambda: fc.ce_fwd(h2, emb, safe), lambda: fc.ce_fwd_plain(h2, emb, safe),
                        stat_err, "xtuner_tpu/ops/fused_ce.py:47", 1, ins + 8 * n),
             "ce_coeff": (lambda: sweep(True), lambda: sweep(False), c_err,
                          "xtuner_tpu/ops/fused_ce.py:98", 1, ins + 12 * n + 2 * n * plan.v_pad),
             "ce_dh": (lambda: fc.ce_dh(*args), lambda: fc.ce_dh_plain(*args), dh_err,
                       "xtuner_tpu/ops/fused_ce.py:98", 2, ins + 12 * n + 2 * n * hd),
             "ce_dw": (lambda: fc.ce_dw(*args), lambda: fc.ce_dw_plain(*args), dw_err,
                       "xtuner_tpu/ops/fused_ce.py:123", 2, ins + 12 * n + 2 * vocab * hd)}
    for name, (kern, plain_fn, err, replaces, mult, nbytes) in timed.items():
        ms = cuda_ms(kern, iters=3, warmup=1)
        pms = cuda_ms(plain_fn, iters=1, warmup=1)
        flops = 2 * n * vocab * hd * mult
        b_ = least_ms(flops, nbytes, PEAK_BF16)
        say("kernel", name=name, path="rl_logprobs_fused", shape=f"N{n} H{hd} V{vocab}",
            err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            bound_ms=f"{b_['bound_ms']:.4f}", share_of_bound=f"{b_['bound_ms'] / ms:.3f}",
            card=repr(smi))
        rows.append({"name": name, "route": "cuda", "source": src + "fused_ce.cu",
                     "replaces": replaces, "path": "rl_logprobs_fused",
                     "shape": f"N{n} H{hd} V{vocab} (per_token_logprobs)", "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, **b_, "library_ms": None})
    del h, emb, labels, cot, h2, safe, ref_lse, ref_lab, g_lse, g_lab, args, lse, lab
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the R3 recipe's expert GEMMs
    e, hid, f, topk = RL_R3_E, RL_R3_H, RL_R3_F, RL_R3_TOPK
    w_gu = (torch.randn((e, hid, 2 * f), generator=g, device=dev) * 0.02).bfloat16()
    w_dn = (torch.randn((e, f, hid), generator=g, device=dev) * 0.02).bfloat16()
    for label, tokens, path, kinds in (("decode", 8, "rl_moe_r3_rollout", ("nn",)),
                                       ("prefill", 2 * 128, "rl_moe_r3_rollout", ("nn",)),
                                       ("step", 8 * 256, "rl_moe_r3_step", ("nn", "nt", "dw"))):
        m = tokens * topk
        sizes = routed_sizes(torch, rng, tokens, e, topk, e - 1, dev)
        x = torch.randn((m, hid), generator=g, device=dev).bfloat16()
        hmid = torch.randn((m, f), generator=g, device=dev).bfloat16()
        dy_gu = torch.randn((m, 2 * f), generator=g, device=dev).bfloat16()
        dy_dn = torch.randn((m, hid), generator=g, device=dev).bfloat16()
        cases = grouped_cases(x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e, kinds=kinds)
        touched = int((sizes > 0).sum())
        if label != "step":  # the weights of the experts with rows, as serving counts them
            cases = [(*c[:6], c[6] - 2 * (e - touched) * c[4][1].shape[1] * c[4][1].shape[2])
                     for c in cases]
        for row in grouped_rows(torch, path, cases, m, e, iters=10, plain_iters=2):
            row["shape"] = f"{label} M{m} E{e} ({touched} with rows) H{hid} F{f}"
            rows.append(row)
        del x, hmid, dy_gu, dy_dn
    del w_gu, w_dn
    reset_train_launches()
    return rows, launches["fused"]


# ---- LoRA / QLoRA fine-tuning, DPO / ORPO and the reward model -------------
LORA_RECIPE = "xtuner_tpu_torch/recipes/sft_qwen25_05b_lora.py"
QLORA_RECIPE = "xtuner_tpu_torch/recipes/sft_qwen3_8b_qlora.py"
DPO_RECIPE = "xtuner_tpu_torch/recipes/dpo_qwen3_8b_qlora.py"
REWARD_RECIPE = "xtuner_tpu_torch/recipes/reward_qwen25_05b.py"
QLORA_MODEL = "qwen3-8b"
QLORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the layers whose codes on the card are held to the host quantizer, bit for bit
QLORA_CHECK_LAYERS = (0, QLORA_LAYERS - 1)
# a merged export's teacher-forced log-probs against the unmerged model's,
# both bf16 on the card (the merge folds an f32 delta into the bases; the
# unmerged forward adds the adapters' bf16 products, and under QLoRA
# dequantizes with the absmax cast to bf16, as JAX's forward casts it):
# the serving checks' bounds
MERGE_MAX_ATOL = TF_MAX_ATOL
MERGE_MEAN_ATOL = TF_MEAN_ATOL
# a few steps leave |lora_b| near 5e-4, where the adapters move the log-probs
# far less than those bounds: before the merge every lora_b is redrawn with
# this std, a delta W of std scaling * std / sqrt(r) (0.01 at alpha 32, r 16,
# half the base's init std), so that a merge that drops the adapters or
# applies them at 1.0 in place of alpha / r fails the bounds
LORA_B_CHECK_STD = 0.02
# DPO's first step: the policy is its reference (the same code on the same
# weights), so the loss is ln 2 and the margin 0 up to this
DPO_INIT_ATOL = 1e-4
# the paths' attention: Qwen2.5-0.5B (14 q / 2 kv heads of 64, a group of
# 7, q/k/v biases, no qk-norm) and Qwen3-8B (32 / 8 of 128, qk-norm)
LORA_HQ, LORA_HKV, LORA_D = 14, 2, 64
QLORA_HQ, QLORA_HKV, QLORA_D, QLORA_H, QLORA_V = 32, 8, 128, 4096, 151936
QLORA_SERVE_NEW = 32


@contextlib.contextmanager
def in_dir(path):
    """Run with `path` as the working directory (the recipes write under
    work_dirs/ there)."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


def tracker(trainer) -> list:
    return [json.loads(x) for x in (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]


def check_recs(phase: str, recs: list, steps: int) -> None:
    """`steps` records, finite losses and grad norms, none skipped."""
    import numpy as np

    vals = [r["total_loss"] for r in recs] + [r["grad_norm"] for r in recs]
    if [r["step"] for r in recs] != list(range(1, steps + 1)):
        raise AssertionError(f"{phase}: tracker.jsonl has steps {[r['step'] for r in recs]}")
    if not np.isfinite(vals).all():
        raise AssertionError(f"{phase}: a loss or grad norm is not finite: {vals}")
    if any(r.get("skipped") for r in recs):
        raise AssertionError(f"{phase}: a step was skipped")


def need_launched(phase: str, launches: dict, names, absent=()) -> None:
    """Fail unless each kernel in `names` launched in the path's run and
    none in `absent` did."""
    missing = [n for n in names if launches.get(n, 0) <= 0]
    extra = [n for n in absent if launches.get(n, 0)]
    if missing or extra:
        raise AssertionError(f"{phase}: kernels of the path not launched {missing}, launched "
                             f"where they must not be {extra}: {launches}")


def frozen_check(torch, eng, init: dict) -> tuple:
    """(frozen leaves, those bit-equal to `init`, trained leaves, the
    largest |lora_b|) of an engine's masters against its initial tree."""
    from xtuner_tpu_torch.module.params import tree_paths

    labels = dict(tree_paths(eng.model.param_labels(eng.specs)))
    start = dict(tree_paths(init))
    frozen = same = trained = 0
    lora_b = 0.0
    for path, t in tree_paths(eng.params):
        if labels[path] == "freeze":
            frozen += 1
            same += int(torch.equal(t, start[path]))
        else:
            trained += 1
            if path[-1] == "lora_b":
                lora_b = max(lora_b, t.abs().max().item())
    return frozen, same, trained, lora_b


def tf_compare(torch, a, b) -> tuple:
    d = (a - b).abs()
    return d.max().item(), d.mean().item()


def redraw_lora_b(torch, trainer, seed: int) -> None:
    """Every `lora_b` of the trainer's engine redrawn in place, normal with
    LORA_B_CHECK_STD from the seed, and its final checkpoint saved again, so
    that the convert CLI merges adapters that matter."""
    from xtuner_tpu_torch.module.params import tree_paths

    g = torch.Generator(device=torch.device("cuda")).manual_seed(seed + 71)
    with torch.no_grad():
        for path, t in tree_paths(trainer.engine.params):
            if path[-1] == "lora_b":
                t.copy_(torch.randn(t.shape, generator=g, device=t.device) * LORA_B_CHECK_STD)
    trainer._save(trainer.total_steps)


def planted_merge_faults(torch, phase: str, model, params, scaling: float, prompt, toks,
                         unmerged) -> dict:
    """What two broken merges would give, made on the unmerged model: the
    adapters dropped (lora_b x 0) and applied at 1.0 (lora_b / scaling).
    Their teacher-forced log-probs' (max, mean) gaps to `unmerged`; each
    must fail MERGE_*_ATOL, else the merge check could not see it."""
    from xtuner_tpu_torch.model.generate import compute_copy

    def scaled(tree, f):
        return {k: v * f if k == "lora_b" else scaled(v, f) if isinstance(v, dict) else v
                for k, v in tree.items()}

    gaps = {}
    for name, f in (("no_adapters", 0.0), ("scale_1", 1.0 / scaling)):
        p = scaled(compute_copy(params, torch.bfloat16, copy=False), f)
        gaps[name] = tf_compare(torch, teacher_forced(torch, model, p, prompt, toks), unmerged)
        del p
    say(phase, **{f"planted_{k}_max_abs": f"{mx:.4e}" for k, (mx, _) in gaps.items()},
        **{f"planted_{k}_mean_abs": f"{mean:.4e}" for k, (_, mean) in gaps.items()},
        lora_b_std=LORA_B_CHECK_STD)
    caught = [k for k, (mx, mean) in gaps.items()
              if not (mx <= MERGE_MAX_ATOL and mean <= MERGE_MEAN_ATOL)]
    if len(caught) != len(gaps):
        raise AssertionError(f"{phase}: the merge check would pass a broken merge: {gaps}")
    return gaps


def phase_lora_sft(torch, seed: int, smi: str) -> tuple:
    """BASELINE config 1: the literal `python -m xtuner_tpu_torch.train.cli.
    sft --config recipes/sft_qwen25_05b_lora.py` (in-process, `sft.main`,
    in a temporary working directory): Qwen2.5-0.5B whole with LoRA r 16
    on all seven projections, a random base from the seed. Per step CE,
    grad norm, step time, tgs; the peak; every frozen leaf bit-equal to
    the seeded init after the run, `lora_b` moved; `lora_b` redrawn at
    LORA_B_CHECK_STD and the final checkpoint through the convert CLI
    (`--config`, merged, f32); the merged export's teacher-forced log-probs
    against the unmerged model's, both bf16 on the card, and two planted
    broken merges shown to fail that check. -> (launches, the recipe's
    first row's segment ids)."""
    import numpy as np

    from xtuner_tpu_torch.checkpoint.hf import load_hf_checkpoint
    from xtuner_tpu_torch.model.generate import compute_copy
    from xtuner_tpu_torch.module.params import init_params
    from xtuner_tpu_torch.train.cli import convert, sft
    from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer

    dev = torch.device("cuda")
    recipe = str(Path(__file__).resolve().parent / LORA_RECIPE)
    with tempfile.TemporaryDirectory(prefix="xt_lora_") as work, in_dir(work):
        reset_train_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = sft.main(["--config", recipe])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = train_launches(torch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        recs = tracker(trainer)
        check_recs("lora_sft", recs, trainer.total_steps)
        eng = trainer.engine
        for r in recs:
            say("lora_sft", step=r["step"], ce=f"{r['reduced_llm_loss']:.4f}",
                grad_norm=f"{r['grad_norm']:.4f}", step_ms=f"{1e3 * r['step_time']:.1f}",
                tgs=f"{r['tgs']:.1f}", tokens=r["consumed_tokens"], card=repr(smi))
        init = init_params(eng.specs, torch.Generator(device=dev).manual_seed(trainer.cfg.seed),
                           dev, torch.float32)
        frozen, same, trained, lora_b = frozen_check(torch, eng, init)
        del init
        say("lora_sft", model="qwen2.5-0.5b", params=eng.num_params, steps=len(recs),
            rows_per_step=trainer.cfg.global_batch_rows, wall_s=f"{wall:.3f}",
            peak_gib=f"{peak:.3f}", frozen_leaves=frozen, frozen_bit_equal=same,
            trained_leaves=trained, lora_b_max_abs=f"{lora_b:.3e}", launches=launches,
            card=repr(smi))
        if same != frozen or lora_b <= 0:
            raise AssertionError(f"lora_sft: {frozen - same} frozen leaves changed, or lora_b "
                                 f"never moved ({lora_b})")
        need_launched("lora_sft", launches, ("flash_fwd", "flash_bwd"),
                      ("ce_fwd", "ce_coeff", "ce_dh", "ce_dw"))
        # the recipe's first row (its documents), for the kernel phase
        dl = dataclasses.replace(trainer.cfg.dataloader_cfg, tokenize_num_proc=1).build(
            UTF8ByteTokenizer(), 8, 1)
        batch = next(iter(dl))
        dl.close()
        seg = torch.as_tensor(np.asarray(batch["segment_ids"][0]))
        ids = np.asarray(batch["input_ids"][0, 0]).tolist()

        redraw_lora_b(torch, trainer, seed)
        prompt, toks = ids[:128], ids[128:1024]
        want = teacher_forced(torch, eng.model, compute_copy(eng.params, torch.bfloat16,
                                                             copy=False), prompt, toks)
        planted_merge_faults(torch, "lora_sft", eng.model, eng.params,
                             trainer.cfg.model_cfg.lora_cfg.scaling, prompt, toks, want)
        out = Path(work) / "merged"
        t0 = time.perf_counter()
        convert.main(["--work-dir", str(trainer.work_dir), "--config", recipe, "--out",
                      str(out), "--device", "cuda"])
        conv_s = time.perf_counter() - t0
        gib = sum(f.stat().st_size for f in out.glob("*.safetensors")) / 2**30
        plain = eng.model.plain_config().build()
        merged = load_hf_checkpoint(out, plain.param_specs(), plain.hf_key_map(), dev,
                                    torch.bfloat16)
        got = teacher_forced(torch, plain, merged, prompt, toks)
        mx, mean = tf_compare(torch, got, want)
        say("lora_sft", convert_s=f"{conv_s:.3f}", merged_export_gib=f"{gib:.3f}",
            merged_vs_unmerged_max_abs=f"{mx:.4e}", mean_abs=f"{mean:.4e}",
            tol=f"max<={MERGE_MAX_ATOL},mean<={MERGE_MEAN_ATOL}", positions=len(toks))
        if not (mx <= MERGE_MAX_ATOL and mean <= MERGE_MEAN_ATOL):
            raise AssertionError(f"lora_sft: the merged export's log-probs differ from the "
                                 f"unmerged model's: max {mx}, mean {mean}")
        del merged, trainer, eng
    return launches, seg


def phase_reward(torch, smi: str) -> dict:
    """The reward recipe (Qwen2.5-0.5B whole, full-parameter, a value head
    on the last real token) built and fit as its docstring says, 4 steps of
    4 pairs from the alpaca pairs it writes: loss, reward_acc, step time
    and peak per step."""
    from xtuner_tpu_torch.utils.config import Config

    recipe = str(Path(__file__).resolve().parent / REWARD_RECIPE)
    with tempfile.TemporaryDirectory(prefix="xt_rm_") as work, in_dir(work):
        cfg = Config.fromfile(recipe)["trainer"]
        reset_train_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = cfg.build()
        init_s = time.perf_counter() - t0
        trainer.fit()
        torch.cuda.synchronize()
        launches = train_launches(torch)
        recs = tracker(trainer)
        check_recs("reward", recs, cfg.total_steps)
        for r in recs:
            say("reward", step=r["step"], loss=f"{r['total_loss']:.4f}",
                reward_acc=f"{r['reward_acc']:.3f}", margin=f"{r['reward_margin']:.4f}",
                grad_norm=f"{r['grad_norm']:.4f}", step_ms=f"{1e3 * r['step_time']:.1f}",
                peak_gib=f"{r['peak_gib']:.3f}", card=repr(smi))
        say("reward", params=trainer.engine.num_params, init_s=f"{init_s:.3f}",
            launches=launches)
        need_launched("reward", launches, ("flash_fwd", "flash_bwd"))
        del trainer
    return launches


def host_nf4(w):
    """`module/quant.py::quantize_nf4` (JAX's numpy code) over 256K-element
    pieces (their (n, 16) temporaries stay in cache) on 8 host threads:
    blocks are independent, so the codes are the whole tensor's."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from xtuner_tpu_torch.module.quant import quantize_nf4

    flat = w.reshape(-1)
    step = 1 << 18
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda s: quantize_nf4(flat[s:s + step]), range(0, flat.size, step)))
    return np.concatenate([c for c, _ in parts]), np.concatenate([a for _, a in parts])


def adapter_ms(torch, seed: int, rows: int, r: int, layers: int) -> float:
    """CUDA-event ms of the adapter GEMMs of one QLoRA step, timed alone:
    per layer the seven projections' `(x A) B * s` forward twice (the
    forward and remat's recompute) and its backward (dx, dA, dB), bf16 at
    the recipe's rows, times the layers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 61)
    h, f = QLORA_H, 12288
    shapes = [(h, QLORA_HQ * QLORA_D), (h, QLORA_HKV * QLORA_D), (h, QLORA_HKV * QLORA_D),
              (QLORA_HQ * QLORA_D, h), (h, f), (h, f), (f, h)]
    cases = []
    for d_in, d_out in shapes:
        x = torch.randn((rows, d_in), generator=g, device=dev).bfloat16().requires_grad_(True)
        a = (torch.randn((d_in, r), generator=g, device=dev) / r).bfloat16().requires_grad_(True)
        b = (torch.randn((r, d_out), generator=g, device=dev) * 1e-3).bfloat16() \
            .requires_grad_(True)
        dy = torch.randn((rows, d_out), generator=g, device=dev).bfloat16()
        cases.append((x, a, b, dy))

    def one_layer():
        for x, a, b, dy in cases:
            with torch.no_grad():
                (x @ a) @ b * 2.0  # the forward remat throws away
            y = (x @ a) @ b * 2.0
            torch.autograd.grad(y, (x, a, b), dy)

    return cuda_ms(one_layer, iters=5, warmup=2) * layers


@with_depth(QLORA_MODEL, QLORA_LAYERS)
def phase_qlora(torch, seed: int, smi: str) -> tuple:
    """Qwen3-8B whole under QLoRA, from its own HF export: DPO, ORPO, SFT
    through the sft CLI, the merged export through the convert CLI, served.

    1. Qwen3-8B (random bf16 weights from the seed) written by
       `save_hf_checkpoint`; `QWEN3_8B_HF` points the recipes at it.
    2. dpo / orpo: `recipes/dpo_qwen3_8b_qlora.py`'s `trainer` and
       `orpo_trainer`, built and fit as its docstring says, 2 steps each on
       the alpaca pairs it writes: the load's seconds, per step the loss,
       margin or log-odds, step time and peak. DPO's step 1 is ln 2 with a
       zero margin (DPO_INIT_ATOL); its step 2 moves the margin.
    3. qlora_sft: `python -m xtuner_tpu_torch.train.cli.sft --config
       recipes/sft_qwen3_8b_qlora.py` in-process: the load's seconds, 4
       steps (CE, step time, tgs, peak), the codes of QLORA_CHECK_LAYERS'
       seven projections on the card bit-equal to the host quantizer's of
       the export's weights, `lora_b` moved, #10 never launched (the head
       is frozen); the adapter GEMMs timed alone (the profiled step is
       `phase_lora_profile`'s, after every timed phase).
    4. `lora_b` redrawn at LORA_B_CHECK_STD and the final checkpoint saved
       again; two planted broken merges shown to fail the merge check; the
       source export deleted; the final checkpoint through `python -m
       xtuner_tpu_torch.train.cli.convert --config ... --device cuda
       --dtype bfloat16` (merged); its teacher-forced log-probs against the
       unmerged QLoRA model's (MERGE_*_ATOL); then served by `PagedGenerator`
       (4 requests, 32 new tokens), the decoded log-probs held to a
       teacher-forced forward.
    Every export and checkpoint lives in one temporary directory, deleted at
    the end (at most ~25 GiB at once). -> (launches by path, the SFT row's
    and the DPO batch's segment ids, the served slots' final lengths)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    import numpy as np

    from xtuner_tpu_torch.checkpoint.hf import (HFCheckpointReader, load_hf_checkpoint,
                                                save_hf_checkpoint)
    from xtuner_tpu_torch.datasets.sampler import ParallelSampler
    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.model.generate import GenerateConfig, compute_copy
    from xtuner_tpu_torch.model.paged_generate import PagedGenerator
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import count_params, init_params
    from xtuner_tpu_torch.ops.attention.flash import flash_attention
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn
    from xtuner_tpu_torch.train.cli import convert, sft
    from xtuner_tpu_torch.train.preference import pair_batch
    from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer
    from xtuner_tpu_torch.utils.config import Config

    dev = torch.device("cuda")
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="xt_qlora_"))
    export = work / "hf"
    launches = {}
    try:
        # 1. the export
        cfg = get_model_config(QLORA_MODEL)
        model = cfg.build()
        params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(seed),
                             dev, torch.bfloat16)
        t0 = time.perf_counter()
        save_hf_checkpoint(export, params, model.hf_key_map(), cfg)
        say("qlora", model=QLORA_MODEL, params=count_params(model.param_specs()),
            export_s=f"{time.perf_counter() - t0:.3f}",
            export_gib=f"{sum(f.stat().st_size for f in export.glob('*.safetensors')) / 2**30:.3f}")
        del params
        release(torch, "qlora_export")

        load_s = {}
        real_from_hf = TrainEngine.from_hf

        def timed_from_hf(self, path, seed=0):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real_from_hf(self, path, seed)
            torch.cuda.synchronize()
            load_s["last"] = time.perf_counter() - t

        with mock.patch.dict(os.environ, {"QWEN3_8B_HF": str(export)}), \
                mock.patch.object(TrainEngine, "from_hf", timed_from_hf), in_dir(work):
            # 2. DPO and ORPO
            dpo_seg = None
            for name, phase in (("trainer", "dpo"), ("orpo_trainer", "orpo")):
                pcfg = Config.fromfile(str(root / DPO_RECIPE))[name]
                reset_train_launches()
                pt = pcfg.build()
                if dpo_seg is None:
                    b = pair_batch(pt.dataset, iter(ParallelSampler(len(pt.dataset), seed=seed)),
                                   pcfg.pairs_per_step, pcfg.max_length)
                    dpo_seg = torch.as_tensor(np.asarray(b["segment_ids"][0]))
                pt.fit()
                torch.cuda.synchronize()
                launches[phase] = train_launches(torch)
                recs = tracker(pt)
                check_recs(phase, recs, pcfg.total_steps)
                for r in recs:
                    extra = ({"margin": f"{r['reward_margin']:.6e}",
                              "reward_acc": f"{r['reward_acc']:.3f}"} if phase == "dpo" else
                             {"log_odds": f"{r['log_odds']:.4f}",
                              "chosen_nll": f"{r['chosen_nll']:.4f}"})
                    say(phase, step=r["step"], loss=f"{r['total_loss']:.6f}", **extra,
                        grad_norm=f"{r['grad_norm']:.4f}", step_ms=f"{1e3 * r['step_time']:.1f}",
                        peak_gib=f"{r['peak_gib']:.3f}", card=repr(smi))
                say(phase, load_s=f"{load_s['last']:.3f}", pairs_per_step=pcfg.pairs_per_step,
                    max_length=pcfg.max_length, launches=launches[phase])
                need_launched(phase, launches[phase], ("flash_fwd_max_free", "flash_bwd"))
                if phase == "dpo":
                    d_loss = abs(recs[0]["total_loss"] - math.log(2))
                    d_margin = abs(recs[0]["reward_margin"])
                    say("dpo", step1_loss_minus_ln2=f"{d_loss:.3e}",
                        step1_margin=f"{d_margin:.3e}", tol=DPO_INIT_ATOL,
                        step2_margin=f"{recs[1]['reward_margin']:.6e}")
                    if not (d_loss <= DPO_INIT_ATOL and d_margin <= DPO_INIT_ATOL
                            and recs[1]["reward_margin"] != 0):
                        raise AssertionError(f"dpo: step 1 at {recs[0]['total_loss']} with "
                                             f"margin {recs[0]['reward_margin']} (ln 2 and 0 "
                                             f"within {DPO_INIT_ATOL}), step 2 margin "
                                             f"{recs[1]['reward_margin']} (moved)")
                del pt
                release(torch, phase)

            # 3. QLoRA SFT through the CLI
            recipe = str(root / QLORA_RECIPE)
            reset_train_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = sft.main(["--config", recipe])
            torch.cuda.synchronize()
            launches["qlora_sft"] = train_launches(torch)
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = tracker(trainer)
            check_recs("qlora_sft", recs, trainer.total_steps)
            eng = trainer.engine
            for r in recs:
                say("qlora_sft", step=r["step"], ce=f"{r['reduced_llm_loss']:.4f}",
                    grad_norm=f"{r['grad_norm']:.4f}", step_ms=f"{1e3 * r['step_time']:.1f}",
                    tgs=f"{r['tgs']:.1f}", tokens=r["consumed_tokens"], card=repr(smi))
            need_launched("qlora_sft", launches["qlora_sft"],
                          ("flash_fwd_max_free", "flash_bwd", "ce_fwd", "ce_coeff", "ce_dh"),
                          ("ce_dw",))
            # the checked layers' codes and scales on the card, and the export's
            # weights, to the host: the host quantizer runs beside the convert
            reader = HFCheckpointReader(export)
            check = []
            for li in QLORA_CHECK_LAYERS:
                for name in QLORA_TARGETS:
                    part = "self_attn" if name.endswith(("q_proj", "k_proj", "v_proj", "o_proj")) \
                        else "mlp"
                    w = reader.get(f"model.layers.{li}.{part}.{name}.weight").float().T.numpy()
                    proj = eng.params["layers"]["attn" if part == "self_attn" else "mlp"][name]
                    check.append((np.ascontiguousarray(w), proj["w_q4"][li].cpu().numpy(),
                                  proj["w_absmax"][li].cpu().numpy()))
                    del proj  # a reference here would keep the stack alive
            lora_b = max(eng.params["layers"][s][n]["lora_b"].abs().max().item()
                         for s, names in (("attn", QLORA_TARGETS[:4]), ("mlp", QLORA_TARGETS[4:]))
                         for n in names)
            say("qlora_sft", load_s=f"{load_s['last']:.3f}", steps=len(recs),
                peak_gib=f"{peak:.3f}", lora_b_max_abs=f"{lora_b:.3e}",
                trainable=sum(v.numel() for v in eng._leaves), launches=launches["qlora_sft"],
                card=repr(smi))
            if lora_b <= 0:
                raise AssertionError("qlora_sft: lora_b never moved")
            # the recipe's row (the profiled step's batch) and a teacher-forced prompt
            dl = dataclasses.replace(trainer.cfg.dataloader_cfg, tokenize_num_proc=1).build(
                UTF8ByteTokenizer(), 1, 1)
            batch = next(iter(dl))
            dl.close()
            sft_seg = torch.as_tensor(np.asarray(batch["segment_ids"][0]))
            ids = np.asarray(batch["input_ids"][0, 0]).tolist()
            prompt, toks = ids[:256], ids[256:1280]
            redraw_lora_b(torch, trainer, seed)
            unmerged = teacher_forced(torch, eng.model, compute_copy(
                eng.params, torch.bfloat16, copy=False), prompt, toks)
            planted_merge_faults(torch, "qlora_sft", eng.model, eng.params,
                                 trainer.cfg.model_cfg.lora_cfg.scaling, prompt, toks, unmerged)
            ad_ms = adapter_ms(torch, seed, int(np.asarray(batch["input_ids"]).shape[-1]),
                               trainer.cfg.model_cfg.lora_cfg.r, cfg.num_hidden_layers)
            say("qlora_sft", adapter_gemms_ms_per_step=f"{ad_ms:.3f}",
                how=f"timed alone: fwd x2 (forward, remat) + bwd, 7 projections x "
                    f"{cfg.num_hidden_layers} layers")
            work_dir = trainer.work_dir
            del trainer, eng, batch
            release(torch, "qlora_sft")
            shutil.rmtree(export)  # the source export is not needed past here
            pool = ThreadPoolExecutor(1)
            host_job = pool.submit(lambda: [(host_nf4(w), c, a) for w, c, a in check])

            # 4. the merged export, its logits, served
            merged_dir = work / "merged"
            t0 = time.perf_counter()
            convert.main(["--work-dir", str(work_dir), "--config", recipe, "--out",
                          str(merged_dir), "--device", "cuda", "--dtype", "bfloat16"])
            conv_s = time.perf_counter() - t0
            gib = sum(f.stat().st_size for f in merged_dir.glob("*.safetensors")) / 2**30
            release(torch, "convert")
            shutil.rmtree(work_dir)
            t0 = time.perf_counter()
            held = {"codes": 0, "absmax": 0, "differ": 0}
            for (codes, absmax), got_c, got_a in host_job.result():
                held["codes"] += codes.size
                held["absmax"] += absmax.size
                held["differ"] += int((got_c != codes).sum()) + int((got_a != absmax).sum())
            pool.shutdown()
            say("qlora_sft", layers_checked=QLORA_CHECK_LAYERS, codes_checked=held["codes"],
                absmax_checked=held["absmax"], differ_from_host=held["differ"],
                host_check_wait_s=f"{time.perf_counter() - t0:.1f}")
            if held["differ"]:
                raise AssertionError(f"qlora_sft: {held['differ']} codes or scales on the card "
                                     f"differ from the host quantizer's")
            del check
            merged = load_hf_checkpoint(merged_dir, model.param_specs(), model.hf_key_map(), dev,
                                        torch.bfloat16)
            got = teacher_forced(torch, model, merged, prompt, toks)
            mx, mean = tf_compare(torch, got, unmerged)
            say("qlora_sft", convert_s=f"{conv_s:.3f}", merged_export_gib=f"{gib:.3f}",
                merged_vs_unmerged_max_abs=f"{mx:.4e}", mean_abs=f"{mean:.4e}",
                tol=f"max<={MERGE_MAX_ATOL},mean<={MERGE_MEAN_ATOL}", positions=len(toks))
            if not (mx <= MERGE_MAX_ATOL and mean <= MERGE_MEAN_ATOL):
                raise AssertionError(f"qlora_sft: the merged export's log-probs differ from "
                                     f"the unmerged QLoRA model's: max {mx}, mean {mean}")
            rng = np.random.default_rng(seed)
            reqs = [{"prompt_ids": ids[s:s + n]} for s, n in
                    zip((0, 700, 1500, 3000), rng.integers(100, 600, size=4).tolist())]
            gen_cfg = GenerateConfig(max_length=2048, max_new_tokens=QLORA_SERVE_NEW,
                                     do_sample=False, prefill_chunk=0, prefix_cache=False)
            serve_eng = PagedGenerator(model, merged, gen_cfg, max_batch=4, block_size=128)
            flash_attention.launches = 0
            paged_decode_attn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = serve_eng.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches["qlora_serve"] = {"flash_fwd": flash_attention.launches,
                                       "paged_decode": paged_decode_attn.launches}
            diffs = []
            for req, o in zip(reqs, outs):
                if len(o["token_ids"]) != QLORA_SERVE_NEW or \
                        not np.isfinite(o["logprobs"]).all():
                    raise AssertionError(f"qlora_serve: bad output {o['finish_reason']}")
                tf = teacher_forced(torch, model, merged, req["prompt_ids"], o["token_ids"])
                diffs.append((tf - torch.tensor(o["logprobs"])).abs())
            diffs = torch.cat(diffs)
            say("qlora_serve", requests=len(reqs), wall_s=f"{wall:.3f}",
                generated=sum(len(o["token_ids"]) for o in outs),
                teacher_forced_max_abs=f"{diffs.max().item():.4e}",
                mean_abs=f"{diffs.mean().item():.4e}",
                tol=f"max<={TF_MAX_ATOL},mean<={TF_MEAN_ATOL}",
                launches=launches["qlora_serve"], card=repr(smi))
            need_launched("qlora_serve", launches["qlora_serve"], ("flash_fwd", "paged_decode"))
            if not (diffs.max().item() <= TF_MAX_ATOL and diffs.mean().item() <= TF_MEAN_ATOL):
                raise AssertionError("qlora_serve: decoded log-probs disagree with a "
                                     "teacher-forced forward")
            served = [len(r["prompt_ids"]) + QLORA_SERVE_NEW - 1 for r in reqs]
            del serve_eng, merged, outs
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, sft_seg, dpo_seg, served


@with_depth(QLORA_MODEL, QLORA_LAYERS)
def phase_lora_profile(torch, seed: int) -> None:
    """Where a fine-tuning step's time goes: the LoRA recipe's engine made
    again (random base from the seed), one step of its 8 rows as 8
    micro-batches of one row (the recipe's geometry) and as one micro-batch
    of 8, each timed after a warm-up step (the gap is the host's: a
    profiler window of its ~86k launches costs more than the step); then
    the QLoRA recipe's engine (Qwen3-8B whole, random codes: the time does
    not read their values) and one profiled step of its row with the NF4
    dequantize (`record_function`) apart. Runs with the other profile
    windows, last."""
    import numpy as np

    from xtuner_tpu_torch.engine.train_engine import TrainEngine
    from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer
    from xtuner_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(Path(__file__).resolve().parent / LORA_RECIPE))["trainer"]
    eng = TrainEngine(cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg, 10)
    eng.init_random(seed)
    dl = dataclasses.replace(cfg.dataloader_cfg, tokenize_num_proc=1).build(
        UTF8ByteTokenizer(), cfg.global_batch_rows, cfg.micro_batch_rows)
    batch = next(iter(dl))
    dl.close()
    one = {k: np.asarray(v).reshape(1, -1, *np.asarray(v).shape[2:]) for k, v in batch.items()}
    times = {}
    for label, b in (("micro_1x8", batch), ("micro_8x1", one)):
        eng.train_step(b, 1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.train_step(b, 2)
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) * 1e3
    say("lora_profile", step_ms_8_micro_batches_of_1=f"{times['micro_1x8']:.1f}",
        step_ms_1_micro_batch_of_8=f"{times['micro_8x1']:.1f}")
    del eng, batch, one
    gc.collect()
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    cfg = Config.fromfile(str(Path(__file__).resolve().parent / QLORA_RECIPE))["trainer"]
    eng = TrainEngine(cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg, 10)
    eng.init_random(seed)
    g = torch.Generator(device=dev).manual_seed(seed + 71)
    with torch.no_grad():
        for stack in (eng.params["layers"]["attn"], eng.params["layers"]["mlp"]):
            for name in QLORA_TARGETS:
                if name in stack:
                    stack[name]["w_q4"].copy_(torch.randint(0, 256, stack[name]["w_q4"].shape,
                                                            generator=g, device=dev,
                                                            dtype=torch.uint8))
                    stack[name]["w_absmax"].fill_(0.05)
    dl = dataclasses.replace(cfg.dataloader_cfg, tokenize_num_proc=1).build(
        UTF8ByteTokenizer(), cfg.global_batch_rows, cfg.micro_batch_rows)
    batch = next(iter(dl))
    dl.close()
    eng.train_step(batch, 1)  # warm-up
    with annotated(torch, {"nf4_dequantize": [("xtuner_tpu_torch.module.lora",
                                               "dequantize_nf4")]}):
        profile_window(torch, "qlora_step", lambda: eng.train_step(batch, 2),
                       annotations=("nf4_dequantize",))
    del eng, batch


def flash_path_rows(torch, g, seg, hq: int, hkv: int, d: int, path: str, label: str,
                    smi: str, max_free: bool, two_pass_path=None,
                    by_row: bool = False) -> list[dict]:
    """#1 and the grouped backward (#2 + #3), and with `two_pass_path` the
    two-pass one (#2 + #4), against their plain versions (one kv head's
    q-head group at a time, and with `by_row` one batch row at a time: an
    (L, L) slab per group and row) on one path's rows `seg` (B, L): errors,
    two backward launches the same bits (required at 64/64), times, the
    bound on the visible pairs and SDPA (dense block-causal mask) forward
    and backward."""
    from xtuner_tpu_torch.ops.attention import flash as fl

    dev = torch.device("cuda")
    src = "xtuner_tpu_torch/csrc/"
    seg = seg.to(dev).to(torch.int32).contiguous()
    b, l = seg.shape
    scale = d ** -0.5
    q, k, v, do = (torch.randn((b, l, h, d), generator=g, device=dev).bfloat16()
                   for h in (hq, hkv, hkv, hq))
    bound = torch.tensor(d ** 0.5, device=dev) if max_free else None
    valid = seg != 0
    pairs = causal_pairs(torch, seg)
    shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}, {int(valid.sum())} rows ({label})"
    name = "flash_fwd_max_free" if max_free else "flash_fwd"
    rowwise = (lambda fn, *ts: [torch.cat(x) for x in zip(*(fn(*(t[i:i + 1] for t in ts))
                                                          for i in range(b)))]) \
        if by_row else (lambda fn, *ts: fn(*ts))
    (ro, rlse), fwd_plain = timed_once(torch, lambda: rowwise(
        lambda *ts: flash_plain_by_group(torch, *ts, scale, None), q, k, v, seg))
    fl.reset_launches()
    out, lse = fl.flash_attention(q, k, v, seg, max_logit=bound)
    if fl.max_free_launches() != int(max_free):
        raise AssertionError(f"#1 at {shape} took the wrong variant")
    err = max(_abs(out[valid], ro[valid]), _abs(lse.transpose(1, 2)[valid],
                                                rlse.transpose(1, 2)[valid]))
    ok = _abs(out[valid], ro[valid]) <= FLASH_OUT_ATOL and \
        _abs(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid]) <= FLASH_LSE_ATOL
    del ro, rlse
    ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=10)
    mask = block_causal_mask(torch, seg)
    lib, backend, how = sdpa_or_none(torch, q, k, v, mask)
    fb = least_ms(2 * pairs * hq * 2 * d, flash_bytes(q, k), PEAK_BF16)
    say("kernel", name=name, path=path, shape=shape, pairs=pairs, err=f"{err:.3e}", ok=ok,
        ms=f"{ms:.4f}", plain_ms=f"{fwd_plain:.3f}", bound_ms=f"{fb['bound_ms']:.4f}",
        bound_by=fb["bound_by"], share_of_bound=f"{fb['bound_ms'] / ms:.3f}", sdpa_ms=lib,
        sdpa_backend=backend, card=repr(smi))
    if not ok:
        raise AssertionError(f"#1 at {shape} disagrees with its plain version: {err}")
    rows = [{"name": name, "route": "cuda", "source": src + "flash_fwd.cu",
             "function": f"flash_fwd_kernel<{d}, {d}>",
             "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": path,
             "shape": f"{shape}, {'max-free' if max_free else 'running max'}",
             "max_abs_err": err, "ms": ms, "plain_ms": fwd_plain, **fb, "library_ms": lib,
             "library_is": f"SDPA {backend}, block-causal dense mask, {how}"}]
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, lse, delta, do, scale)
    lib_bwd, backend_bwd, how_bwd = sdpa_or_none(torch, q, k, v, mask, do)
    del mask
    for two_pass in ((False, True) if two_pass_path else (False,)):
        want, plain_ms = timed_once(torch, lambda: rowwise(
            lambda *ts: flash_bwd_plain_by_group(torch, *ts, scale, None, two_pass),
            q, k, v, seg, lse, delta, do))
        fl.reset_launches()
        got = fl.flash_bwd(*args, two_pass)
        again = fl.flash_bwd(*args, two_pass)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        rels = [_rel(t[valid], w[valid]) for t, w in zip(got, want)]
        berr = max(_abs(t[valid], w[valid]) for t, w in zip(got, want))
        del got, want
        bms = cuda_ms(lambda: fl.flash_bwd(*args, two_pass), iters=10)
        bnd = bwd_bound(q, k, pairs, two_pass)
        bname = "flash_bwd_two_pass" if two_pass else "flash_bwd"
        say("kernel", name=bname, path=path, shape=shape,
            dq_dk_dv_rel=",".join(f"{x:.3e}" for x in rels), err=f"{berr:.3e}",
            same_bits=same, ms=f"{bms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            share_of_bound=f"{bnd['bound_ms'] / bms:.3f}", sdpa_bwd_ms=lib_bwd,
            sdpa_backend=backend_bwd, card=repr(smi))
        # the 128/128 one pass sums dq with an f32 bulk reduce-add: two
        # launches are not the same bits there (printed); the split kernels
        # (64/64) write every output once
        if max(rels) > FLASH_GRAD_RTOL or (d != 128 and not same):
            raise AssertionError(f"the backward ({bname}) at {shape}: {rels} (<= "
                                 f"{FLASH_GRAD_RTOL}), two launches the same bits {same}")
        for line in (199, 249 if two_pass else 303):
            rows.append({"name": bname, "route": "cuda", "source": src + "flash_bwd.cu",
                         "replaces": f"xtuner_tpu/ops/attention/flash.py:{line}",
                         "path": two_pass_path if two_pass else path, "shape": shape,
                         "max_abs_err": berr, "ms": bms, "plain_ms": plain_ms, **bnd,
                         "library_ms": lib_bwd,
                         "library_is": f"SDPA backward {backend_bwd}, {how_bwd}",
                         "plain_is": "flash_bwd_plain one q-head group at a time"})
    del q, k, v, do, out, lse, delta, args
    gc.collect()
    torch.cuda.empty_cache()
    fl.reset_launches()
    return rows


def phase_lora_kernels(torch, seed: int, smi: str, lora_seg, sft_seg, dpo_seg,
                       served: list) -> list[dict]:
    """The fine-tuning paths' kernels against their plain versions at their
    own shapes: #1 and #2-#4 at (64, 64) with a group of 7 (14 / 2 heads,
    causal, no window) on the LoRA recipe's first row (the two-pass #4 on
    the row of `gpt_oss_train_two_pass`, which launches the same
    instantiation: this path runs the grouped backward); #1-#3 at 128/128,
    32 / 8 heads, max-free (qk-norm), on the QLoRA recipe's 8192-token row
    and on DPO's 8 rows of 2048; #8 and #9 (the coefficient sweep and dh) at
    N8192 H4096 V151936 (an untied head: the QLoRA recipe's fused CE) with
    `torch.mm` over one N x V x H product as a yardstick; #5 at the merged
    export's serving shape (4 slots at their final lengths)."""
    from xtuner_tpu_torch.ops import fused_ce as fc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 67)
    rows = flash_path_rows(torch, g, lora_seg, LORA_HQ, LORA_HKV, LORA_D, "lora_sft",
                           "recipe row", smi, False, two_pass_path="gpt_oss_train_two_pass")
    rows += flash_path_rows(torch, g, sft_seg, QLORA_HQ, QLORA_HKV, QLORA_D, "qlora_sft",
                            "recipe row", smi, True)
    rows += flash_path_rows(torch, g, dpo_seg, QLORA_HQ, QLORA_HKV, QLORA_D, "dpo",
                            "4 pairs", smi, True)

    # ---- #8 / #9 at the QLoRA recipe's CE: N8192 H4096 V151936, untied
    n, hd, vocab = sft_seg.shape[-1], QLORA_H, QLORA_V
    src = "xtuner_tpu_torch/csrc/"
    h2 = torch.randn((n, hd), generator=g, device=dev).bfloat16()
    emb = (torch.randn((vocab, hd), generator=g, device=dev) * 0.02).bfloat16()
    safe = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    ref_lse, ref_lab = fc.ce_fwd_plain(h2, emb, safe)
    cot = torch.randn((n,), generator=g, device=dev)
    g_lse, g_lab = cot.contiguous(), (-cot).contiguous()
    args = (h2, emb, safe, ref_lse, g_lse, g_lab)
    lse, lab = fc.ce_fwd(h2, emb, safe)
    stat_err = max(_abs(lse, ref_lse), _abs(lab, ref_lab))
    plan = fc.ce_chunk_plan(n, vocab)
    # (max abs error, the bound on it): the statistics to CE_STAT_ATOL, c and
    # dh to GG_RTOL of their plain versions' largest entry

    def sweep(kernel: bool):
        c = torch.empty((plan.rows, plan.v_pad), device=dev, dtype=torch.bfloat16)
        for s0, r in plan.chunks:
            sl = slice(s0, s0 + r)
            part = (h2[sl], emb, safe[sl], ref_lse[sl], g_lse[sl], g_lab[sl], plan.v_pad)
            if kernel:
                fc.ce_coeff(*part, out=c[:r])
            else:
                c[:r] = fc.ce_coeff_plain(*part)
        return c

    c_k, c_p = sweep(True), sweep(False)
    c_err, c_tol = _abs(c_k, c_p), GG_RTOL * c_p.float().abs().max().item()
    del c_k, c_p
    dh_k, dh_p = fc.ce_dh(*args), fc.ce_dh_plain(*args)
    dh_err, dh_tol = _abs(dh_k, dh_p), GG_RTOL * dh_p.float().abs().max().item()
    del dh_k, dh_p
    mm_ms = cuda_ms(lambda: torch.mm(h2, emb.T), iters=5, warmup=1)
    ins = 2 * n * hd + 2 * vocab * hd + 4 * n
    timed = {"ce_fwd": (lambda: fc.ce_fwd(h2, emb, safe), lambda: fc.ce_fwd_plain(h2, emb, safe),
                        (stat_err, CE_STAT_ATOL), "xtuner_tpu/ops/fused_ce.py:47", 1,
                        ins + 8 * n),
             "ce_coeff": (lambda: sweep(True), lambda: sweep(False), (c_err, c_tol),
                          "xtuner_tpu/ops/fused_ce.py:98", 1, ins + 12 * n + 2 * n * plan.v_pad),
             "ce_dh": (lambda: fc.ce_dh(*args), lambda: fc.ce_dh_plain(*args), (dh_err, dh_tol),
                       "xtuner_tpu/ops/fused_ce.py:98", 2, ins + 12 * n + 2 * n * hd)}
    for name, (kern, plain_fn, (err, tol), replaces, mult, nbytes) in timed.items():
        ms = cuda_ms(kern, iters=3, warmup=1)
        pms = cuda_ms(plain_fn, iters=1, warmup=1)
        b_ = least_ms(2 * n * vocab * hd * mult, nbytes, PEAK_BF16)
        say("kernel", name=name, path="qlora_sft", shape=f"N{n} H{hd} V{vocab} untied",
            err=f"{err:.3e}", tol=f"{tol:.3e}", ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            bound_ms=f"{b_['bound_ms']:.4f}", share_of_bound=f"{b_['bound_ms'] / ms:.3f}",
            mm_ms=f"{mm_ms:.4f}", card=repr(smi))
        if not err <= tol:
            raise AssertionError(f"{name} at N{n} H{hd} V{vocab} disagrees with its plain "
                                 f"version: {err} (<= {tol})")
        rows.append({"name": name, "route": "cuda", "source": src + "fused_ce.cu",
                     "replaces": replaces, "path": "qlora_sft",
                     "shape": f"N{n} H{hd} V{vocab} untied (the QLoRA recipe's CE)",
                     "max_abs_err": err, "ms": ms, "plain_ms": pms, **b_, "library_ms": None,
                     "mm_ms": mm_ms})
    del h2, emb, safe, ref_lse, ref_lab, cot, g_lse, g_lab, args, lse, lab
    gc.collect()
    torch.cuda.empty_cache()

    # ---- #5 at the merged export's serving shape
    mb = -(-max(served) // PAGED_BS) + 1
    rows.append(paged_row("qlora_serve", check_paged(torch, seed, "qlora_serve", served, mb)))
    reset_train_launches()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--breakdown", action="store_true",
                    help="also break one SFT step's memory and time down by remat "
                         "policy and CE mode")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import xtuner_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    smi = phase_env(torch)
    phase_build()
    kernels = phase_kernels(torch, args.seed)
    kernels += phase_train_kernels(torch, args.seed)
    kernels += phase_gpt_oss_kernels(torch, args.seed, smi)
    release(torch, "gpt_oss_kernels")
    # before serve: serve's profile windows slow every later host launch,
    # and the serving decode loops are host-bound
    launches = {"serve_cli": phase_serve_cli(torch, args.seed, smi)}
    release(torch, "serve_cli")
    kernels += [serving_flash_row(torch, args.seed, "serve_cli", SERVE_PREFILL_CHUNK,
                                  SERVE_PREFILL_CHUNK),
                paged_row("serve_cli", check_paged(torch, args.seed, "serve_cli",
                                                   *SERVE_PAGED_SHAPE))]
    launches["serve_gpt_oss"] = phase_serve_gpt_oss(torch, args.seed, smi)
    release(torch, "serve_gpt_oss")
    launches["serve_qwen35"] = phase_serve_qwen35(torch, args.seed, smi)
    release(torch, "serve_qwen35")
    # GRPO before serving too: its rollout's decode loop is host-bound
    with tempfile.TemporaryDirectory(prefix="xt_rl_") as work:
        cwd = os.getcwd()
        os.chdir(work)  # the recipes write their prompt set under work_dirs/ here
        try:
            launches["rl_grpo_rollout"], launches["rl_grpo_step"], capture, rl_segs = \
                phase_rl_grpo(torch, work, smi)
            release(torch, "rl_grpo")
            phase_rl_replay(torch, work, capture, smi, args.seed)
            release(torch, "rl_replay")
            launches["rl_moe_r3_rollout"], launches["rl_moe_r3_step"] = \
                phase_rl_moe_r3(torch, work, smi)
            release(torch, "rl_moe_r3")
        finally:
            os.chdir(cwd)
    rows, launches["rl_logprobs_fused"] = phase_rl_kernels(torch, args.seed, smi, rl_segs)
    kernels += rows
    release(torch, "rl_kernels")
    kernels += phase_qwen35_kernels(torch, args.seed, smi)
    release(torch, "qwen35_kernels")
    launches["serve"] = phase_engine(torch, args.seed, smi)
    release(torch, "serve")
    phase_paged_device_time(torch, args.seed, kernels)
    release(torch, "paged_device_time")
    launches["train"] = phase_train(torch, args.seed, smi)
    release(torch, "train")
    kernels += phase_ce_kernels(torch, args.seed)
    release(torch, "ce_kernels")
    kernels += phase_moe_heavy_kernels(torch, args.seed)
    release(torch, "moe_heavy_kernels")
    kernels += phase_fp8_kernels(torch, args.seed)
    release(torch, "fp8_kernels")
    launches["sft"], losses = phase_sft(torch, smi, args.breakdown)
    release(torch, "sft")
    launches["sft_fp8"], _ = phase_sft(torch, smi, False, fp8_ref_loss1=losses[0])
    release(torch, "sft_fp8")
    kernels += phase_longctx_kernels(torch, args.seed, smi)
    release(torch, "longctx_kernels")
    launches["longctx"] = phase_longctx(torch, args.seed, smi)
    release(torch, "longctx")
    launches["sft_switched"], _ = phase_sft(torch, smi, False, switched_ref=losses)
    release(torch, "sft_switched")
    kernels += phase_dsa_kernels(torch, args.seed, smi)
    release(torch, "dsa_kernels")
    launches["glm52_dsa"], rows = phase_glm52_dsa(torch, args.seed, smi)
    kernels += rows
    release(torch, "glm52_dsa")
    launches["deepseek_mla"], launches["deepseek_mla_save_out_lse"], recipe_seg = \
        phase_deepseek_mla(torch, args.seed, smi)
    release(torch, "deepseek_mla")
    kernels += phase_mla_kernels(torch, args.seed, smi, recipe_seg)
    release(torch, "mla_kernels")
    launches["glm45_air_head"], launches["glm45_air_head_fused"], air_seg = \
        phase_glm45_air_head(torch, args.seed, smi)
    release(torch, "glm45_air_head")
    kernels += phase_glm45_kernels(torch, args.seed, smi, air_seg)
    release(torch, "glm45_kernels")
    launches["moe_heavy_mtp"] = phase_moe_heavy_mtp(torch, smi, losses[0])
    release(torch, "moe_heavy_mtp")
    launches["gpt_oss_train"], launches["gpt_oss_train_two_pass"], oss_seg = \
        phase_gpt_oss_train(torch, args.seed, smi)
    release(torch, "gpt_oss_train")
    kernels += phase_gpt_oss_train_kernels(torch, args.seed, smi, oss_seg)
    release(torch, "gpt_oss_train_kernels")
    launches["qwen35_train"], launches["qwen35_train_two_pass"], qwen_seg = \
        phase_qwen35_train(torch, args.seed, smi)
    release(torch, "qwen35_train")
    kernels += phase_qwen35_train_kernels(torch, args.seed, smi, qwen_seg)
    release(torch, "qwen35_train_kernels")
    launches["vlm_train"], launches["vlm_train_two_pass"], vlm_seg = \
        phase_vlm_train(torch, args.seed, smi)
    release(torch, "vlm_train")
    kernels += phase_vlm_kernels(torch, args.seed, smi, vlm_seg)
    release(torch, "vlm_kernels")
    launches["internvl_sft"], launches["internvl_sft_two_pass"], vit_seg, llm_seg = \
        phase_internvl_sft(torch, args.seed, smi)
    release(torch, "internvl_sft")
    kernels += phase_internvl_kernels(torch, args.seed, smi, vit_seg, llm_seg)
    release(torch, "internvl_kernels")
    launches["vlm8b_align"], launches["vlm8b_align_two_pass"], v8_seg = \
        phase_vlm8b_align(torch, args.seed, smi)
    release(torch, "vlm8b_align")
    kernels += phase_vlm8b_kernels(torch, args.seed, smi, v8_seg)
    release(torch, "vlm8b_kernels")
    # the fine-tuning paths (after every other training phase, before the
    # profile windows): LoRA, the reward model, QLoRA with DPO / ORPO
    launches["lora_sft"], lora_seg = phase_lora_sft(torch, args.seed, smi)
    release(torch, "lora_sft")
    launches["reward"] = phase_reward(torch, smi)
    release(torch, "reward")
    qlora_launches, sft_seg, dpo_seg, served = phase_qlora(torch, args.seed, smi)
    launches.update(qlora_launches)
    release(torch, "qlora")
    kernels += phase_lora_kernels(torch, args.seed, smi, lora_seg, sft_seg, dpo_seg, served)
    release(torch, "lora_kernels")
    phase_lora_profile(torch, args.seed)
    release(torch, "lora_profile")
    phase_gpt_oss_profile(torch, args.seed)
    release(torch, "gpt_oss_profile")
    phase_rl_profile(torch, args.seed)
    for kern in kernels:
        kern["launches"] = launches[kern["path"]][kern["name"]]
        kern.pop("_bound_parts", None)
    say("done", total_s=f"{time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
