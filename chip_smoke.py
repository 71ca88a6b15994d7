#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, its MoE SFT train step and its
SFT entry point, in bf16 and in tile-wise fp8, once on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--breakdown]

Phases, each printed on its own line; any failure raises and the script
exits non-zero with no result line:

1. environment: torch / CUDA / triton / nvcc versions, the card, its power
   limit;
2. kernel build (nvcc, one process per source in xtuner_tpu_torch/csrc/,
   all started together);
3. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes its path gives it and at odd shapes, with times, the
   least time the card could take (`least_ms`) and the time of the one
   PyTorch call that computes the same function, where there is one;
4. serving: `PagedGenerator.generate` on Qwen3-8B at full width and depth
   with random bf16 weights from the seed; 6 requests on 4 slots (one GRPO
   group of two); launch counters of its kernels; a teacher-forced re-check
   of the decoded logprobs; one sampled run; prefill and decode tokens/s;
5. training: `TrainEngine.train_step` on Qwen3-30B-A3B at full width, depth
   cut to 4 layers, random f32 masters from the seed, 4 steps on one packed
   8192-token row of 5 documents; loss, grad norm, lr, step time, tokens/s
   and peak memory per step; launch counters of its kernels against the
   counts the step implies; one profiled step;
6. the fused CE kernels (#8-#10) at N = 2 x 8192, H = 1024, V = 151936
   and at an odd shape, with times and peak memory; then flash at B2 with
   16/8 heads and the grouped GEMMs at 16 experts (moe_heavy's shapes);
   then the fp8 kernels (#11-#13) at every moe_heavy fp8 shape and odd ones,
   in both operand-type variants;
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
   step with the quantise passes' device time apart.

Between phases it frees what the last one held and checks that nothing
large stays allocated, so each peak is the phase's own. Then a JSON line
of the kernels, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

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
# fp8 GEMMs vs their plain versions (see tests/test_torch_kernels.py): the
# same exact fp8 products, bf16 outputs rounded once (relative to the
# largest entry), f32 outputs (the wgrad) only in another order; and the
# mean relative error of the fp8 product against the unquantised bf16 one,
# the bound of JAX's fp8 tests
FP8_RTOL = 1e-2
FP8_DW_RTOL = 2e-3
FP8_VS_BF16_MEAN = 0.06
# what may stay allocated between phases (the kernels' small device buffers)
RELEASED_GIB = 1.0
# the least time the card could take (NVIDIA H100 SXM data sheet, dense):
# operations over the peak rate of their type, bytes (each input read once,
# each output written once) over the memory rate; the larger of the two
PEAK_BF16 = 989e12
PEAK_FP8 = 1979e12
HBM_BYTES_S = 3.35e12

MAX_NEW = 32


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
            ptxas.append("kernel " + ln.split("'")[1].split("_cu_")[-1][:60])
        elif "registers" in ln or "spill" in ln:
            ptxas.append(ln.strip())
    say("build", library=so.name, nvcc_s=f"{nvcc_s:.3f}",
        total_s=f"{time.perf_counter() - t0:.3f}")
    for ln in ptxas:
        print(f"[build] ptxas {ln}", flush=True)


def phase_kernels(torch, seed: int) -> list[dict]:
    from xtuner_tpu_torch.ops.attention.flash import (BIG_LSE, flash_attention,
                                                      flash_attention_plain)
    from xtuner_tpu_torch.ops.attention.paged_decode import (paged_decode_attn,
                                                             paged_decode_attn_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    # flash at the slice's prefill: one 1000-token prompt in a 1024 bucket
    b, l, real, hq, hkv, d = 1, 1024, 1000, 32, 8, 128
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
    say("kernel", name="flash_fwd", shape=f"B{b}xL{l}({real} real)xHq{hq}xHkv{hkv}xD{d}",
        out_err=f"{out_err:.3e}", lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok,
        ms=f"{f_ms:.4f}", plain_ms=f"{f_plain:.4f}")
    if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok):
        raise AssertionError(f"flash kernel disagrees with its plain version: out "
                             f"{out_err} (<= {FLASH_OUT_ATOL}), lse {lse_err} "
                             f"(<= {FLASH_LSE_ATOL}), padding rows ok {pad_ok}")

    # paged decode at the slice's decode: 4 slots, block 128, one inactive
    bs, mb, n_layers = 128, 16, 2
    lens = [1000, 0, 517, 1900]
    nb = len(lens) * mb + 1
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
    table = table.to(dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    od = paged_decode_attn(qd, pk, pv, 1, table, seq_lens, scale=scale)
    ref_d = paged_decode_attn_plain(qd, pk, pv, 1, table, seq_lens, scale=scale)
    torch.cuda.synchronize()
    d_err = (od - ref_d).abs().max().item()
    finite = bool(torch.isfinite(od).all())
    p_ms = cuda_ms(lambda: paged_decode_attn(qd, pk, pv, 1, table, seq_lens, scale=scale))
    p_plain = cuda_ms(lambda: paged_decode_attn_plain(qd, pk, pv, 1, table, seq_lens,
                                                      scale=scale))
    say("kernel", name="paged_decode", shape=f"B{len(lens)}xC1xHq{hq}xHkv{hkv}xD{d}xBS{bs}",
        seq_lens=",".join(map(str, lens)), err=f"{d_err:.3e}", finite=finite,
        ms=f"{p_ms:.4f}", plain_ms=f"{p_plain:.4f}")
    if not (d_err <= PAGED_ATOL and finite):
        raise AssertionError(f"paged decode kernel disagrees with its plain version: "
                             f"{d_err} (<= {PAGED_ATOL}), finite {finite}")
    f_lib, f_why = sdpa_ms(torch, q, k, v, seg)
    active = [n + 1 for n in lens if n]  # keys each active slot reads (cache + this token)
    say("kernel", name="library", flash_fwd_sdpa_ms=f_lib, why=repr(f_why),
        paged_decode="none: no PyTorch call reads a block-table KV cache")
    return [
        {"name": "flash_fwd", "route": "cuda", "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "serve", "launches": 0,
         "max_abs_err": max(out_err, lse_err), "ms": f_ms, "plain_ms": f_plain,
         **least_ms(4 * causal_pairs(torch, seg) * hq * d, flash_bytes(q, k), PEAK_BF16),
         "library_ms": f_lib},
        {"name": "paged_decode", "route": "cuda",
         "source": "xtuner_tpu_torch/csrc/paged_decode.cu",
         "replaces": "xtuner_tpu/ops/attention/paged_decode.py:66", "path": "serve",
         "launches": 0,
         "max_abs_err": d_err, "ms": p_ms, "plain_ms": p_plain,
         **least_ms(4 * sum(active) * hq * d,
                 4 * sum(active) * hkv * d + len(lens) * hq * d * (2 + 4), PEAK_BF16),
         "library_ms": None},
    ]


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


def sdpa_ms(torch, q, k, v, seg, do=None, iters: int = 5):
    """`scaled_dot_product_attention` with the block-diagonal causal mask
    and GQA on the flash kernels' (B, L, H, D) inputs: the forward, or with
    `do` the backward (one call giving dq, dk and dv together)."""
    import torch.nn.functional as F

    mask = block_causal_mask(torch, seg)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if do is None:
        return library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)
    return library_ms(torch, lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True),
                      iters)


def flash_bytes(q, k, out_like: int = 1) -> int:
    """q, k, v read once (bf16), out written (bf16) and lse (f32)."""
    b, l, hq, d = q.shape
    hkv = k.shape[2]
    return 2 * b * l * d * (hq + 2 * hkv) + out_like * 2 * b * l * hq * d + 4 * b * hq * l


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


def grouped_cases(x, hmid, w_gu, w_dn, dy_gu, dy_dn, sizes, e) -> list:
    """The bf16 grouped GEMMs one MoE layer runs (gate|up and down; forward
    nn, dgrad nt, wgrad dw): (kernel, which, kernel call, plain call, the
    library call's inputs, operations, bytes)."""
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
    return cases


def grouped_rows(torch, path: str, cases, m: int, e: int, iters: int,
                 plain_iters: int) -> list[dict]:
    """Each grouped GEMM against its plain version and `torch._grouped_mm`;
    one row per kernel: the worst error of its GEMMs, the times and bounds
    summed over the two GEMMs the layer runs it on."""
    by_name: dict = {}
    for name, which, kern, plain, (a, b_, kind, sz), flops, nbytes in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, rel = _abs(got, want), _rel(got, want)
        del got, want
        ms = cuda_ms(kern, iters=iters)
        pms = cuda_ms(plain, iters=plain_iters, warmup=1)
        lib, why = grouped_mm_ms(torch, a, b_, sz, kind)
        say("kernel", name=name, gemm=which, m=m, experts=e, err=f"{err:.3e}",
            rel=f"{rel:.3e}", ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", library_ms=lib,
            why=repr(why), tflops=f"{flops / ms / 1e9:.1f}",
            plain_tflops=f"{flops / pms / 1e9:.1f}")
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
        add_bound(row, least_ms(flops, nbytes, PEAK_BF16))
    return list(by_name.values())


def phase_train_kernels(torch, seed: int) -> list[dict]:
    """The train slice's kernels against their plain versions at the shapes
    the step gives them (Qwen3-30B-A3B, one 8192-token row) and at odd
    shapes."""
    import numpy as np

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
    say("kernel", name="flash_fwd_max_free",
        shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}", docs=",".join(map(str, lens)),
        out_err=f"{mf_out_err:.3e}", lse_err=f"{mf_lse_err:.3e}", pad_rows_ok=mf_pad_ok,
        ms=f"{mf_ms:.4f}", running_max_ms=f"{rm_ms:.4f}", plain_ms=f"{mf_plain:.4f}")
    if not (mf_out_err <= FLASH_OUT_ATOL and mf_lse_err <= FLASH_LSE_ATOL and mf_pad_ok):
        raise AssertionError(f"max-free flash disagrees with its plain version: out "
                             f"{mf_out_err} (<= {FLASH_OUT_ATOL}), lse {mf_lse_err} "
                             f"(<= {FLASH_LSE_ATOL}), padding rows ok {mf_pad_ok}")
    pairs = causal_pairs(torch, seg)
    lib_fwd, why_fwd = sdpa_ms(torch, q, k, v, seg)
    rows.append({"name": "flash_fwd_max_free", "route": "cuda",
                 "source": "xtuner_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "train",
                 "max_abs_err": mf_err, "ms": mf_ms, "plain_ms": mf_plain,
                 **least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16),
                 "library_ms": lib_fwd})

    do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fl.flash_dq(q, k, v, seg, lse, delta, do, scale)
    ref = fl.flash_dq_plain(q, k, v, seg, lse, delta, do, scale)
    dq_err, dq_rel = _abs(dq, ref), _rel(dq, ref)
    del ref
    dk, dv = fl.flash_dkv(q, k, v, seg, lse, delta, do, scale)
    ref_dk, ref_dv = fl.flash_dkv_plain(q, k, v, seg, lse, delta, do, scale)
    dkv_err = max(_abs(dk, ref_dk), _abs(dv, ref_dv))
    dkv_rel = max(_rel(dk, ref_dk), _rel(dv, ref_dv))
    del ref_dk, ref_dv
    dq_ms = cuda_ms(lambda: fl.flash_dq(q, k, v, seg, lse, delta, do, scale), iters=10)
    dq_plain = cuda_ms(lambda: fl.flash_dq_plain(q, k, v, seg, lse, delta, do, scale),
                       iters=3, warmup=1)
    dkv_ms = cuda_ms(lambda: fl.flash_dkv(q, k, v, seg, lse, delta, do, scale), iters=10)
    dkv_plain = cuda_ms(lambda: fl.flash_dkv_plain(q, k, v, seg, lse, delta, do, scale),
                        iters=3, warmup=1)
    lib_bwd, why_bwd = sdpa_ms(torch, q, k, v, seg, do)
    say("kernel", name="flash_dq", shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}",
        err=f"{dq_err:.3e}", rel=f"{dq_rel:.3e}", ms=f"{dq_ms:.4f}", plain_ms=f"{dq_plain:.4f}")
    say("kernel", name="flash_dkv", shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}",
        err=f"{dkv_err:.3e}", rel=f"{dkv_rel:.3e}", ms=f"{dkv_ms:.4f}",
        plain_ms=f"{dkv_plain:.4f}")
    say("kernel", name="library", shape=f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}",
        sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd, why=repr(f"{why_fwd}; {why_bwd}"))
    bwd_in = flash_bytes(q, k, out_like=2) + 4 * b * hq * l  # q, k, v, do; lse, delta
    if not (dq_rel <= FLASH_GRAD_RTOL and dkv_rel <= FLASH_GRAD_RTOL):
        raise AssertionError(f"flash backward kernels disagree with their plain versions: "
                             f"dq {dq_rel}, dk/dv {dkv_rel} (<= {FLASH_GRAD_RTOL})")
    rows += [{"name": "flash_dq", "route": "cuda", "source": "xtuner_tpu_torch/csrc/flash_bwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:199", "path": "train",
              "max_abs_err": dq_err, "ms": dq_ms, "plain_ms": dq_plain,
              **least_ms(6 * pairs * hq * d, bwd_in + 2 * b * l * hq * d, PEAK_BF16),
              "library_ms": lib_bwd},
             {"name": "flash_dkv", "route": "cuda", "source": "xtuner_tpu_torch/csrc/flash_bwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:303", "path": "train",
              "max_abs_err": dkv_err, "ms": dkv_ms, "plain_ms": dkv_plain,
              **least_ms(8 * pairs * hq * d, bwd_in + 4 * b * l * hkv * d, PEAK_BF16),
              "library_ms": lib_bwd}]
    del q, k, v, do, out, lse, delta, dq, dk, dv

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
           (5000, 256, 224, [0, 1200, 0, 3000, 1]))  # ragged edges; 799 rows past the last
    for mm, kk_, nn_, sz in odd:
        ee = len(sz)
        gs = torch.tensor(sz, dtype=torch.int32, device=dev)
        xx = torch.randn((mm, kk_), generator=g, device=dev).bfloat16()
        ww = (torch.randn((ee, kk_, nn_), generator=g, device=dev) * 0.05).bfloat16()
        yy = torch.randn((mm, nn_), generator=g, device=dev).bfloat16()
        rels = [_rel(grouped_gemm_bf16(xx, ww, gs), grouped_gemm_plain(xx, ww, gs)),
                _rel(grouped_gemm_bf16(yy, ww, gs, transpose_rhs=True),
                     grouped_gemm_plain(yy, ww, gs, transpose_rhs=True))]
        dw_rel = _rel(grouped_gemm_bf16_dw(xx, yy, gs, ee),
                      grouped_gemm_dw_plain(xx, yy, gs, ee))
        xl, wl = xx.clone().requires_grad_(True), ww.clone().requires_grad_(True)
        (bf16_grouped_linear(xl, wl, gs).float() * yy.float()).sum().backward()
        xr, wr = xx.float().requires_grad_(True), ww.float().requires_grad_(True)
        (grouped_gemm_plain(xr, wr, gs).float() * yy.float()).sum().backward()
        rels += [_rel(xl.grad, xr.grad), _rel(wl.grad, wr.grad)]
        say("kernel", name="grouped_gemm_odd", m=mm, k=kk_, n=nn_, experts=ee,
            empty=sum(1 for v_ in sz if v_ == 0), rows=sum(sz),
            nn_nt_grad_rel=",".join(f"{r_:.2e}" for r_ in rels), dw_rel=f"{dw_rel:.2e}")
        if not (max(rels) <= GG_RTOL and dw_rel <= DW_RTOL):
            raise AssertionError(f"grouped GEMMs disagree at an odd shape: {rels}, {dw_rel}")
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
    """The fused CE kernels (#8-#10) against their plain versions: at the
    moe_heavy step's N = 2 x 8192, H = 1024, V = 151936 with 5% ignored
    labels, then at odd shapes (N not a multiple of the 128-row tile, V
    below one tile; a ragged vocab tail). The backward is checked under
    several cotangents: both terms; g_lse alone, so that dh and dW are the
    softmax part alone and the bound is relative to its own scale (with
    both, the label term's entries dominate dW at V = 151936, where p is
    ~1/V); g_lab alone. CUDA-event times and the peak memory of each call,
    kernel and plain, under the first cotangents of each shape."""
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

    main_n = SFT_ROWS * SEQ
    for n, v, hd, cotangents in ((main_n, 151936, 1024, ("both", "g_lse")),
                                 (1000, 100, 128, ("g_lab", "both")),
                                 (300, 5000, 256, ("g_lse",))):
        h, w, labels, g_lse_all, g_lab_all = ce_inputs(n, v, hd, 0.05)
        lse, lab = fc.ce_fwd(h, w, labels)
        ref_lse, ref_lab = fc.ce_fwd_plain(h, w, labels)
        stat_err = max(_abs(lse, ref_lse), _abs(lab, ref_lab))
        shape = f"N{n}xH{hd}xV{v}"
        if not stat_err <= CE_STAT_ATOL:
            raise AssertionError(f"ce_fwd disagrees with its plain version at {shape}: "
                                 f"lse/label {stat_err} (<= {CE_STAT_ATOL})")
        for cot in cotangents:
            g_lse = torch.zeros_like(g_lse_all) if cot == "g_lab" else g_lse_all
            g_lab = torch.zeros_like(g_lab_all) if cot == "g_lse" else g_lab_all
            args = (h, w, labels, ref_lse, g_lse, g_lab)
            dh_k, dh_p = fc.ce_dh(*args), fc.ce_dh_plain(*args)
            dh_abs, dh_rel = _abs(dh_k, dh_p), _rel(dh_k, dh_p)
            del dh_k, dh_p
            dw_k, dw_p = fc.ce_dw(*args), fc.ce_dw_plain(*args)
            dw_abs, dw_rel = _abs(dw_k, dw_p), _rel(dw_k, dw_p)
            del dw_k, dw_p
            torch.cuda.synchronize()
            say("kernel", name="ce_bwd", shape=shape, ignored=0.05, cotangents=cot,
                dh_err=f"{dh_abs:.3e}", dh_rel=f"{dh_rel:.3e}", dw_err=f"{dw_abs:.3e}",
                dw_rel=f"{dw_rel:.3e}")
            if not (dh_rel <= GG_RTOL and dw_rel <= GG_RTOL):
                raise AssertionError(f"ce_dh / ce_dw disagree with their plain versions at "
                                     f"{shape}, cotangents {cot}: dh {dh_rel}, dw {dw_rel} "
                                     f"(<= {GG_RTOL})")
            if cot != cotangents[0]:
                continue
            timed = {
                "ce_fwd": (lambda: fc.ce_fwd(h, w, labels),
                           lambda: fc.ce_fwd_plain(h, w, labels), stat_err,
                           "xtuner_tpu/ops/fused_ce.py:47"),
                "ce_dh": (lambda: fc.ce_dh(*args), lambda: fc.ce_dh_plain(*args), dh_abs,
                          "xtuner_tpu/ops/fused_ce.py:98"),
                "ce_dw": (lambda: fc.ce_dw(*args), lambda: fc.ce_dw_plain(*args), dw_abs,
                          "xtuner_tpu/ops/fused_ce.py:123"),
            }
            for name, (kern, plain, err, replaces) in timed.items():
                ms, peak = _peak_ms(torch, kern)
                pms, ppeak = _peak_ms(torch, plain)
                flops = 2 * n * v * hd * (1 if name == "ce_fwd" else 2)
                say("kernel", name=name, shape=shape, cotangents=cot, err=f"{err:.3e}",
                    ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", tflops=f"{flops / ms / 1e9:.1f}",
                    peak_gib=f"{peak:.3f}", plain_peak_gib=f"{ppeak:.3f}")
                if n == main_n:
                    ins = 2 * n * hd + 2 * v * hd + 4 * n  # h, w, labels
                    nbytes = {"ce_fwd": ins + 8 * n,  # lse, label logit out
                              "ce_dh": ins + 12 * n + 2 * n * hd,  # lse, g_lse, g_lab; dh
                              "ce_dw": ins + 12 * n + 2 * v * hd}[name]
                    rows.append({"name": name, "route": "cuda",
                                 "source": "xtuner_tpu_torch/csrc/fused_ce.cu",
                                 "replaces": replaces, "path": "sft", "max_abs_err": err,
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
    dq, rdq = (fl.flash_dq(q, k, v, seg, lse, delta, do, scale),
               fl.flash_dq_plain(q, k, v, seg, lse, delta, do, scale))
    dq_err, dq_rel = _abs(dq, rdq), _rel(dq, rdq)
    del dq, rdq
    (dk, dv), (rdk, rdv) = (fl.flash_dkv(q, k, v, seg, lse, delta, do, scale),
                            fl.flash_dkv_plain(q, k, v, seg, lse, delta, do, scale))
    dkv_err = max(_abs(dk, rdk), _abs(dv, rdv))
    dkv_rel = max(_rel(dk, rdk), _rel(dv, rdv))
    del dk, dv, rdk, rdv
    f_ms = cuda_ms(lambda: fl.flash_attention(q, k, v, seg, max_logit=bound), iters=5)
    f_plain = cuda_ms(lambda: fl.flash_attention_plain(q, k, v, seg, scale, max_free=True),
                      iters=2, warmup=1)
    dq_ms = cuda_ms(lambda: fl.flash_dq(q, k, v, seg, lse, delta, do, scale), iters=5)
    dq_plain = cuda_ms(lambda: fl.flash_dq_plain(q, k, v, seg, lse, delta, do, scale),
                       iters=2, warmup=1)
    dkv_ms = cuda_ms(lambda: fl.flash_dkv(q, k, v, seg, lse, delta, do, scale), iters=5)
    dkv_plain = cuda_ms(lambda: fl.flash_dkv_plain(q, k, v, seg, lse, delta, do, scale),
                        iters=2, warmup=1)
    shape = f"B{b}xL{l}xHq{hq}xHkv{hkv}xD{d}"
    say("kernel", name="flash_fwd_max_free", shape=shape, out_err=f"{out_err:.3e}",
        lse_err=f"{lse_err:.3e}", pad_rows_ok=pad_ok, ms=f"{f_ms:.4f}",
        plain_ms=f"{f_plain:.4f}")
    say("kernel", name="flash_dq", shape=shape, err=f"{dq_err:.3e}", rel=f"{dq_rel:.3e}",
        ms=f"{dq_ms:.4f}", plain_ms=f"{dq_plain:.4f}")
    say("kernel", name="flash_dkv", shape=shape, err=f"{dkv_err:.3e}", rel=f"{dkv_rel:.3e}",
        ms=f"{dkv_ms:.4f}", plain_ms=f"{dkv_plain:.4f}")
    pairs = causal_pairs(torch, seg)
    lib_fwd, why_fwd = sdpa_ms(torch, q, k, v, seg)
    lib_bwd, why_bwd = sdpa_ms(torch, q, k, v, seg, do)
    say("kernel", name="library", shape=shape, sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
        why=repr(f"{why_fwd}; {why_bwd}"))
    bwd_in = flash_bytes(q, k, out_like=2) + 4 * b * hq * l
    if not (out_err <= FLASH_OUT_ATOL and lse_err <= FLASH_LSE_ATOL and pad_ok
            and dq_rel <= FLASH_GRAD_RTOL and dkv_rel <= FLASH_GRAD_RTOL):
        raise AssertionError(f"flash kernels disagree at {shape}: out {out_err} "
                             f"(<= {FLASH_OUT_ATOL}), lse {lse_err} (<= {FLASH_LSE_ATOL}), "
                             f"padding rows ok {pad_ok}, dq {dq_rel}, dk/dv {dkv_rel} "
                             f"(<= {FLASH_GRAD_RTOL})")
    src = "xtuner_tpu_torch/csrc/"
    rows += [{"name": "flash_fwd_max_free", "route": "cuda", "source": src + "flash_fwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:82", "path": "sft",
              "max_abs_err": max(out_err, lse_err), "ms": f_ms, "plain_ms": f_plain,
              **least_ms(4 * pairs * hq * d, flash_bytes(q, k), PEAK_BF16), "library_ms": lib_fwd},
             {"name": "flash_dq", "route": "cuda", "source": src + "flash_bwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:199", "path": "sft",
              "max_abs_err": dq_err, "ms": dq_ms, "plain_ms": dq_plain,
              **least_ms(6 * pairs * hq * d, bwd_in + 2 * b * l * hq * d, PEAK_BF16),
              "library_ms": lib_bwd},
             {"name": "flash_dkv", "route": "cuda", "source": src + "flash_bwd.cu",
              "replaces": "xtuner_tpu/ops/attention/flash.py:303", "path": "sft",
              "max_abs_err": dkv_err, "ms": dkv_ms, "plain_ms": dkv_plain,
              **least_ms(8 * pairs * hq * d, bwd_in + 4 * b * l * hkv * d, PEAK_BF16),
              "library_ms": lib_bwd}]
    del q, k, v, do, out, lse, delta

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
    kernel's ms (the wrapper, its K-major copies included), the plain
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

    def check(name, label, got, want, ref, rtol, uses=0, timed=None, flops=0, nbytes=0):
        """Hold a kernel's result against its plain version; with `uses`,
        time it and add `uses` times its ms and bound to the kernel's row."""
        torch.cuda.synchronize()
        err, rel = _abs(got, want), _rel(got, want)
        vs_bf16 = ((got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()
        kv = {}
        if uses:
            kern, plain = timed
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
                      bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"])
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
        kt, nt = k // 128, n // 128
        check("fp8_gemm", f"{label} {tag[a_dt]}x{tag[b_dt]} M{m} K{k} N{n}", kern(), plain(),
              _mm_f32(x, w), FP8_RTOL, uses, (kern, plain), 2 * m * k * n,
              m * k + 4 * m * kt + k * n + 4 * kt * nt + 2 * m * n)
        if uses:
            # torch._scaled_mm with tile-wise scales, both outer-dim-major, as it takes them
            wt = fg.k_major(wq).view(e4)
            add_library("fp8_gemm", f"{label}: torch._scaled_mm", uses, lambda: torch._scaled_mm(
                xq, wt.t(), scale_a=sx.t().contiguous().t(), scale_b=sw.t().contiguous().t(),
                out_dtype=torch.bfloat16))
        del x, w, xq, sx, wq, sw

    # ---- #12 and #13 at the expert GEMMs: 131072 routed rows, E16, top-8
    e = 16
    m_moe = m_att * 8
    sizes = routed_sizes(torch, rng, m_att, e, 8, empty=5, dev=dev)
    say("kernel", name="fp8_grouped", rows=m_moe, experts=e, group_sizes=sizes.tolist())
    for label, m, k, n, gs, a_dt, uses in (
            # gate and up forward, down's dgrad: K1024 -> N768
            ("gate/up fwd, down dgrad", m_moe, 1024, 768, sizes, e4, 3),
            # down forward, gate's and up's dgrad: K768 -> N1024
            ("down fwd, gate/up dgrad", m_moe, 768, 1024, sizes, e4, 3),
            ("gate/up dgrad, e5m2 gradient", m_moe, 768, 1024, sizes, e5, 0),
            ("odd M700 K768", 700, 768, 256, [300, 1, 0, 333], e4, 0),
            ("odd M700 K768", 700, 768, 256, [300, 1, 0, 333], e5, 0),
            ("odd M1000 K384", 1000, 384, 128, [0, 1000, 0, 0], e4, 0)):
        gs = torch.as_tensor(gs, dtype=torch.int32, device=dev)
        ee = gs.shape[0]
        x, w, xq, sx, wq, sw = operands(m, k, n, a_dt, e4, ee)
        kern = lambda: fgr.fp8_grouped_gemm(xq, sx, wq, sw, gs)  # noqa: E731
        plain = lambda: fgr.fp8_grouped_gemm_plain(xq, sx, wq, sw, gs,  # noqa: E731
                                                   out_dtype=torch.float32)
        kt, nt = k // 128, n // 128
        got = kern()
        if (got[int(gs.sum()):] != 0).any():
            raise AssertionError("fp8_grouped_gemm wrote rows past the last group")
        check("fp8_grouped_gemm", f"{label} {tag[a_dt]}xe4m3 M{m} K{k} N{n}", got, plain(),
              grouped_gemm_plain(x, w, gs, out_dtype=torch.float32), FP8_RTOL, uses,
              (kern, plain), 2 * int(gs.sum()) * k * n,
              m * k + 4 * m * kt + ee * k * n + 4 * ee * kt * nt + 2 * m * n)
        if uses:
            wt = fg.k_major(wq).view(e4)
            offs = torch.cumsum(gs, 0).to(torch.int32)
            add_library("fp8_grouped_gemm", f"{label}: torch._scaled_grouped_mm", uses,
                        lambda: torch._scaled_grouped_mm(xq, wt.transpose(1, 2), sx, sw,
                                                         offs=offs, out_dtype=torch.bfloat16))
        del x, w, xq, sx, wq, sw, got

    for label, m, k, n, gs, y_dt, uses in (
            ("gate/up wgrad", m_moe, 1024, 768, sizes, e4, 2),
            ("down wgrad", m_moe, 768, 1024, sizes, e4, 1),
            ("down wgrad, e5m2 gradient", m_moe, 768, 1024, sizes, e5, 0),
            ("odd M640 K768", 640, 768, 256, [300, 1, 0, 339], e5, 0),
            ("odd M1024 K384", 1024, 384, 128, [0, 0, 1000, 0], e4, 0)):
        gs = torch.as_tensor(gs, dtype=torch.int32, device=dev)
        ee = gs.shape[0]
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        dy = torch.randn((m, n), generator=g, device=dev).bfloat16()
        xq, sx = fgr.quantize_rowtile(x)
        yq, sy = fgr.quantize_rowtile(dy, dtype=y_dt)
        kern = lambda: fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, ee)  # noqa: E731
        plain = lambda: fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, gs, ee)  # noqa: E731
        got = kern()
        if any((got[i] != 0).any() for i in range(ee) if int(gs[i]) == 0):
            raise AssertionError("fp8_grouped_gemm_dw wrote an empty expert's dW")
        check("fp8_grouped_dw", f"{label} e4m3x{tag[y_dt]} M{m} K{k} N{n}", got, plain(),
              grouped_gemm_dw_plain(x, dy, gs, ee), FP8_DW_RTOL, uses, (kern, plain),
              2 * int(gs.sum()) * k * n, m * (k + n) + 8 * (m // 128) + 4 * ee * k * n)
        del x, dy, xq, sx, yq, sy, got
    say("kernel", name="fp8_grouped_dw",
        library=repr("none: no PyTorch call takes one fp8 scale per 128-row tile of a ragged "
                     "contraction"))
    rows["fp8_grouped_dw"]["library_ms"] = None
    return list(rows.values())


def release(torch, phase: str) -> None:
    """Free what a phase left behind, so that the next phase's peak memory
    is its own: collect reference cycles (the serving phase's engine holds
    its own timed methods), return cached blocks, and fail if more than
    RELEASED_GIB stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    say("memory", after=phase, allocated_gib=f"{left:.3f}")
    if left > RELEASED_GIB:
        raise AssertionError(f"{left:.3f} GiB still allocated after the {phase} phase")


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


def phase_engine(torch, seed: int, smi: str) -> dict:
    import numpy as np

    from xtuner_tpu_torch.model.generate import GenerateConfig, _forward_cached, init_cache
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
    def teacher_forced(prompt, toks, extra_pad):
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

    diffs, floor = [], []
    for req, o in zip(reqs, outs):
        tf = teacher_forced(req["prompt_ids"], o["token_ids"], 0)
        diffs.append((tf - torch.tensor(o["logprobs"])).abs())
        floor.append((tf - teacher_forced(req["prompt_ids"], o["token_ids"], 64)).abs())
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


def reset_train_launches() -> None:
    from xtuner_tpu_torch.ops import bf16_grouped, fp8_gemm, fp8_grouped, fused_ce
    from xtuner_tpu_torch.ops.attention import flash

    for mod in (flash, bf16_grouped, fused_ce, fp8_gemm, fp8_grouped):
        mod.reset_launches()


def train_launches(torch) -> dict:
    """Every training kernel's launches since `reset_train_launches`."""
    from xtuner_tpu_torch.ops import fused_ce as fc
    from xtuner_tpu_torch.ops.attention import flash as fl
    from xtuner_tpu_torch.ops.bf16_grouped import grouped_gemm_bf16, grouped_gemm_bf16_dw
    from xtuner_tpu_torch.ops.fp8_gemm import fp8_gemm_tilewise
    from xtuner_tpu_torch.ops.fp8_grouped import fp8_grouped_gemm, fp8_grouped_gemm_dw

    return {"flash_fwd": fl.flash_attention.launches - fl.max_free_launches(),
            "flash_fwd_max_free": fl.max_free_launches(),
            "flash_dq": fl.flash_dq.launches, "flash_dkv": fl.flash_dkv.launches,
            "grouped_gemm_nn": grouped_gemm_bf16.launches["nn"],
            "grouped_gemm_nt": grouped_gemm_bf16.launches["nt"],
            "grouped_gemm_dw": grouped_gemm_bf16_dw.launches,
            "ce_fwd": fc.ce_fwd.launches, "ce_dh": fc.ce_dh.launches, "ce_dw": fc.ce_dw.launches,
            "fp8_gemm": fp8_gemm_tilewise.launches, "fp8_grouped_gemm": fp8_grouped_gemm.launches,
            "fp8_grouped_dw": fp8_grouped_gemm_dw.launches}


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
    want = {"flash_fwd": 0, "flash_fwd_max_free": 2 * per, "flash_dq": per, "flash_dkv": per,
            "grouped_gemm_nn": 4 * per, "grouped_gemm_nt": 2 * per,
            "grouped_gemm_dw": 2 * per, "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0,
            "fp8_gemm": 0, "fp8_grouped_gemm": 0, "fp8_grouped_dw": 0}
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


def phase_sft(torch, smi: str, breakdown: bool, fp8_ref_loss1=None) -> tuple[dict, list]:
    """The port's SFT entry point as a user runs it: the `sft` CLI's
    `main(["--config", <recipe>])` in a temporary working directory, 6
    steps at full width and depth. Reads its tracker and its final
    checkpoint, and counts every kernel launch of the run. With
    `fp8_ref_loss1` (the bf16 run's step-1 loss) it runs the fp8 recipe and
    holds its step-1 loss within SFT_FP8_LOSS1_RTOL of that. Returns the
    launches and the losses."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np

    from xtuner_tpu_torch.checkpoint.torch_io import TrainCheckpointManager
    from xtuner_tpu_torch.train.cli import sft

    fp8 = fp8_ref_loss1 is not None
    phase, rel_recipe = ("sft_fp8", SFT_FP8_RECIPE) if fp8 else ("sft", SFT_RECIPE)
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
            wall_s=f"{wall:.3f}")
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
        # forward, recompute and dgrad (9 of #12), their wgrads (3 of #13)
        want = {"flash_fwd": 0, "flash_fwd_max_free": per, "flash_dq": per, "flash_dkv": per,
                "grouped_gemm_nn": 0 if fp8 else 4 * per, "grouped_gemm_nt": 0 if fp8 else 2 * per,
                "grouped_gemm_dw": 0 if fp8 else 2 * per, "ce_fwd": SFT_STEPS,
                "ce_dh": SFT_STEPS, "ce_dw": SFT_STEPS, "fp8_gemm": 8 * per if fp8 else 0,
                "fp8_grouped_gemm": 9 * per if fp8 else 0,
                "fp8_grouped_dw": 3 * per if fp8 else 0}
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
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall over {SFT_STEPS} steps: {losses}")
        if any(r["skipped"] for r in recs):
            raise AssertionError("a step was skipped")
        if not committed:
            raise AssertionError(f"no committed checkpoint at {step_dir}")
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != what 6 steps imply {want}")

        batch = next(iter(trainer.dataloader))
        with quantise_annotated(torch, fp8):
            profile_window(torch, f"{phase}_step",
                           lambda: trainer.engine.train_step(batch, SFT_STEPS + 1), top=16,
                           annotation=QUANTISE if fp8 else None)
        if breakdown and not fp8:
            sft_memory(torch, trainer.engine, batch, smi)
        trainer.dataloader.close()
    return launches, losses


QUANTISE = "fp8_quantise"


class quantise_annotated:
    """While on (and `on`), every fp8 quantiser and K-major copy of the port
    runs inside `torch.profiler.record_function(QUANTISE)`, so that a
    profile can sum the device time of the quantise passes. The module
    attributes are swapped back on exit."""

    NAMES = {"fp8_gemm": ("quantize_tilewise", "quantize_blockwise", "k_major"),
             "fp8_grouped": ("quantize_tilewise", "quantize_blockwise_stack",
                             "quantize_rowtile", "k_major"),
             "float8": ("quantize_tilewise", "quantize_blockwise")}

    def __init__(self, torch, on: bool):
        self.torch, self.on, self.saved = torch, on, []

    def __enter__(self):
        if not self.on:
            return self
        import importlib

        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(f"xtuner_tpu_torch.ops.{mod_name}")
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        record_function = self.torch.profiler.record_function

        def annotated(*a, **kw):
            with record_function(QUANTISE):
                return fn(*a, **kw)
        return annotated

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
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


def profile_window(torch, name: str, fn, top: int = 8, annotation=None) -> None:
    """Wall time, device-busy time (sum of kernel durations), kernel count,
    device time by kind (the port's fp8 kernels and its others, cuBLAS
    GEMMs, the rest) and the top kernels by device time of one call under
    torch.profiler. With `annotation`, the device time of the kernels
    launched inside `record_function(annotation)` ranges is its own kind,
    taken out of the rest."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = defaultdict(lambda: [0.0, 0])
    annotated_ms, ranges = 0.0, 0
    for e in prof.events():
        if e.name == annotation:
            if e.device_type != DeviceType.CUDA:  # the CPU range: its kernels' time
                annotated_ms += e.device_time_total / 1e3
                ranges += 1
            continue  # the range's own device-side span is not a kernel
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    kinds: dict = defaultdict(float)
    for k, (ms, _) in by_name.items():
        if "(anonymous namespace)::fp8_" in k:
            kinds["port_fp8_kernels"] += ms
        elif "(anonymous namespace)::" in k:
            kinds["port_kernels"] += ms
        elif k.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in k.lower():
            kinds["cublas"] += ms
        else:
            kinds["other"] += ms
    if annotation:
        kinds[annotation] = annotated_ms  # elementwise kernels: counted in other so far
        kinds["other"] -= annotated_ms
    say("profile", window=name, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
        busy_share=f"{busy_ms / wall_ms:.3f}",
        kernels=sum(v[1] for v in by_name.values()),
        **{f"{k}_ms": f"{v:.3f}" for k, v in sorted(kinds.items())})
    for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<6d} {k[:100]}", flush=True)


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
    launches = {"serve": phase_engine(torch, args.seed, smi)}
    release(torch, "serve")
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
