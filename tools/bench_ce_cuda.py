"""Time the port's fused-CE backward (TPU kernels #9 dh and #10 dW) on the
card at the paths' shapes: N16384 (moe_heavy's SFT step, 2 rows of 8192)
and N65536 (bench.py's longctx row), H1024, V151936 (Qwen's vocab).

    python tools/bench_ce_cuda.py [--tag NAME] [--iters N] [--shapes 16384,65536]

Per shape one JSON line: CUDA-event ms of the backward as
`_FusedCE.backward` runs it (dh and dW from one call), of `ce_dh` and of
`ce_dw` alone, its peak memory above what was allocated before the call,
and its share of the bound (three products of 2 N V H FLOPs at 989
TFLOP/s). Where the checkout's backward is the chunked one
(`ce_bwd_pass_ms`), also each pass's device ms (the coefficient sweep,
the dh and the dW products, the bf16 rounding of dW) and, as the yardstick
of a tuned GEMM, `torch.mm(..., out_dtype=float32)` over the same N x V x
H product as the dh products (c chunk times w). Inputs as chip_smoke.py
makes them: unit-normal h, w of std 0.02, 5% ignored rows with zero
cotangents. It imports `xtuner_tpu_torch` from the working directory, so
running it from a second checkout times that checkout's kernels: run
parent, change, change, parent in one call to compare two commits on one
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import torch

sys.path.insert(0, os.getcwd())

PEAK_BF16 = 989e12
V, H = 151936, 1024


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
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


def peak_gib(fn) -> float:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--shapes", default="16384,65536")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_ce_cuda: no CUDA device")
    from xtuner_tpu_torch.ops import fused_ce as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    for n in (int(x) for x in args.shapes.split(",")):
        g = torch.Generator(device=dev).manual_seed(n)
        h = torch.randn((n, H), generator=g, device=dev).bfloat16()
        w = (torch.randn((V, H), generator=g, device=dev) * 0.02).bfloat16()
        keep = torch.rand((n,), generator=g, device=dev) >= 0.05
        labels = torch.where(keep, torch.randint(0, V, (n,), generator=g, device=dev,
                                                 dtype=torch.int32), 0).to(torch.int32)
        g_lse = torch.where(keep, torch.rand((n,), generator=g, device=dev), 0.0).contiguous()
        g_lab = torch.where(keep, -torch.rand((n,), generator=g, device=dev), 0.0).contiguous()
        lse = fc.ce_fwd(h, w, labels)[0]
        ctx = SimpleNamespace(saved_tensors=(h, w, labels, lse), needs_input_grad=(True, True))
        args6 = (h, w, labels, lse, g_lse, g_lab)
        bwd = lambda: fc._FusedCE.backward(ctx, g_lse, g_lab)  # noqa: E731
        row = {"tag": args.tag, "shape": f"N{n}xH{H}xV{V}", "card": smi,
               "bwd_peak_gib": peak_gib(bwd), "bwd_ms": cuda_ms(bwd, args.iters),
               "dh_ms": cuda_ms(lambda: fc.ce_dh(*args6), args.iters),
               "dw_ms": cuda_ms(lambda: fc.ce_dw(*args6), args.iters),
               "bound_ms": 3 * 2 * n * V * H / PEAK_BF16 * 1e3}
        row["share_of_bound"] = row["bound_ms"] / row["bwd_ms"]
        if hasattr(fc, "ce_bwd_pass_ms"):
            marks: list = []
            for _ in range(args.iters):
                fc.ce_bwd(*args6, marks=marks)
            row.update({f"pass_{k}_ms": t / args.iters
                        for k, t in fc.ce_bwd_pass_ms(marks).items()})
            plan = fc.ce_chunk_plan(n, V)
            c = torch.randn((plan.rows, V), generator=g, device=dev).bfloat16()
            mm = lambda: [torch.mm(c[:r], w, out_dtype=torch.float32)  # noqa: E731
                          for _, r in plan.chunks]
            row.update(chunks=len(plan.chunks), c_scratch_bytes=plan.scratch_bytes,
                       mm_ms=cuda_ms(mm, args.iters))
            del c
        print(json.dumps(row), flush=True)
        del h, w, labels, g_lse, g_lab, lse, ctx, args6
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
