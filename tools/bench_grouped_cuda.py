"""Time the port's bf16 grouped GEMM kernels (#6 "nn"/"nt", #7 "dw") on the
card at the shapes each path gives them, beside `torch._grouped_mm`.

    python tools/bench_grouped_cuda.py [--tag NAME] [--iters N] [--shapes a,b]

Shapes: one MoE layer's gate|up and down GEMMs at the Qwen3-30B-A3B train
step (E128, M65536), moe_heavy SFT (E16, M131072) and bench.py's longctx
row (E64, M262144: only nt and dw run there, in #16's backward). Group
sizes are a seeded Dirichlet draw, as chip_smoke.py makes them. Each row
prints CUDA-event ms, TFLOP/s, the share of the bound (FLOPs at 989 TFLOP/s
or bytes at 3.35 TB/s, the larger) and `torch._grouped_mm`'s ms (bf16 out
for dw, where the kernel writes f32). It imports `xtuner_tpu_torch` from
the working directory, so running it from a second checkout times that
checkout's kernels: run parent, change, change, parent in one call to
compare two commits on one card. One JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12
# (path, experts, rows, [(gemm, K, N, kinds)])
SHAPES = {
    "train": (128, 65536, [("gate|up", 2048, 1536, "nn nt dw"), ("down", 768, 2048, "nn nt dw")]),
    "sft": (16, 131072, [("gate|up", 1024, 1536, "nn nt dw"), ("down", 768, 1024, "nn nt dw")]),
    "longctx": (64, 262144, [("gate|up", 1024, 256, "nt dw"), ("down", 128, 1024, "nt dw")]),
}


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from xtuner_tpu_torch.ops.bf16_grouped import grouped_gemm_bf16, grouped_gemm_bf16_dw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    for path in args.shapes.split(","):
        e, m, gemms = SHAPES[path]
        rng = np.random.default_rng(0)
        sizes = torch.tensor(rng.multinomial(m, rng.dirichlet(np.full(e, 2.0))),
                             dtype=torch.int32, device=dev)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        g = torch.Generator(device=dev).manual_seed(0)
        for which, k, n, kinds in gemms:
            x = torch.randn((m, k), generator=g, device=dev).bfloat16()
            dy = torch.randn((m, n), generator=g, device=dev).bfloat16()
            w = (torch.randn((e, k, n), generator=g, device=dev) * 0.02).bfloat16()
            flops = 2 * m * k * n
            for kind in kinds.split():
                if kind == "nn":
                    fn = lambda: grouped_gemm_bf16(x, w, sizes)  # noqa: E731
                    lib = lambda: torch._grouped_mm(x, w, offs=offs)  # noqa: E731
                    nbytes = 2 * (m * k + e * k * n + m * n)
                elif kind == "nt":
                    fn = lambda: grouped_gemm_bf16(dy, w, sizes, transpose_rhs=True)  # noqa: E731
                    lib = lambda: torch._grouped_mm(dy, w.transpose(1, 2), offs=offs)  # noqa: E731
                    nbytes = 2 * (m * n + e * k * n + m * k)
                else:
                    fn = lambda: grouped_gemm_bf16_dw(x, dy, sizes, e)  # noqa: E731
                    lib = lambda: torch._grouped_mm(x.t(), dy, offs=offs)  # noqa: E731
                    nbytes = 2 * (m * k + m * n) + 4 * e * k * n
                ms = cuda_ms(fn, args.iters)
                try:
                    lib_ms = cuda_ms(lib, args.iters)
                except RuntimeError as err:
                    lib_ms = f"refused: {str(err).splitlines()[0][:100]}"
                bound = max(flops / PEAK_BF16, nbytes / HBM_BYTES_S) * 1e3
                print(json.dumps({"tag": args.tag, "path": path, "gemm": which, "kind": kind,
                                  "experts": e, "m": m, "k": k, "n": n, "ms": ms,
                                  "tflops": flops / ms / 1e9, "bound_ms": bound,
                                  "share_of_bound": bound / ms, "grouped_mm_ms": lib_ms,
                                  "card": smi}), flush=True)
            del x, dy, w


if __name__ == "__main__":
    main()
