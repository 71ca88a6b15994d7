"""Time the port's tile-wise fp8 GEMM kernels (#12, forward and dgrad;
#13, the wgrad; #11, the attention projections' dense GEMM, on #12's
kernel) on the card at the sft_fp8 path's shapes.

    python tools/bench_fp8_grouped_cuda.py [--tag NAME] [--iters N] [--kernels 11,12,13]

The shapes are one moe_heavy MoE layer's (recipes/sft_moe_heavy_fp8.py):
131072 routed rows (2 x 8192 tokens, top-8) over 16 experts, group sizes
from a seeded top-8 routing with expert 5 empty, as chip_smoke.py makes
them; #12 at K1024 N768 (gate and up forward, down's dgrad) and K768 N1024
(down forward, gate's and up's dgrad), with an e4m3 and an e5m2 A (the
dgrad's gradient under `e5m2_grads`); #13 at both shapes, e4m3 x e4m3 and
e4m3 x e5m2; #11 at the q, k, v and o projections (M = 16384, K x N 1024 x
2048, 1024 x 1024 twice, 2048 x 1024), an e5m2 dgrad and an e5m2 wgrad
(K = 16384). Each row prints the CUDA-event ms of the launch alone on
operands already in the kernel's layout and of the wrapper (its K-major or
row-tile copies included) and of those copies alone, TFLOP/s, the share of
the bound (operations at 1,979 TFLOP/s or bytes at 3.35 TB/s, the
larger), the card's name and power limit, and the wrapper's error against
the plain version (#12 with f32 out, so that no bf16 rounding hides the
accumulation's: the largest absolute error, and that over the largest
entry). It imports `xtuner_tpu_torch`
from the working directory, so running it from a second checkout times
that checkout's kernels (a checkout without the launch functions prints
the wrapper and the copies: its kernel's time is the difference). One
JSON line per row.
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

PEAK_FP8 = 1979e12
HBM_BYTES_S = 3.35e12
TOKENS, EXPERTS, TOPK = 2 * 8192, 16, 8
SHAPES = [(1024, 768), (768, 1024)]  # (K, N)


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


def routed_sizes(seed: int, dev) -> torch.Tensor:
    """(E,) int32 group sizes of a top-8 routing of random router logits,
    expert 5 given no token."""
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.standard_normal((TOKENS, EXPERTS)), dtype=torch.float32)
    logits[:, 5] = float("-inf")
    idx = logits.topk(TOPK, dim=-1).indices.flatten()
    return torch.bincount(idx, minlength=EXPERTS).to(torch.int32).to(dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", default="11,12,13")
    args = ap.parse_args()
    kernels = {f"#{k}" for k in args.kernels.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from xtuner_tpu_torch.ops import fp8_gemm as fg
    from xtuner_tpu_torch.ops import fp8_grouped as fgr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    sizes = routed_sizes(4, dev)
    m, used, e = TOKENS * TOPK, int(sizes.sum()), EXPERTS
    g = torch.Generator(device=dev).manual_seed(0)
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    tag = {e4: "e4m3", e5: "e5m2"}
    has_launch = hasattr(fgr, "fp8_grouped_gemm_launch")

    def emit(kernel, k, n, types, flops, nbytes, fns, got, want, rows=m, experts=e):
        bound = max(flops / PEAK_FP8, nbytes / HBM_BYTES_S) * 1e3
        row = {"tag": args.tag, "kernel": kernel, "experts": experts, "m": rows, "k": k, "n": n,
               "types": types, "bound_ms": bound,
               "bound_by": "operations" if flops / PEAK_FP8 >= nbytes / HBM_BYTES_S else "bytes"}
        ref = want()
        err = (got().float() - ref).abs().max().item()
        row.update(max_abs_err=err, rel_err=err / ref.abs().max().item())
        del ref
        for what, fn in fns.items():
            ms = cuda_ms(fn, args.iters) if fn is not None else None
            row[f"{what}_ms"] = ms
            if what != "layout":
                row[f"{what}_tflops"] = flops / ms / 1e9 if ms else None
                row[f"{what}_share_of_bound"] = bound / ms if ms else None
        row["card"] = smi
        print(json.dumps(row), flush=True)

    for label, mm, k, n, a_dt, b_dt in (
            ("q", TOKENS, 1024, 2048, e4, e4), ("k", TOKENS, 1024, 1024, e4, e4),
            ("v", TOKENS, 1024, 1024, e4, e4), ("o", TOKENS, 2048, 1024, e4, e4),
            ("q dgrad", TOKENS, 2048, 1024, e5, e4), ("q wgrad", 1024, TOKENS, 2048, e4, e5)):
        if "#11" not in kernels:
            break
        kt, nt = k // 128, n // 128
        xq, sx = fg.quantize_tilewise(torch.randn((mm, k), generator=g, device=dev), dtype=a_dt)
        wq, sw = fg.quantize_blockwise(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                       dtype=b_dt)
        wt = fg.k_major(wq).view(wq.dtype)
        fns = {"alone": (lambda: fg.fp8_gemm_launch(xq, sx, wt, sw))
               if hasattr(fg, "fp8_gemm_launch") else None,
               "wrapper": lambda: fg.fp8_gemm_tilewise(xq, sx, wq, sw),
               "layout": lambda: fg.k_major(wq)}
        emit(f"#11 {label}", k, n, f"{tag[a_dt]}x{tag[b_dt]}", 2 * mm * k * n,
             mm * k + 4 * mm * kt + k * n + 4 * kt * nt + 2 * mm * n, fns,
             lambda: fg.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=torch.float32),
             lambda: fg.fp8_gemm_tilewise_plain(xq, sx, wq, sw, out_dtype=torch.float32),
             rows=mm, experts=1)
        del xq, sx, wq, sw, wt
    for k, n in SHAPES:
        if not kernels & {"#12", "#13"}:
            break
        kt, nt = k // 128, n // 128
        w = torch.randn((e, k, n), generator=g, device=dev) * 0.02
        wq, sw = fgr.quantize_blockwise_stack(w)
        wt = fg.k_major(wq).view(wq.dtype)
        for a_dt in (e4, e5):
            xq, sx = fg.quantize_tilewise(torch.randn((m, k), generator=g, device=dev),
                                          dtype=a_dt)
            fns = {"alone": (lambda: fgr.fp8_grouped_gemm_launch(xq, sx, wt, sw, sizes))
                   if has_launch else None,
                   "wrapper": lambda: fgr.fp8_grouped_gemm(xq, sx, wq, sw, sizes),
                   "layout": lambda: fg.k_major(wq)}
            emit("#12", k, n, f"{tag[a_dt]}xe4m3", 2 * used * k * n,
                 m * k + 4 * m * kt + e * k * n + 4 * e * kt * nt + 2 * m * n, fns,
                 lambda: fgr.fp8_grouped_gemm(xq, sx, wq, sw, sizes, out_dtype=torch.float32),
                 lambda: fgr.fp8_grouped_gemm_plain(xq, sx, wq, sw, sizes,
                                                    out_dtype=torch.float32))
            del xq, sx
        del w, wq, sw, wt
        x = torch.randn((m, k), generator=g, device=dev)
        xq, sx = fgr.quantize_rowtile(x)
        xt = fgr._row_tiles_k_major(xq, 128)
        for y_dt in (e4, e5):
            yq, sy = fgr.quantize_rowtile(torch.randn((m, n), generator=g, device=dev),
                                          dtype=y_dt)
            yt = fgr._row_tiles_k_major(yq, 128)
            fns = {"alone": (lambda: fgr.fp8_grouped_dw_launch(xt, sx, yt, sy, sizes, e))
                   if has_launch else None,
                   "wrapper": lambda: fgr.fp8_grouped_gemm_dw(xq, sx, yq, sy, sizes, e),
                   "layout": lambda: (fgr._row_tiles_k_major(xq, 128),
                                      fgr._row_tiles_k_major(yq, 128))}
            emit("#13", k, n, f"e4m3x{tag[y_dt]}", 2 * used * k * n,
                 m * (k + n) + 8 * (m // 128) + 4 * e * k * n, fns, fns["wrapper"],
                 lambda: fgr.fp8_grouped_gemm_dw_plain(xq, sx, yq, sy, sizes, e))
            del yq, sy, yt
        del x, xq, sx, xt


if __name__ == "__main__":
    main()
