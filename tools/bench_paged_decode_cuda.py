"""Time the port's paged decode kernel (#5) on the card.

    python tools/bench_paged_decode_cuda.py [--tag NAME] [--iters N]

Shapes: Qwen3-8B's attention (Hq 32, Hkv 8, D 128), one query token per
slot, blocks of 128, a 2-layer pool holding just the slots' blocks:
chip_smoke.py's serving shape (4 slots of 1000/0/517/1900 cached tokens,
a 16-entry table), rollouts of 8, 32 and 64 slots at 1024, 4096 and
8192 cached tokens each (64-entry tables, 128 at 8192) and one of 32
slots of 256-8192 cached tokens (a seeded draw). Each row prints
the ms of the kernel alone (its device time under torch.profiler, mean
over the launches) and of the wrapper (CUDA events over back-to-back
calls: host-bound where the kernel is short) and the host's time to
enqueue one call (the wrapper's cost to a host-bound decode loop; no
synchronisation inside the timed calls), the bytes bound (K and V
read once at 3.35 TB/s) and the kernel's share of it, and the card's name
and power limit. It imports `xtuner_tpu_torch` from the working
directory, so running it from a second checkout times that checkout's
kernel. One JSON line per row.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

HBM_BYTES_S = 3.35e12
HQ, HKV, D, BS = 32, 8, 128, 128
SHAPES = [("serve", [1000, 0, 517, 1900], 16)] + [
    (f"rollout B{b} x {n}", [n] * b, 128 if n > 4096 else 64)
    for n in (1024, 4096, 8192) for b in (8, 32, 64)] + [
    # 32 slots of 256-8192 cached tokens (a seeded draw): uneven splits
    ("rollout B32 mixed", [int(n) for n in np.random.default_rng(1).integers(256, 8193, 32)],
     128)]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def _chip_smoke():
    """`chip_smoke.py` of the repo that holds this file (its
    `kernel_device_ms` is the one yardstick of a kernel's device time)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from xtuner_tpu_torch.ops.attention.paged_decode import (paged_decode_attn,
                                                             paged_decode_attn_plain)

    smoke = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for label, lens, mb in SHAPES:
        need = [-(-(n + 1) // BS) if n else 0 for n in lens]
        nb = 1 + sum(need)
        pk = torch.randn((2, nb, BS, HKV, D), generator=g, device=dev).bfloat16()
        pv = torch.randn((2, nb, BS, HKV, D), generator=g, device=dev).bfloat16()
        q = torch.randn((len(lens), 1, HQ, D), generator=g, device=dev).bfloat16()
        table = torch.zeros((len(lens), mb), dtype=torch.int32)
        nxt = 1
        for bi, k in enumerate(need):
            table[bi, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
            nxt += k
        table = table.to(dev)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)

        def kern():
            return paged_decode_attn(q, pk, pv, 1, table, seq_lens, scale=D ** -0.5)

        err = None
        if len(lens) <= 32:  # the plain version gathers every table entry in f32
            ref = paged_decode_attn_plain(q, pk, pv, 1, table, seq_lens, scale=D ** -0.5)
            err = (kern() - ref).abs().max().item()
            del ref
        nbytes = 4 * sum(n + 1 for n in lens if n) * HKV * D + len(lens) * HQ * D * 6
        bound = nbytes / HBM_BYTES_S * 1e3
        alone = smoke.kernel_device_ms(torch, kern, "paged_decode_kernel", args.iters)
        wrapper = cuda_ms(kern, args.iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            kern()
        host = (time.perf_counter() - t0) * 1e3 / args.iters  # enqueue only: no sync inside
        torch.cuda.synchronize()
        print(json.dumps({"tag": args.tag, "shape": label, "slots": len(lens), "mb": mb,
                          "kv_mb": nbytes / 1e6, "bound_ms": bound, "kernel_ms": alone,
                          "kernel_share_of_bound": bound / alone, "wrapper_ms": wrapper,
                          "host_ms": host, "max_abs_err": err, "card": smi}), flush=True)
        del pk, pv, q


if __name__ == "__main__":
    main()
