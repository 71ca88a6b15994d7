"""Time the port's serving decode loop on the card, run after run.

    python tools/bench_serve_decode.py [--tag NAME] [--reps N] [--profile-after K]

Runs `chip_smoke.py`'s serving phase: Qwen3-8B at full size with seeded
random weights, `PagedGenerator` with 4 slots and blocks of 128, 6 greedy
requests of up to 32 new tokens (5 prompts of 1-1000 tokens and a GRPO
sibling), after one warm-up request. Each of `--reps` runs prints one JSON
line: the decode step's ms (host clock, each step ending in a device
synchronize, as `chip_smoke.py` times it), the prefill seconds, the paged
decode calls and the host's time to enqueue one of them (inside the real
loop, no synchronisation), and the card's name and power limit. With
`--profile-after K`, after run K it profiles 20 calls of the paged decode
at the serving shape with `chip_smoke.kernel_device_ms` (a `torch.profiler`
window, as `chip_smoke.py`'s kernel phase does before its serving phase),
so the runs after it show what an earlier profiler window costs the loop.

It imports `xtuner_tpu_torch` from the working directory, so running it
from a second checkout times that checkout's port; `chip_smoke` always
comes from the repo that holds this file.
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


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Timed:
    """Host clock around each call, ending in a device synchronize."""

    def __init__(self, fn, sync: bool):
        self.fn, self.sync, self.seconds, self.calls = fn, sync, 0.0, 0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        if self.sync:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile-after", type=int, default=0,
                    help="profile the paged decode after this run (0: never)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from xtuner_tpu_torch.model import paged_generate
    from xtuner_tpu_torch.model.generate import GenerateConfig
    from xtuner_tpu_torch.model.registry import get_model_config
    from xtuner_tpu_torch.module.params import init_params
    from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn

    smoke = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_model_config("qwen3-8b")
    model = cfg.build()
    params = init_params(model.param_specs(), torch.Generator(device=dev).manual_seed(args.seed),
                         dev, torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    lens = [1000, 1, *rng.integers(2, 1000, size=3).tolist()]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    reqs = [{"prompt_ids": prompts[0], "group": "g0"}, {"prompt_ids": prompts[0], "group": "g0"},
            *[{"prompt_ids": p} for p in prompts[1:]]]
    greedy = GenerateConfig(max_length=2048, max_new_tokens=smoke.MAX_NEW, do_sample=False,
                            prefill_chunk=0, prefix_cache=False)
    eng = paged_generate.PagedGenerator(model, params, greedy, max_batch=4, block_size=128)
    eng.generate([{"prompt_ids": prompts[1], "max_new_tokens": 2}])  # warm-up
    enqueue = paged_generate.paged_decode_attn = _Timed(paged_decode_attn, sync=False)
    prefill, decode_step = eng._prefill, eng._decode_step

    for rep in range(1, args.reps + 1):
        eng._prefill, eng._decode_step = _Timed(prefill, True), _Timed(decode_step, True)
        enqueue.seconds = enqueue.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({
            "tag": args.tag, "run": rep, "after_profiler": 0 < args.profile_after < rep,
            "decode_steps": eng._decode_step.calls,
            "decode_ms_per_step": 1e3 * eng._decode_step.seconds / eng._decode_step.calls,
            "prefill_s": eng._prefill.seconds, "wall_s": wall,
            "paged_decode_calls": enqueue.calls,
            "paged_decode_enqueue_us": 1e6 * enqueue.seconds / max(enqueue.calls, 1),
            "card": smi}), flush=True)
        if rep == args.profile_after:
            g = torch.Generator(device=dev).manual_seed(args.seed)
            pk = torch.randn((2, 40, 128, 8, 128), generator=g, device=dev).bfloat16()
            q = torch.randn((4, 1, 32, 128), generator=g, device=dev).bfloat16()
            table = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16) % 40
            seq_lens = torch.tensor([1000, 0, 517, 1900], dtype=torch.int32, device=dev)
            ms = smoke.kernel_device_ms(torch, lambda: paged_decode_attn(
                q, pk, pk, 1, table, seq_lens, scale=128 ** -0.5), "paged_decode_kernel")
            print(json.dumps({"tag": args.tag, "profiled_paged_decode_ms": ms}), flush=True)
            del pk, q


if __name__ == "__main__":
    main()
