"""Time the block-sparse kernels #14 (`block_sparse_fwd`) and #15
(`block_sparse_bwd`) alone on one card at GLM-5.2's attention shapes (B1,
L16384, 64 heads, D = Dv = 256, blocks of 256, 8 slots), at two
selections:

- synthetic: `chip_smoke.py`'s dsa_kernels inputs (five documents and a
  padded tail; the selection from random block maxima through
  `select_from_blockmax`, minus the blocks no query of the q-block can
  see), same seed, same tensors;
- recipe: the first row of `recipes/sft_glm52_dsa_head.py`'s data (the
  alpaca demo packed to 16384 with the byte tokenizer), where every
  q-block's selection is its visible blocks (1-2: the indexer's block
  maxima are -inf elsewhere, so its top 8 keeps exactly those).

    python tools/bench_block_sparse_cuda.py [--iters N]

Per selection and kernel: CUDA-event ms of the wrapper, the plain
version's ms, the error against it (largest entry of out/lse/mass; the
gradients relative to their largest entry), whether two launches give the
same bits, the visible pairs and the least time (`chip_smoke.least_ms`);
the backward also with the plain-torch `rowsum(do * out)` timed alone;
and the device ms by kernel of one forward and one backward launch
(`torch.profiler`).
Run it from the root of a second checkout (a `git archive` of another
commit in a git-ignored directory) to time that checkout's kernels in the
same call. Last lines: the card's name and power limit, and a JSON object
of the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys

sys.path.insert(0, os.getcwd())  # the checkout whose kernels are timed

SEQ, HEADS, DIM, BLOCK, SLOTS = 16384, 64, 256, 256, 8
RECIPE = "xtuner_tpu_torch/recipes/sft_glm52_dsa_head.py"


def synthetic(torch, cs, bs, seed: int):
    """chip_smoke.py's dsa_kernels inputs, drawn in the same order."""
    import numpy as np

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    rng = np.random.default_rng(seed + 5)
    lens = cs.doc_lengths(rng, SEQ, 5, int(rng.integers(200, 600)))
    seg = cs._segments(torch, lens, SEQ, dev)
    nb = SEQ // BLOCK
    blockmax = torch.randn((1, nb, nb), generator=g, device=dev)
    blockmax = torch.where(cs.block_visible(torch, seg, BLOCK), blockmax, float("-inf"))
    idx = bs.select_from_blockmax(blockmax, SLOTS)
    q, k, v, do = (torch.randn((1, SEQ, HEADS, DIM), generator=g, device=dev).bfloat16()
                   for _ in range(4))
    return q, k, v, do, seg, idx


def recipe(torch, cs, bs, seed: int):
    """The recipe's first packed row; each q-block selects its visible
    blocks (ascending, -1 first)."""
    import numpy as np

    from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer

    dev = torch.device("cuda")
    tcfg = runpy.run_path(RECIPE)["trainer"]
    tcfg.dataloader_cfg.pad_token_id = 0
    batch = next(iter(tcfg.dataloader_cfg.build(UTF8ByteTokenizer(), 1, 1)))
    seg = torch.as_tensor(np.asarray(batch["segment_ids"][0])).to(dev, torch.int32)
    nb = SEQ // BLOCK
    vis = cs.block_visible(torch, seg, BLOCK)
    blockmax = torch.where(vis, torch.zeros((1, nb, nb), device=dev), float("-inf"))
    idx = bs.select_from_blockmax(blockmax, SLOTS)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    q, k, v, do = (torch.randn((1, SEQ, HEADS, DIM), generator=g, device=dev).bfloat16()
                   for _ in range(4))
    return q, k, v, do, seg, idx


def kernel_split(torch, fn) -> dict:
    """Device ms by kernel of one call of fn under torch.profiler (the
    kernel's name without namespace and template arguments)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            split[name] = split.get(name, 0.0) + us / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1])[:8])


def measure(torch, cs, bs, name, q, k, v, do, seg, idx, iters: int) -> dict:
    scale = DIM ** -0.5
    fwd = lambda: bs.block_sparse_fwd(q, k, v, idx, seg, scale, BLOCK)
    out, lse, mass = fwd()
    again = fwd()
    fwd_same = all(torch.equal(a, b) for a, b in zip((out, lse, mass), again))
    bwd = lambda: bs.block_sparse_bwd(q, k, v, idx, seg, out, lse, do, scale, BLOCK)
    grads = bwd()
    bwd_same = all(torch.equal(a, b) for a, b in zip(grads, bwd()))
    ref = bs.block_sparse_fwd_plain(q, k, v, idx, seg, scale, BLOCK)
    valid = seg[0] != 0
    fwd_err = max(cs._abs(out[:, valid], ref[0][:, valid]),
                  cs._abs(lse[..., valid], ref[1][..., valid]),
                  cs._abs(mass[:, valid], ref[2][:, valid]))
    del ref
    refs = bs.block_sparse_bwd_plain(q, k, v, idx, seg, out, lse, do, scale, BLOCK)
    bwd_rel = max(cs._rel(a, r) for a, r in zip(grads, refs))
    del refs, grads, again
    torch.cuda.synchronize()
    res = {"fwd_ms": cs.cuda_ms(fwd, iters=iters), "bwd_ms": cs.cuda_ms(bwd, iters=iters),
           "fwd_plain_ms": cs.cuda_ms(lambda: bs.block_sparse_fwd_plain(
               q, k, v, idx, seg, scale, BLOCK), iters=2, warmup=1),
           "bwd_plain_ms": cs.cuda_ms(lambda: bs.block_sparse_bwd_plain(
               q, k, v, idx, seg, out, lse, do, scale, BLOCK), iters=2, warmup=1),
           "delta_torch_ms": cs.cuda_ms(lambda: (do.float() * out.float()).sum(-1)
                                        .transpose(1, 2).contiguous(), iters=iters),
           "fwd_err": fwd_err, "bwd_rel": bwd_rel, "fwd_same_bits": fwd_same,
           "bwd_same_bits": bwd_same}
    res["kernels_ms"] = kernel_split(torch, lambda: (fwd(), bwd()))
    mask, _ = bs._visible(idx, seg, BLOCK, True)
    pairs = int(mask.sum())
    del mask
    io = 2 * SEQ * HEADS * DIM
    small = 4 * HEADS * SEQ + 4 * idx.numel() + 4 * SEQ
    res.update(pairs=pairs, valid_slots=int((idx >= 0).sum()),
               fwd_bound=cs.least_ms(2 * pairs * HEADS * 2 * DIM,
                                     4 * io + small + 4 * SEQ * HEADS * SLOTS, cs.PEAK_BF16),
               bwd_bound=cs.least_ms(2 * pairs * HEADS * 5 * DIM, 8 * io + small, cs.PEAK_BF16))
    print(f"[bench] selection={name} " + " ".join(
        f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
        for key, val in res.items() if not isinstance(val, dict)) +
        f" fwd_bound_ms={res['fwd_bound']['bound_ms']:.4f}"
        f" bwd_bound_ms={res['bwd_bound']['bound_ms']:.4f}", flush=True)
    print(f"[bench] selection={name} kernels_ms=" + " ".join(
        f"{k}:{v:.4f}" for k, v in res["kernels_ms"].items()), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_block_sparse_cuda: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from xtuner_tpu_torch.ops.attention import block_sparse as bs

    results = {}
    for name, make in (("synthetic", synthetic), ("recipe", recipe)):
        results[name] = measure(torch, cs, bs, name, *make(torch, cs, bs, args.seed),
                                args.iters)
        torch.cuda.empty_cache()
    print(cs.smi_line())
    print(json.dumps({"checkout": os.getcwd(), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
