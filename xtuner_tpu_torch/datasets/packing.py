"""Sequence packing (counterpart: `xtuner_tpu/datasets/packing.py`:
`SoftPackDataset` and `HardPackDataset`, the same packs from the same
seed).

- SoftPackDataset: deterministic shuffled first-fit binning over the
  precomputed token counts (or FLOPs-balanced best-fit); samples longer
  than pack_max_length are truncated.
- HardPackDataset: the token stream of all samples chopped into
  exact-length rows (documents keep their own segment ids but may split).

The preset and hybrid multimodal packers are not on the slice's path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.logger import get_logger

logger = get_logger()


def attention_flops_proxy(num_tokens: int) -> float:
    """Per-sample compute proxy: packed causal attention cost grows with the
    square of the DOCUMENT length (not the pack length), so two packs with
    equal tokens can differ several-fold in attention FLOPs. Mirrors the
    reference's with_proxy_attention_flops (datasets/utils.py:105-134)."""
    return float(num_tokens) ** 2


class SoftPackDataset:
    """item = list of (dataset_idx, sample_idx) forming one packed row.

    balance="none": shuffled streaming first-fit (token capacity only).
    balance="flops": greedy best-fit decreasing with attention-FLOPs
    balancing — each sample goes to the open bin with room and the LOWEST
    accumulated FLOPs proxy, so packs come out compute-balanced and dp ranks
    don't straggle on long-document packs (reference packing.py:80-96)."""

    def __init__(self, datasets: Sequence, pack_max_length: int = 16384, seed: int = 0,
                 expand_buffer: int = 1000, balance: str = "none"):
        self.datasets = list(datasets)
        self.pack_max_length = pack_max_length
        self.packs: list[list[tuple[int, int]]] = []
        self.pack_flops: list[float] = []
        rng = np.random.default_rng(seed)

        entries = []  # (num_tokens, ds_idx, sample_idx)
        for di, ds in enumerate(self.datasets):
            counts = np.minimum(ds.num_tokens, pack_max_length)
            for si, c in enumerate(counts):
                if c <= 0:
                    continue
                entries.append((int(c), di, si))

        if balance == "flops":
            self._pack_flops_balanced(entries)
        else:
            self._pack_first_fit(entries, rng, expand_buffer)
        total = sum(len(p) for p in self.packs)
        logger.info(
            f"[pack] {total} samples -> {len(self.packs)} packs of {pack_max_length} tokens"
            + (f" (flops-balanced, cv {self.flops_cv():.3f})" if balance == "flops" else "")
        )

    def _pack_first_fit(self, entries, rng, expand_buffer: int) -> None:
        order = rng.permutation(len(entries))
        # streaming first-fit over a bounded window of open bins
        open_bins: list[tuple[int, list[tuple[int, int]], float]] = []
        for oi in order:
            c, di, si = entries[oi]
            f = attention_flops_proxy(c)
            placed = False
            for bi, (rem, items, fl) in enumerate(open_bins):
                if c <= rem:
                    items.append((di, si))
                    rem -= c
                    fl += f
                    if rem < 64:  # effectively full
                        self.packs.append(items)
                        self.pack_flops.append(fl)
                        open_bins.pop(bi)
                    else:
                        open_bins[bi] = (rem, items, fl)
                    placed = True
                    break
            if not placed:
                open_bins.append((self.pack_max_length - c, [(di, si)], f))
            if len(open_bins) > expand_buffer:
                rem, items, fl = open_bins.pop(0)
                self.packs.append(items)
                self.pack_flops.append(fl)
        for _, items, fl in open_bins:
            self.packs.append(items)
            self.pack_flops.append(fl)

    def _pack_flops_balanced(self, entries) -> None:
        # best-fit decreasing by tokens; bin choice = lowest accumulated flops
        # with room. Bin count is fixed up-front from total tokens so balancing
        # has a stable target.
        total_tokens = sum(c for c, _, _ in entries)
        n_bins = max(1, -(-total_tokens // self.pack_max_length))
        order = sorted(range(len(entries)), key=lambda i: -entries[i][0])
        rem = np.full(n_bins, self.pack_max_length, np.int64)
        flops = np.zeros(n_bins, np.float64)
        bins: list[list[tuple[int, int]]] = [[] for _ in range(n_bins)]
        for oi in order:
            c, di, si = entries[oi]
            fits = np.flatnonzero(rem >= c)
            if len(fits) == 0:
                rem = np.append(rem, self.pack_max_length)
                flops = np.append(flops, 0.0)
                bins.append([])
                fits = np.asarray([len(bins) - 1])
            bi = int(fits[np.argmin(flops[fits])])
            bins[bi].append((di, si))
            rem[bi] -= c
            flops[bi] += attention_flops_proxy(c)
        for bi, items in enumerate(bins):
            if items:
                self.packs.append(items)
                self.pack_flops.append(float(flops[bi]))

    def flops_cv(self) -> float:
        """Coefficient of variation of per-pack attention FLOPs (balance metric)."""
        f = np.asarray(self.pack_flops, np.float64)
        if len(f) == 0 or f.mean() == 0:
            return 0.0
        return float(f.std() / f.mean())

    def __len__(self) -> int:
        return len(self.packs)

    def __getitem__(self, i: int) -> list[dict]:
        out = []
        for di, si in self.packs[i]:
            sample = self.datasets[di][si]
            n = self.pack_max_length
            if sample["num_tokens"] > n:
                sample = {
                    "input_ids": sample["input_ids"][:n],
                    "labels": sample["labels"][:n],
                    "num_tokens": n,
                }
            out.append(sample)
        return out


class HardPackDataset:
    """Exact-length packing: the token stream of all samples is chopped into
    pack_max_length rows; a document may span two rows (each part keeps its
    own segment id so attention never crosses the cut)."""

    def __init__(self, datasets: Sequence, pack_max_length: int = 16384, seed: int = 0):
        self.datasets = list(datasets)
        self.pack_max_length = pack_max_length
        rng = np.random.default_rng(seed)
        entries = []
        for di, ds in enumerate(self.datasets):
            counts = ds.num_tokens
            for si in range(len(counts)):
                entries.append((di, si, int(counts[si])))
        order = rng.permutation(len(entries))
        self.order = [entries[i] for i in order]
        total_tokens = sum(e[2] for e in self.order)
        self.num_packs = total_tokens // pack_max_length
        # index: for each pack, (start_entry, start_offset)
        self._index = []
        cum = 0
        entry_i, entry_off = 0, 0
        for _ in range(self.num_packs):
            self._index.append((entry_i, entry_off))
            remaining = pack_max_length
            while remaining > 0 and entry_i < len(self.order):
                avail = self.order[entry_i][2] - entry_off
                take = min(avail, remaining)
                remaining -= take
                entry_off += take
                if entry_off >= self.order[entry_i][2]:
                    entry_i += 1
                    entry_off = 0

    def __len__(self) -> int:
        return self.num_packs

    def __getitem__(self, i: int) -> list[dict]:
        entry_i, entry_off = self._index[i]
        remaining = self.pack_max_length
        out = []
        while remaining > 0 and entry_i < len(self.order):
            di, si, n = self.order[entry_i]
            sample = self.datasets[di][si]
            take = min(n - entry_off, remaining)
            out.append({
                "input_ids": sample["input_ids"][entry_off:entry_off + take],
                "labels": sample["labels"][entry_off:entry_off + take],
                "num_tokens": take,
            })
            remaining -= take
            entry_off += take
            if entry_off >= n:
                entry_i += 1
                entry_off = 0
        return out
