"""Resumable samplers (counterpart: `xtuner_tpu/datasets/sampler.py`:
`ParallelSampler` and `LengthGroupedSampler`; the preset-order sampler is
not on the slice's path). One process assembles the global batch, so the
sampler yields global indices, in the JAX package's order.
"""

from __future__ import annotations

import numpy as np


class ParallelSampler:
    """Infinite epoch-shuffled index stream with exact-position resume."""

    def __init__(self, dataset_len: int, seed: int = 0, shuffle: bool = True):
        self.dataset_len = dataset_len
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self.consumed = 0  # indices consumed within the current epoch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.dataset_len)
        rng = np.random.default_rng(self.seed + epoch)
        return rng.permutation(self.dataset_len)

    def __iter__(self):
        while True:
            order = self._epoch_order(self.epoch)
            while self.consumed < self.dataset_len:
                idx = int(order[self.consumed])
                self.consumed += 1
                yield idx
            self.epoch += 1
            self.consumed = 0

    def get_state_dict(self) -> dict:
        return {"epoch": self.epoch, "consumed": self.consumed, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.consumed = state["consumed"]
        self.seed = state.get("seed", self.seed)


class LengthGroupedSampler(ParallelSampler):
    """Groups indices by similar length inside shuffled mega-batches."""

    def __init__(self, dataset_len: int, lengths, group_size: int, seed: int = 0):
        super().__init__(dataset_len, seed=seed, shuffle=True)
        self.lengths = np.asarray(lengths)
        self.group_size = group_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.dataset_len)
        out = []
        for start in range(0, self.dataset_len, self.group_size):
            chunk = order[start:start + self.group_size]
            out.append(chunk[np.argsort(self.lengths[chunk])[::-1]])
        return np.concatenate(out)
