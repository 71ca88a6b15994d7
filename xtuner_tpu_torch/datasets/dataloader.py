"""Dataloader: yields (A, B, L) numpy step-batches with resume state
(counterpart: `xtuner_tpu/datasets/dataloader.py`, its text, InternVL and
Qwen3-VL paths).

One step batch feeds one optimizer step: A = grad-accum micro-batches x
B = packed rows each, collated by `sft_llm_collator`, or with
`max_patches` > 0 per micro-batch by `datasets/qwen_vl.py::qwen3vl_collator`
(patch rows padded to `max_patches`), or with `max_tiles` > 0 by
`datasets/vlm.py::vlm_collator` (tiles padded to `max_tiles`), so every
VLM key stacks to a leading A. With `num_workers`
> 0 a background thread keeps `prefetch` batches ready, so host
tokenization overlaps device compute. The sampler's state is the resume
state; `get_state_dict` reports the position after the batches handed out
(batches prefetched but not yet taken are not counted as consumed).

Not ported: the per-process row split of a multihost run (`local_b_rows`,
[parallelism]).
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .. import not_ported
from .collator import sft_llm_collator
from .qwen_vl import qwen3vl_collator
from .vlm import vlm_collator


class Dataloader:
    def __init__(self, packed_dataset, sampler, pack_max_length: int,
                 global_batch_rows: int, micro_batch_rows: int,
                 loss_reduction: str = "token", num_workers: int = 0, prefetch: int = 2,
                 max_tiles: int = 0, max_patches: int = 0,
                 num_grid_per_side: int = 48, merge_size: int = 2,
                 pad_token_id: int = 0, local_b_rows: "Optional[list[int]]" = None):
        if global_batch_rows % micro_batch_rows != 0:
            raise ValueError("global_batch_rows must be divisible by micro_batch_rows")
        if local_b_rows is not None:
            raise not_ported("the multihost per-process row split (local_b_rows)",
                             "parallelism")
        self.dataset = packed_dataset
        self.sampler = sampler
        self.pack_max_length = pack_max_length
        self.global_batch_rows = global_batch_rows
        self.micro_batch_rows = micro_batch_rows
        self.grad_accum = global_batch_rows // micro_batch_rows
        self.loss_reduction = loss_reduction
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pad_token_id = pad_token_id
        self.max_patches = max_patches
        self.max_tiles = max_tiles
        self.num_grid_per_side = num_grid_per_side
        self.merge_size = merge_size
        self._sampler_iter = iter(self.sampler)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._taken_state = self.sampler.get_state_dict()

    def __len__(self) -> int:
        return max(len(self.dataset) // self.global_batch_rows, 1)

    def _next_batch(self) -> tuple[dict[str, np.ndarray], dict]:
        """The next step batch and the sampler state just after it."""
        a, b = self.grad_accum, self.micro_batch_rows
        rows = [self.dataset[next(self._sampler_iter)] for _ in range(self.global_batch_rows)]
        state = copy.deepcopy(self.sampler.get_state_dict())
        if self.max_patches > 0:
            micro = [qwen3vl_collator(rows[i * b:(i + 1) * b], self.pack_max_length,
                                      self.loss_reduction, max_patches=self.max_patches,
                                      num_grid_per_side=self.num_grid_per_side,
                                      merge_size=self.merge_size,
                                      pad_token_id=self.pad_token_id)
                     for i in range(a)]
            return {k: np.stack([m[k] for m in micro]) for k in micro[0]}, state
        if self.max_tiles > 0:
            micro = [vlm_collator(rows[i * b:(i + 1) * b], self.pack_max_length,
                                  self.loss_reduction, max_tiles=self.max_tiles,
                                  pad_token_id=self.pad_token_id)
                     for i in range(a)]
            return {k: np.stack([m[k] for m in micro]) for k in micro[0]}, state
        batch = sft_llm_collator(rows, self.pack_max_length, self.loss_reduction,
                                 pad_token_id=self.pad_token_id)
        return {k: v.reshape(a, b, -1) for k, v in batch.items()}, state

    def _worker(self):
        while not self._stop.is_set():
            item = self._next_batch()
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self.num_workers > 0 and self._thread is None:
            self._queue = queue.Queue(maxsize=self.prefetch)
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="dataloader-prefetch")
            self._thread.start()
        while True:
            batch, self._taken_state = (self._queue.get() if self._thread is not None
                                        else self._next_batch())
            yield batch

    def close(self) -> None:
        """Stop the prefetch thread (if any)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None

    # ------------------------------------------------------------------
    def get_state_dict(self) -> dict:
        return {"sampler": copy.deepcopy(self._taken_state)}

    def load_state_dict(self, state: dict) -> None:
        self.close()
        self.sampler.load_state_dict(state["sampler"])
        self._sampler_iter = iter(self.sampler)
        self._taken_state = self.sampler.get_state_dict()
