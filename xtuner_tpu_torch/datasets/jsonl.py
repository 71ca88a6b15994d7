"""Offset-indexed JSONL dataset with an on-disk token-count cache
(counterpart: `xtuner_tpu/datasets/jsonl.py`).

Host-side numpy code: tokenization is lazy per item; `num_tokens` for the
packer is computed once (in spawned worker processes for a large file) and
cached as .npy under `cache_dir`, keyed by the file and the tokenize
function's hash. `sample_ratio` scales the length the packer sees.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from ..utils.logger import get_logger

logger = get_logger()


def _count_token_range(args) -> np.ndarray:
    """Worker: tokenize-count offsets[lo:hi] through its own file handle."""
    path, offsets, lo, hi, tokenize_fn = args
    counts = np.empty(hi - lo, np.int64)
    with open(path, "rb") as f:
        for idx in range(lo, hi):
            f.seek(offsets[idx])
            counts[idx - lo] = tokenize_fn(json.loads(f.readline()))["num_tokens"]
    return counts


class JsonlDataset:
    def __init__(self, path: str | Path, tokenize_fn: Callable[[dict], dict],
                 cache_dir: Optional[str | Path] = None, sample_ratio: float = 1.0,
                 name: str = "", num_proc: int = 0):
        self.path = Path(path)
        self.tokenize_fn = tokenize_fn
        self.sample_ratio = sample_ratio
        self.name = name or self.path.stem
        # token-count parallelism: 0 = auto (cpu count, capped), 1 = serial
        self.num_proc = num_proc
        self._offsets = self._build_offsets()
        self._file = None
        self._num_tokens: Optional[np.ndarray] = None
        self._cache_dir = Path(cache_dir) if cache_dir else None

    def _build_offsets(self) -> np.ndarray:
        offsets = [0]
        with open(self.path, "rb") as f:
            for line in f:
                offsets.append(offsets[-1] + len(line))
        return np.asarray(offsets[:-1], dtype=np.int64)

    def __len__(self) -> int:
        n = len(self._offsets)
        return int(n * self.sample_ratio) if self.sample_ratio != 1.0 else n

    def _read_line(self, i: int) -> dict:
        i = i % len(self._offsets)
        if self._file is None:
            self._file = open(self.path, "rb")
        self._file.seek(self._offsets[i])
        return json.loads(self._file.readline())

    def __getitem__(self, i: int) -> dict:
        return self.tokenize_fn(self._read_line(i))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # ------------------------------------------------------------------
    def _cache_key(self) -> str:
        fn_hash = self.tokenize_fn.hash() if hasattr(self.tokenize_fn, "hash") else "nohash"
        stat = self.path.stat()
        key = f"{self.path}:{stat.st_size}:{stat.st_mtime_ns}:{fn_hash}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    @property
    def num_tokens(self) -> np.ndarray:
        """Per-sample token counts (drives the packer)."""
        if self._num_tokens is not None:
            return self._num_tokens
        cache_path = None
        if self._cache_dir is not None:
            self._cache_dir.mkdir(parents=True, exist_ok=True)
            cache_path = self._cache_dir / f"{self.name}-{self._cache_key()}.npy"
            if cache_path.exists():
                self._num_tokens = np.load(cache_path)
                if len(self._num_tokens) == len(self._offsets):
                    return self._num_tokens
        n = len(self._offsets)
        workers = self.num_proc if self.num_proc > 0 else min(os.cpu_count() or 1, 16)
        logger.info(f"[dataset {self.name}] counting tokens for {n} samples "
                    f"({workers} processes)")
        counts = self._count_tokens(workers)
        if cache_path is not None:
            np.save(cache_path, counts)
        self._num_tokens = counts
        return counts

    def _count_tokens(self, workers: int) -> np.ndarray:
        """Spawned worker processes count slices of the file; in process when
        workers <= 1, for a small file, or when the function cannot be
        pickled."""
        n = len(self._offsets)
        if workers <= 1 or n < 2 * workers:
            return _count_token_range((self.path, self._offsets, 0, n, self.tokenize_fn))
        bounds = np.linspace(0, n, workers + 1, dtype=int)
        jobs = [(self.path, self._offsets, int(lo), int(hi), self.tokenize_fn)
                for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
        try:
            import multiprocessing as mp

            # spawn, not fork: the parent may hold CUDA and threads
            with mp.get_context("spawn").Pool(len(jobs)) as pool:
                parts = pool.map(_count_token_range, jobs)
            return np.concatenate(parts)
        except (pickle.PicklingError, AttributeError, TypeError, OSError) as e:
            logger.warning(f"[dataset {self.name}] parallel count failed ({e}); "
                           "counting in process")
            return _count_token_range((self.path, self._offsets, 0, n, self.tokenize_fn))

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_file"] = None  # an open handle does not cross processes
        return state
