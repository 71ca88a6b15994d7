"""Paged KV cache with prompt-prefix sharing (counterpart:
`xtuner_tpu/module/kv_cache.py`).

The pool is one (L, num_blocks, block_size, H, D) tensor per K and V on the
device; block tables, sequence lengths and reference counts stay on the
host, where the engine's allocator runs between steps. Not ported yet: the
int8 pool (`pack_kv_int8`), `paged_write_prefill`, `paged_gather` and the
dense `paged_attention` helper (ROADMAP item [serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class PagedAllocator:
    """Host-side block allocator with reference counts (prefix sharing)."""

    num_blocks: int
    block_size: int
    refcount: np.ndarray = field(init=False)

    def __post_init__(self):
        self.refcount = np.zeros(self.num_blocks, np.int32)

    @property
    def free_blocks(self) -> int:
        return int((self.refcount == 0).sum())

    def alloc(self, n: int) -> list[int]:
        free = np.where(self.refcount == 0)[0]
        if len(free) < n:
            raise MemoryError(f"paged KV pool exhausted: need {n}, free {len(free)}")
        ids = free[:n].tolist()
        self.refcount[ids] += 1
        return ids

    def share(self, block_ids: list[int]) -> list[int]:
        """Add a reference to existing blocks (prefix sharing)."""
        self.refcount[block_ids] += 1
        return list(block_ids)

    def release(self, block_ids: list[int]) -> None:
        self.refcount[block_ids] = np.maximum(self.refcount[block_ids] - 1, 0)


class PagedKVCache:
    """Paged pool on the device + per-sequence block tables on the host.

    pool_k/pool_v: (L, num_blocks, block_size, H, D); block tables are built
    on the host as (B, max_blocks) int32, padded with 0 (masked by seq_lens).
    """

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, dtype, device):
        self.block_size = block_size
        self.allocator = PagedAllocator(num_blocks, block_size)
        shape = (n_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=device)
        self.tables: dict[int, list[int]] = {}  # seq id -> block ids
        self.seq_lens: dict[int, int] = {}

    def add_sequence(self, seq_id: int, n_tokens: int) -> None:
        """Reserve blocks for n_tokens (0 allowed: empty sequence)."""
        blocks = self.allocator.alloc(-(-n_tokens // self.block_size)) if n_tokens else []
        self.tables[seq_id] = blocks
        self.seq_lens[seq_id] = n_tokens

    def extend(self, seq_id: int, n_new: int) -> None:
        """Grow a sequence by n_new tokens, allocating blocks as needed. Only
        block-aligned prefixes may be shared (share_prefix enforces it), so
        appends never land in a shared block."""
        cur = self.seq_lens[seq_id]
        need = -(-(cur + n_new) // self.block_size) - len(self.tables[seq_id])
        if need > 0:
            self.tables[seq_id] += self.allocator.alloc(need)
        self.seq_lens[seq_id] += n_new

    def share_prefix(self, src_id: int, dst_id: int) -> None:
        """dst starts as a reference to src's block-ALIGNED prefix; the
        unaligned tail tokens must be rewritten by the caller."""
        aligned = (self.seq_lens[src_id] // self.block_size) * self.block_size
        n_blocks = aligned // self.block_size
        self.tables[dst_id] = self.allocator.share(self.tables[src_id][:n_blocks])
        self.seq_lens[dst_id] = aligned

    def release(self, seq_id: int) -> None:
        self.allocator.release(self.tables.pop(seq_id))
        self.seq_lens.pop(seq_id)

    def block_table(self, seq_ids: list[int], max_blocks: Optional[int] = None) -> np.ndarray:
        mb = max_blocks or max(len(self.tables[s]) for s in seq_ids)
        out = np.zeros((len(seq_ids), mb), np.int32)
        for i, s in enumerate(seq_ids):
            ids = self.tables[s]
            out[i, :len(ids)] = ids
        return out

    def lens(self, seq_ids: list[int]) -> np.ndarray:
        return np.asarray([self.seq_lens[s] for s in seq_ids], np.int32)


def paged_write(pool: torch.Tensor, layer: int, block_table: torch.Tensor,
                positions: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Scatter one token per sequence into the pool, IN PLACE (the JAX
    engine donates the pool and gets an updated copy back).

    pool: (L, NB, BS, H, D); block_table (B, MB) int32; positions (B,) token
    position within each sequence; values (B, H, D). Returns the pool."""
    bs = pool.shape[2]
    pos = positions.long()
    blk = block_table.long().gather(1, (pos // bs)[:, None])[:, 0]
    pool[layer, blk, pos % bs] = values.to(pool.dtype)
    return pool
