"""The flash forward kernel's tile plan (`fwd_tile_plan`: which k tiles the
kernel walks for each q tile, and which of those skip the per-element
mask) against the JAX package's `_tile_full` and a brute-force mask.

The plan is computed from the padded segment ids and their tile table, as
the kernel reads them; the kernel itself counts the tiles it walks, and
the card tests and `chip_smoke.py` hold those counts to the plan. Inputs:
packed rows from a numpy seed, with documents shorter than a tile,
documents spanning many tiles, a padded tail and L not a multiple of 128.
The plan must never skip a tile that holds a visible pair, never call a
tile full that holds a masked pair, and call full exactly the tiles JAX
calls full.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.ops.attention.reference import make_attention_mask

TILE = tflash.KEY_TILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(rng, l: int, lens: list) -> np.ndarray:
    """One row of segment ids: documents of `lens` from position 0, ids
    1, 2, ..., then padding (0) to `l`."""
    seg = np.zeros(l, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i + 1
        off += n
    assert off <= l
    return seg


def _random_lens(rng, l: int) -> list:
    """Documents from 1 row to several tiles long, then a padded tail of
    0-200 rows."""
    pad = int(rng.integers(0, 200))
    lens, left = [], l - pad
    while left > 0:
        n = int(min(left, rng.choice([rng.integers(1, 40), rng.integers(40, 200),
                                      rng.integers(200, 700)])))
        lens.append(n)
        left -= n
    return lens


ROWS = {
    "short_docs": lambda rng: (1000, [17, 3, 90, 64, 1, 200, 33]),  # docs below a tile
    "one_long_doc": lambda rng: (1500, [1500]),  # no padding: every tile below the diagonal full
    "long_doc_pad": lambda rng: (1100, [990]),  # one document, padded tail (serving's bucket)
    "tile_aligned": lambda rng: (768, [256, 384, 128]),  # boundaries on tile edges
    "tiny": lambda rng: (65, [30, 20]),  # a single tile, L < 128
    "just_past": lambda rng: (129, [129]),  # the last tile holds one row
}


def _batch(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "random":
        l = int(rng.integers(300, 1400))
        rows = [_row(rng, l, _random_lens(rng, l)) for _ in range(3)]
    else:
        l, lens = ROWS[kind](rng)
        rows = [_row(rng, l, lens)]
    return np.stack(rows)


def _jax_plan(seg_p: np.ndarray):
    """JAX's per-tile predicates over the padded ids: `_tile_full` and the
    `needed` test of `_fwd_kernel` (causal & segment ranges), (B, nt, nt)."""
    b, lp = seg_p.shape
    nt = lp // TILE
    tiles = jnp.asarray(seg_p.reshape(b, nt, TILE))
    ii, jj = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")

    def one(i, j, qseg, kseg):
        full = jflash._tile_full(i, j, qseg, kseg, True, None, TILE, TILE)
        qmin_nz = jnp.min(jnp.where(qseg == 0, jnp.int32(2 ** 30), qseg))
        needed = (j * TILE <= i * TILE + TILE - 1) & (jnp.max(kseg) >= qmin_nz) \
            & (jnp.max(qseg) > 0) & (jnp.max(kseg) > 0)
        return full, needed

    def row(t):
        return jax.vmap(lambda i, j: one(i, j, t[i], t[j]))(jnp.asarray(ii.ravel()),
                                                            jnp.asarray(jj.ravel()))

    full, needed = jax.jit(jax.vmap(row))(tiles)
    return (np.asarray(full).reshape(b, nt, nt), np.asarray(needed).reshape(b, nt, nt))


def _brute(seg_p: np.ndarray):
    """(any visible pair, every pair visible) per (q tile, k tile), from the
    dense (Lp, Lp) mask."""
    b, lp = seg_p.shape
    nt = lp // TILE
    mask = make_attention_mask(torch.from_numpy(seg_p), causal=True)[:, 0].numpy()
    m = mask.reshape(b, nt, TILE, nt, TILE)
    return m.any(axis=(2, 4)), m.all(axis=(2, 4))


@pytest.mark.parametrize("kind,seed", [
    *[(k, 0) for k in ROWS],
    ("random", 1), ("random", 2), ("random", 3), ("random", 4),
])
def test_fwd_tile_plan_matches_jax_and_the_mask(kind, seed):
    seg = _batch(kind, seed)
    walk, full = (t.numpy() for t in tflash.fwd_tile_plan(torch.from_numpy(seg)))
    lp = -(-seg.shape[1] // TILE) * TILE
    seg_p = np.pad(seg, ((0, 0), (0, lp - seg.shape[1])))
    nt = lp // TILE
    assert walk.shape == full.shape == (seg.shape[0], nt, nt)
    any_vis, all_vis = _brute(seg_p)
    j_full, j_needed = _jax_plan(seg_p)
    # never skip a tile that holds a visible pair, never walk one JAX skips
    assert not (any_vis & ~walk).any()
    assert not (walk & ~j_needed).any()
    # never call a tile full that holds a masked pair; full exactly as JAX
    assert not (full & ~all_vis).any()
    np.testing.assert_array_equal(full, j_full)
    assert not (full & ~walk).any()
    # the walk is causal: no tile above the diagonal
    assert not (walk & np.triu(np.ones((nt, nt), bool), 1)[None]).any()


def test_fwd_tile_plan_of_one_long_document():
    """One document over the whole row: every tile up to the diagonal is
    walked, and all but the diagonal ones are full (the common case at
    long context)."""
    nt = 12
    seg = torch.ones((1, nt * TILE), dtype=torch.int32)
    walk, full = tflash.fwd_tile_plan(seg)
    assert int(walk.sum()) == nt * (nt + 1) // 2
    assert int(full.sum()) == nt * (nt - 1) // 2


def test_fwd_tile_plan_skips_padding_and_other_documents():
    """Two documents of exactly two tiles each and a tile of padding: the
    second document's q tiles walk only its own k tiles; the padding tile
    walks nothing."""
    seg = torch.tensor([[1] * 256 + [2] * 256 + [0] * 128], dtype=torch.int32)
    walk, full = tflash.fwd_tile_plan(seg)
    want = np.zeros((5, 5), bool)
    want[0, 0] = True
    want[1, :2] = True
    want[2, 2] = True
    want[3, 2:4] = True
    np.testing.assert_array_equal(walk[0].numpy(), want)
    full_want = np.zeros((5, 5), bool)
    full_want[1, 0] = full_want[3, 2] = True
    np.testing.assert_array_equal(full[0].numpy(), full_want)
