"""The paged decode kernel's work order (TPU kernel #5) in plain torch,
against the JAX package.

The Hopper kernel (`csrc/paged_decode.cu`) splits each (slot, kv head)'s
table entries into runs of whole blocks (`paged_decode_splits`; the split
count from `paged_decode_split_plan`, the cut per slot on the device),
computes a partial softmax per run and merges the runs in order.
`paged_decode_split_plain` does the same on the CPU. Here:

- it against JAX's `paged_decode_attn` in interpret mode, within 1e-5 in
  f32 (the same products, summed in another order and merged across runs),
  at C 1 and 2, GQA rep 1 and 4, blocks of 16 and 32, with an inactive
  slot, a one-token slot, a slot whose seq_len + C ends on a block edge,
  runs of one block and of several, and more splits than a slot has
  blocks;
- the walk: each valid table entry of each slot loaded by exactly one run,
  in order, entries < 0 or >= NB never, nothing past seq_len + C; the
  split plan from the shapes alone.

Inputs are numpy arrays from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.attention.paged_decode import paged_decode_attn as j_paged_decode
from xtuner_tpu_torch.ops.attention import paged_decode as tpd

TOL = 1e-5
D = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(c, hq, hkv, bs, lens, mb=None, seed=0):
    """A 2-layer f32 pool, each active slot's blocks drawn at random from
    blocks 1.. (block 0 is the inactive slots' trash block)."""
    rng = np.random.default_rng(seed)
    need = [-(-(n + c) // bs) if n else 0 for n in lens]
    mb = mb or max(max(need), 1)
    nb = sum(need) + 3
    pk = rng.standard_normal((2, nb, bs, hkv, D), dtype=np.float32)
    pv = rng.standard_normal((2, nb, bs, hkv, D), dtype=np.float32)
    q = rng.standard_normal((len(lens), c, hq, D), dtype=np.float32)
    table = np.zeros((len(lens), mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for bi, k in enumerate(need):
        for t in range(k):
            table[bi, t] = free.pop()
    return q, pk, pv, table, np.array(lens, np.int32)


# (C, Hq, Hkv, BS, lens): lens hold an inactive slot (0), a one-token slot
# (1), and seq_len + C on a block edge (31 + 1, 30 + 2, 63 + 1)
CASES = {
    "c1_rep4_bs16": (1, 8, 2, 16, [37, 0, 1, 31, 70]),
    "c2_rep4_bs16": (2, 8, 2, 16, [30, 0, 1, 45]),
    "c1_rep1_bs32": (1, 4, 4, 32, [63, 1, 0, 100]),
    "c2_rep1_bs32": (2, 4, 4, 32, [62, 0, 1, 33]),
}


@pytest.mark.parametrize("splits", [1, 2, 3, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_matches_jax_kernel(case, splits):
    """splits 1: one run of every block; 2 and 3: runs of several blocks
    and of one; 64: more splits than any slot has blocks."""
    c, hq, hkv, bs, lens = CASES[case]
    q, pk, pv, table, sl = _case(c, hq, hkv, bs, lens, seed=len(case) + splits)
    scale = D ** -0.5
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), 1,
                          jnp.asarray(table), jnp.asarray(sl), scale=scale, interpret=True)
    got = tpd.paged_decode_split_plain(_t(q), _t(pk), _t(pv), 1, _t(table), _t(sl),
                                       scale=scale, splits=splits)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the wrapper's plain version computes the same function
    plain = tpd.paged_decode_attn(_t(q), _t(pk), _t(pv), 1, _t(table), _t(sl), scale=scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 64])
def test_walk_loads_each_valid_block_once(splits):
    """Every table entry below min(ceil((seq_len + C) / BS), MB) that names
    a pool block is loaded by exactly one run, runs in order and even
    (lengths differ by the last run's remainder only); entries < 0 or >= NB
    and entries past the slot's last block never."""
    bs, c, nb = 16, 2, 40
    lens = [0, 1, 14, 30, 31, 77, 200, 400]  # the last one past MB * BS
    mb = 12
    table = np.arange(len(lens) * mb, dtype=np.int32).reshape(len(lens), mb) % nb
    table[3, 1] = -1   # never handed out
    table[5, 2] = nb   # out of the pool
    table[5, 4] = -7
    walks = tpd.paged_decode_walk(_t(table), _t(np.array(lens, np.int32)), c, bs, nb, splits)
    for bi, (n, walk) in enumerate(zip(lens, walks)):
        n_blk = min(-(-(n + c) // bs), mb)
        runs = tpd.paged_decode_splits(n_blk, splits)
        assert len(walk) == len(runs) <= max(splits, 1)
        assert runs[0][0] == 0 and runs[-1][1] == n_blk
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(runs, runs[1:]))
        assert len({t1 - t0 for t0, t1 in runs[:-1]}) <= 1
        assert all(t1 - t0 >= 1 for t0, t1 in runs)
        loaded = [t for run in walk for t, _ in run]
        want = [t for t in range(n_blk) if 0 <= table[bi, t] < nb]
        assert loaded == want  # each valid entry once, in order
        assert all(blk == table[bi, t] for run in walk for t, blk in run)


def test_split_plan_reads_shapes_only():
    """About 2 CTAs per SM were every table full, never more splits than
    table entries or than the kernel merges, at least one."""
    assert tpd.paged_decode_split_plan(4, 8, 16, 132) == 9        # serve: 1-2 blocks a run
    assert tpd.paged_decode_split_plan(32, 8, 64, 132) == 2       # rollout: 33 blocks -> 17, 16
    assert tpd.paged_decode_split_plan(256, 8, 64, 132) == 1
    assert tpd.paged_decode_split_plan(1, 1, 5, 132) == 5
    assert tpd.paged_decode_split_plan(1, 1, 4096, 132) == tpd.MAX_SPLITS
    assert tpd.paged_decode_splits(33, 2) == [(0, 17), (17, 33)]
    assert tpd.paged_decode_splits(33, 3) == [(0, 11), (11, 22), (22, 33)]
    assert tpd.paged_decode_splits(15, 9) == [(t, min(t + 2, 15)) for t in range(0, 15, 2)]
    assert tpd.paged_decode_splits(15, 16) == [(t, t + 1) for t in range(15)]
    assert tpd.paged_decode_splits(0, 4) == [(0, 0)]


def test_split_plain_with_unloaded_runs():
    """Runs whose every entry is skipped (< 0 or >= NB) add nothing; a slot
    whose entries are all skipped gives zeros, as the kernel writes."""
    c, hq, hkv, bs = 1, 8, 2, 16
    q, pk, pv, table, sl = _case(c, hq, hkv, bs, [70, 40], seed=4)
    nb = pk.shape[1]
    table[0, 1] = -1
    table[0, 2] = nb + 3
    table[1, :] = -1
    got = tpd.paged_decode_split_plain(_t(q), _t(pk), _t(pv), 0, _t(table), _t(sl),
                                       scale=D ** -0.5, splits=5)
    assert torch.isfinite(got).all() and not got[1].any()
    # slot 0 against the gather over the blocks it keeps
    keep = [t for t in range(table.shape[1]) if 0 <= table[0, t] < nb]
    slots = np.concatenate([np.arange(t * bs, t * bs + bs) for t in keep])
    slots = slots[slots <= sl[0]]
    blocks = table[0, [s // bs for s in slots]]
    k, v = pk[0, blocks, slots % bs], pv[0, blocks, slots % bs]  # (S, hkv, D)
    qg = q[0, 0].reshape(hkv, hq // hkv, D)
    s = np.einsum("grd,sgd->grs", qg, k) * D ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("grs,sgd->grd", p / p.sum(-1, keepdims=True), v).reshape(hq, D)
    np.testing.assert_allclose(got[0, 0].numpy(), want, atol=TOL, rtol=TOL)
