"""The block-sparse kernels' work orders (TPU kernels #14 and #15) in plain
torch, against the visible pairs and the JAX package.

The Hopper kernels (`csrc/block_sparse.cu`) walk 64-row tiles: the forward
and the dq pass per CTA of 128 q rows, the two 64-row halves' selections
merged into one stream of key blocks (`fwd_walk`); the dk/dv pass per
64-key tile over the q heads of its group and the q tiles of the q-blocks
that chose its block (`dkv_walk`). Each candidate tile is labelled: not
chosen by a half, skipped without a load, masked per element, or full.
Here:

- both walks against `_visible`'s pairs: every visible pair lies in
  exactly one walked (masked or full) tile of its half and slot, or of its
  q head; a skipped tile holds none; a full tile holds only visible pairs;
- `block_sparse_fwd_walk_plain` and `block_sparse_bwd_walk_plain`, which
  compute tile by tile in f32 in the walks' order, against JAX's `_bs_fwd`
  and `_bs_bwd` in interpret mode within 2e-5 (the same f32 products summed
  in another order; relative, and against each array's largest entry).

Cases cover blocks of 64, 128, 192 (the halves of every other CTA in two
q-blocks) and 256, GQA, padded tails, L not a multiple of 128 (the last
CTA's second half past L), a "hot" block 0 that every q-block chooses,
and short documents of 1-2 blocks per q-block. Inputs are numpy
arrays from seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.attention import block_sparse as jbs
from xtuner_tpu_torch.ops.attention import block_sparse as tbs

TOL = 2e-5
TILE = tbs.TILE
# name: (B, L, Hq, Hkv, D, Dv, block, S, document lengths per row, pad, hot)
CASES = {
    "block64_gqa_hot": (1, 512, 4, 2, 32, 16, 64, 4, [100, 37, 200, 90], 85, True),
    "block128_b2": (2, 512, 2, 2, 16, 16, 128, 3, [300, 150], 62, False),
    "block192_halves": (1, 768, 2, 1, 16, 16, 192, 3, [250, 260, 200], 58, False),
    "block256_short_docs": (1, 1024, 4, 1, 16, 16, 256, 8,
                            [120, 90, 200, 60, 150, 100, 80, 170], 54, False),
    "block64_one_doc": (1, 384, 2, 2, 16, 16, 64, 3, [384], 0, True),
    # L = 9 x 64: the last CTA's second half lies past L
    "block192_tail": (1, 576, 2, 1, 16, 16, 192, 2, [200, 180, 150], 46, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, seed=0):
    """f32 q, k, v, do; segment ids (documents from position 0, then the
    padded tail); a selection from random block maxima through
    `select_from_blockmax`, minus the blocks no query of the q-block can
    see (the indexer's maxima are -inf there), with `hot` block 0 first."""
    b, l, hq, hkv, d, dv, block, s, lens, pad, hot = CASES[name]
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        off = 0
        for i, n in enumerate(lens):
            n = min(n, l - pad - off)
            seg[bi, off:off + n] = i + 1
            off += n
    nb = l // block
    blockmax = rng.standard_normal((b, nb, nb)).astype(np.float32)
    docs = np.eye(seg.max() + 1, dtype=np.float32)[seg][..., 1:]  # (B, L, docs)
    present = docs.reshape(b, nb, block, -1).max(axis=2)
    seen = present @ present.transpose(0, 2, 1) > 0
    blockmax = np.where(seen, blockmax, -np.inf)
    if hot:
        blockmax[..., 0] = np.where(seen[..., 0], 1e4, -np.inf)
    idx = tbs.select_from_blockmax(torch.from_numpy(blockmax), s).numpy()
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, l, hq, d), (b, l, hkv, d), (b, l, hkv, dv), (b, l, hq, dv))]
    return (*arrays, idx, seg, block, d ** -0.5)


def _tile_pairs(idx, seg, block):
    """Per (b, q tile, key tile, slot): the number of visible pairs, from
    `_visible` (the plain versions' mask)."""
    mask, kpos = tbs._visible(torch.from_numpy(idx), torch.from_numpy(seg), block, True)
    b_, nq, _, sb = mask.shape
    counts: dict = {}
    for b, qb, t, col in torch.nonzero(mask).tolist():
        key = (b, (qb * block + t) // TILE, int(kpos[b, qb, col]) // TILE, col // block)
        counts[key] = counts.get(key, 0) + 1
    return counts


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_walk_covers_each_visible_pair_once(name):
    _, _, _, _, idx, seg, block, _ = _case(name)
    counts = _tile_pairs(idx, seg, block)
    walked: dict = {}
    for b, i, kt, s0, s1, l0, l1 in tbs.fwd_walk(torch.from_numpy(idx), torch.from_numpy(seg),
                                                  block):
        for x, slot, lab in ((0, s0, l0), (1, s1, l1)):
            if lab == tbs.NOT_CHOSEN:
                continue
            qt = 2 * i + x
            assert idx[b, TILE * qt // block, slot] == kt * TILE // block  # its slot's block
            pairs = counts.get((b, qt, kt, slot), 0)
            if lab == tbs.SKIP:
                assert pairs == 0, "a skipped tile holds a visible pair"
            else:
                walked[(b, qt, kt, slot)] = walked.get((b, qt, kt, slot), 0) + 1
                if lab == tbs.FULL:
                    assert pairs == TILE * TILE, "a full tile holds a masked pair"
    assert counts and all(walked.get(key, 0) == 1 for key in counts), \
        "a visible pair walked 0 or 2 times"


@pytest.mark.parametrize("name", sorted(CASES))
def test_dkv_walk_covers_each_visible_pair_once(name):
    idx, seg, block = _case(name)[4:7]
    ratio = CASES[name][2] // CASES[name][3]
    counts = _tile_pairs(idx, seg, block)
    tiles: dict = {}
    for (b, qt, kt, _slot), n in counts.items():
        tiles[(b, qt, kt)] = tiles.get((b, qt, kt), 0) + n
    walked: dict = {}
    for b, kt, r, qt, lab in tbs.dkv_walk(torch.from_numpy(idx), torch.from_numpy(seg), block,
                                          ratio):
        assert kt * TILE // block in idx[b, qt * TILE // block]  # its q-block chose the block
        pairs = tiles.get((b, qt, kt), 0)
        if lab == tbs.SKIP:
            assert pairs == 0, "a skipped tile holds a visible pair"
            continue
        walked[(b, qt, kt, r)] = walked.get((b, qt, kt, r), 0) + 1
        if lab == tbs.FULL:
            assert pairs == TILE * TILE, "a full tile holds a masked pair"
    for b, qt, kt in tiles:
        for r in range(ratio):
            assert walked.get((b, qt, kt, r), 0) == 1, "a visible pair walked 0 or 2 times"


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max(initial=0))),
                               err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jax_fns(scale, block):
    fwd = jax.jit(lambda q, k, v, i, s: jbs._bs_fwd(q, k, v, i, s, scale, True, block, True))
    bwd = jax.jit(lambda res, g, gm: jbs._bs_bwd(scale, True, block, True, res, (g, gm)))
    return fwd, bwd


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_forward_and_backward_match_jax(name):
    q, k, v, do, idx, seg, block, scale = _case(name)
    fwd, bwd = _jax_fns(scale, block)
    heads = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # (B, L, H, .) -> (B, H, L, .)
    (j_out, j_mass), res = fwd(heads(q), heads(k), heads(v), jnp.asarray(idx),
                               jnp.asarray(seg))
    j_lse = res[-1]
    j_dq, j_dk, j_dv, _, _ = bwd(res, heads(do), jnp.zeros_like(j_mass))
    back = lambda a: np.swapaxes(np.asarray(a), 1, 2)

    t = [torch.from_numpy(a) for a in (q, k, v, idx, seg)]
    out, lse, mass = tbs.block_sparse_fwd_walk_plain(*t, scale, block)
    valid = seg != 0
    _close(out, back(j_out), "out")
    _close(lse.transpose(1, 2)[torch.from_numpy(valid)],
           back(j_lse[..., None])[..., 0][valid], "lse")
    _close(mass[torch.from_numpy(valid)], back(j_mass)[valid], "mass")
    assert (out[torch.from_numpy(~valid)] == 0).all()
    assert (lse.transpose(1, 2)[torch.from_numpy(~valid)] == tbs.BIG_LSE).all()
    assert (mass[torch.from_numpy(~valid)] == 0).all()

    grads = tbs.block_sparse_bwd_walk_plain(*t, out, lse, torch.from_numpy(do), scale, block)
    for nm, got, want in zip(("dq", "dk", "dv"), grads, (j_dq, j_dk, j_dv)):
        _close(got, back(want), nm)
