"""The fp8 grouped kernels' work orders (TPU kernels #12 and #13, and #11
on the same kernel) in plain torch, against the JAX package.

The Hopper kernel (`csrc/fp8_grouped.cu`) walks #12 over
`grouped_tile_plan`'s expert-pure 128-row tiles in 128-deep scale steps,
promoting each step's product into an f32 sum, and #13 over
`fp8_dw_items`: per (expert, K tile, N tile) the global 128-row tiles that
overlap the expert's rows, with the codes of a straddling tile zeroed
byte by byte in 128-byte-swizzled shared memory; #11, the dense GEMM, is
#12's walk with one group of all M rows. `fp8_grouped_tiled_plain`,
`fp8_dw_walk_plain` and `fp8_gemm_tiled_plain` do the same in that order
on the CPU. Here:

- both against JAX's `fp8_grouped_gemm` and `fp8_grouped_gemm_dw` in
  interpret mode at K in {256, 512, 1024}, e4m3 and e5m2, f32 out, within
  2e-5 (tests/test_torch_float8.py's KERNEL_TOL: the same per-tile products,
  summed in another order; the wgrad relative to its largest entry);
- at K = 768, which JAX's kernels cannot run (#12 asserts K % 512 == 0
  above 512, #13 leaves rows 512-767 of every dW unwritten), and at M <
  128 (JAX wants M % 256 == 0), against the float64 oracles of
  tests/fp8_oracles.py;
- #11's mirror against JAX's `fp8_gemm_tilewise` in interpret mode at K in
  {256, 512, 1024} and M not a multiple of 128, e4m3 x e4m3, e5m2 x e4m3
  and e4m3 x e5m2 (2e-5), against the float64 tile oracle at K = 768, and
  against #12's mirror over one group;
- the launch functions refuse, before any pointer reaches the kernel,
  operands off the card and operands that do not fit the kernel's layout;
- the plans: each row covered exactly once, each tile inside one expert,
  the item and step counts the kernels' device counters report
  (`fp8_plan_counts`), and the swizzle's chunk mapping behind the byte
  masks.

Group sizes put expert starts at offsets 0, 1, 15, 16, 17 and 127 inside a
128-row tile, with an empty first and last expert, 1-row experts and rows
past the last group. Inputs are numpy arrays from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops import fp8_gemm as jgemm
from xtuner_tpu.ops import fp8_grouped as jgrp
from xtuner_tpu_torch.ops import fp8_gemm as tgemm
from xtuner_tpu_torch.ops import fp8_grouped as tgrp
from xtuner_tpu_torch.ops.bf16_grouped import grouped_tile_plan

from fp8_oracles import grouped_oracle, rowtile_oracle, tile_oracle

KERNEL_TOL = 2e-5
TILE = 128
_DT = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
# (M, group sizes): expert starts at 0, 1, 15, 16, 17 and 127 of the first
# tile, an empty first and last expert, 1-row experts, 85 rows past the
# last group; and 128-row experts on tile boundaries
CASES = {
    "boundaries": (512, [0, 1, 14, 1, 1, 110, 300, 0]),
    "aligned": (256, [0, 128, 128, 0]),
}
# M below one tile (the wgrad's rows padded to 128, as its wrapper pads them)
SMALL = (100, [0, 37, 1, 50, 0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    # a few outliers, so that tiles get different scales
    return (x * (1 + 10 * (rng.random(shape) > 0.99))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gg_operands(m, k, n, e, a_dtype, seed=0):
    """x (m, k) and w (e, k, n) quantised by both packages."""
    x, w = _data((m, k), seed), _data((e, k, n), seed + 1) * np.float32(0.1)
    jdt, tdt = _DT[a_dtype]
    jx = jgemm.quantize_tilewise(jnp.asarray(x), 128, jdt)
    jw = jgrp.quantize_blockwise_stack(jnp.asarray(w), 128)
    tx = tgemm.quantize_tilewise(_t(x), 128, tdt)
    tw = tgrp.quantize_blockwise_stack(_t(w))
    return jx, jw, tx, tw


def _dw_operands(m, k, n, y_dtype, seed=5):
    x, dy = _data((m, k), seed), _data((m, n), seed + 1)
    jdt, tdt = _DT[y_dtype]
    jx = jgrp.quantize_rowtile(jnp.asarray(x), 128)
    jy = jgrp.quantize_rowtile(jnp.asarray(dy), 128, jdt)
    tx = tgrp.quantize_rowtile(_t(x))
    ty = tgrp.quantize_rowtile(_t(dy), 128, tdt)
    return jx, jy, tx, ty


# --------------------------------------------------------- #12: forward/dgrad
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("a_dtype", ["e4m3", "e5m2"])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_tiled_plain_matches_jax_kernel(k, a_dtype, case):
    m, sizes = CASES[case]
    n, e = 256, len(sizes)
    (jxq, jsx), (jwq, jsw), (xq, sx), (wq, sw) = _gg_operands(m, k, n, e, a_dtype, seed=k)
    want = np.asarray(jgrp.fp8_grouped_gemm(jxq, jsx, jwq, jsw, jnp.asarray(sizes, jnp.int32),
                                            interpret=True, out_dtype=jnp.float32))
    got = tgrp.fp8_grouped_tiled_plain(xq, sx, wq, sw, torch.tensor(sizes, dtype=torch.int32))
    used = sum(sizes)  # JAX's kernel never writes the rows past the last group
    np.testing.assert_allclose(got[:used].numpy(), want[:used], rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    assert not got[used:].any()


@pytest.mark.parametrize("case", ["boundaries", "small"])
@pytest.mark.parametrize("a_dtype", ["e4m3", "e5m2"])
def test_tiled_plain_at_k768_matches_the_tile_oracle(a_dtype, case):
    m, sizes = SMALL if case == "small" else CASES[case]
    k, n, e = 768, 256, len(sizes)
    _, _, (xq, sx), (wq, sw) = _gg_operands(m, k, n, e, a_dtype, seed=3)
    got = tgrp.fp8_grouped_tiled_plain(xq, sx, wq, sw, torch.tensor(sizes, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), grouped_oracle(xq, sx, wq, sw, sizes),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert not got[sum(sizes):].any()


# ------------------------------------------------ #11: one group of M rows
GEMM_TYPES = [("e4m3", "e4m3"), ("e5m2", "e4m3"), ("e4m3", "e5m2")]


def _gemm_operands(m, k, n, a_dtype, b_dtype, seed):
    """x (m, k) per (row, 128-col) tile and w (k, n) per 128 x 128 block,
    quantised by both packages."""
    x, w = _data((m, k), seed), _data((k, n), seed + 1) * np.float32(0.05)
    jx = jgemm.quantize_tilewise(jnp.asarray(x), 128, _DT[a_dtype][0])
    jw = jgemm.quantize_blockwise(jnp.asarray(w), 128, _DT[b_dtype][0])
    tx = tgemm.quantize_tilewise(_t(x), 128, _DT[a_dtype][1])
    tw = tgemm.quantize_blockwise(_t(w), 128, _DT[b_dtype][1])
    return jx, jw, tx, tw


@pytest.mark.parametrize("types", GEMM_TYPES, ids=["x".join(t) for t in GEMM_TYPES])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_gemm_tiled_plain_matches_jax_kernel(k, types):
    """M = 200: a full 128-row tile and a short one (JAX pads M to 256)."""
    m, n = 200, 256
    (jxq, jsx), (jwq, jsw), (xq, sx), (wq, sw) = _gemm_operands(m, k, n, *types, seed=k + 21)
    want = np.asarray(jgemm.fp8_gemm_tilewise(jxq, jsx, jwq, jsw, out_dtype=jnp.float32,
                                              interpret=True))
    got = tgemm.fp8_gemm_tiled_plain(xq, sx, wq, sw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("m", [77, 200, 256])
@pytest.mark.parametrize("types", GEMM_TYPES, ids=["x".join(t) for t in GEMM_TYPES])
def test_gemm_tiled_plain_at_k768_matches_the_tile_oracle(types, m):
    k, n = 768, 384
    _, _, (xq, sx), (wq, sw) = _gemm_operands(m, k, n, *types, seed=m + 5)
    got = tgemm.fp8_gemm_tiled_plain(xq, sx, wq, sw)
    np.testing.assert_allclose(got.numpy(), tile_oracle(xq, sx, wq, sw), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


def test_gemm_tiled_plain_is_the_grouped_walk_over_one_group():
    """The dense mode runs #12's walk with one group of all M rows: the two
    mirrors agree, and the plan counts one group's tiles."""
    m, k, n = 300, 512, 256
    _, _, (xq, sx), (wq, sw) = _gemm_operands(m, k, n, "e4m3", "e4m3", seed=31)
    one = torch.tensor([m], dtype=torch.int32)
    np.testing.assert_allclose(
        tgemm.fp8_gemm_tiled_plain(xq, sx, wq, sw).numpy(),
        tgrp.fp8_grouped_tiled_plain(xq, sx, wq[None], sw[None], one).numpy(),
        rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert tgrp.fp8_plan_counts(one, m, "gg", k, n) == (3 * 2, 0, 3 * 2 * 4)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("k_mismatch", "do not fit"),   # wt's K differs from xq's
    ("not_k_major", "do not fit"),  # wq (K, N) passed as it is
    ("sw_shape", "do not fit"),
])
def test_gemm_launch_refuses_what_the_kernel_cannot_take(case, match):
    """`fp8_gemm_launch` hands raw pointers to TMA maps: a CPU tensor or a
    shape outside its layout raises instead of reaching them."""
    e4 = torch.float8_e4m3fn
    xq, sx = torch.zeros((200, 256), dtype=e4), torch.ones((200, 2))
    wt, sw = torch.zeros((384, 256), dtype=e4), torch.ones((2, 3))
    if case == "k_mismatch":
        wt = wt[:, :128].contiguous()
    elif case == "not_k_major":
        wt = torch.zeros((256, 384), dtype=e4)
    elif case == "sw_shape":
        sw = sw.T.contiguous()
    with pytest.raises(ValueError, match=match):
        tgemm.fp8_gemm_launch(xq, sx, wt, sw)


# ---------------------------------------------------------------- #13: wgrad
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("y_dtype", ["e4m3", "e5m2"])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_dw_walk_plain_matches_jax_kernel(k, y_dtype, case):
    m, sizes = CASES[case]
    n, e = 128, len(sizes)
    (jxq, jsx), (jyq, jsy), (xq, sx), (yq, sy) = _dw_operands(m, k, n, y_dtype, seed=k + 5)
    want = np.asarray(jgrp.fp8_grouped_gemm_dw(jxq, jsx, jyq, jsy,
                                               jnp.asarray(sizes, jnp.int32), e, interpret=True))
    got = tgrp.fp8_dw_walk_plain(xq, sx, yq, sy, torch.tensor(sizes, dtype=torch.int32), e)
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(want).max())
    for i, s in enumerate(sizes):
        if s == 0:
            assert not got[i].any()


@pytest.mark.parametrize("case", ["boundaries", "small"])
def test_dw_walk_plain_at_k768_matches_the_rowtile_oracle(case):
    m, sizes = SMALL if case == "small" else CASES[case]
    m = -(-m // TILE) * TILE
    k, n, e = 768, 256, len(sizes)
    _, _, (xq, sx), (yq, sy) = _dw_operands(m, k, n, "e5m2", seed=9)
    got = tgrp.fp8_dw_walk_plain(xq, sx, yq, sy, torch.tensor(sizes, dtype=torch.int32), e)
    want = rowtile_oracle(xq, sx, yq, sy, sizes, e)
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(want).max())


def test_the_mirrors_agree_with_the_wrappers_plain_versions():
    """The walks and the per-expert plain versions the wrappers run on the
    CPU compute one function (f32 out, the same tolerance)."""
    m, sizes = CASES["boundaries"]
    gs = torch.tensor(sizes, dtype=torch.int32)
    _, _, (xq, sx), (wq, sw) = _gg_operands(m, 384, 128, len(sizes), "e4m3", seed=11)
    np.testing.assert_allclose(
        tgrp.fp8_grouped_tiled_plain(xq, sx, wq, sw, gs).numpy(),
        tgrp.fp8_grouped_gemm(xq, sx, wq, sw, gs, out_dtype=torch.float32).numpy(),
        rtol=KERNEL_TOL, atol=KERNEL_TOL)
    _, _, (xq, sx), (yq, sy) = _dw_operands(m, 384, 128, "e4m3", seed=12)
    want = tgrp.fp8_grouped_gemm_dw(xq, sx, yq, sy, gs, len(sizes)).numpy()
    np.testing.assert_allclose(tgrp.fp8_dw_walk_plain(xq, sx, yq, sy, gs, len(sizes)).numpy(),
                               want, rtol=KERNEL_TOL, atol=KERNEL_TOL * np.abs(want).max())


# --------------------------------------------------------------------- plans
PLAN_CASES = {**CASES, "small": SMALL, "sum_over_m": (300, [200, 0, 250]),
              "e16": (4096, [0, 700, 1, 255, 129, 127, 0, 300, 900, 17, 16, 15, 640, 1, 0, 500])}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_gg_plan_covers_each_row_once(case):
    """#12's items: `grouped_tile_plan`'s tiles, each inside one expert and
    starting at a multiple of 128 rows from its expert's first row, zero
    tiles over exactly the rows past the last group; per launch tiles x N
    tiles items, K / 128 steps each."""
    m, sizes = PLAN_CASES[case]
    gs = torch.tensor(sizes, dtype=torch.int32)
    ends = np.minimum(np.cumsum(sizes), m)
    offs = np.concatenate([[0], ends])
    seen = np.zeros(m, dtype=np.int64)
    expert, rs, re = grouped_tile_plan(gs, m)
    for e_, a, b in zip(expert.tolist(), rs.tolist(), re.tolist()):
        assert 0 < b - a <= TILE
        seen[a:b] += 1
        if e_ >= 0:
            assert offs[e_] <= a < b <= offs[e_ + 1] and (a - offs[e_]) % TILE == 0
        else:
            assert a >= offs[-1]
    assert (seen == 1).all()
    tiles = sum(-(-int(b - a) // TILE) for a, b in zip(offs[:-1], offs[1:]))
    zero = -(-(m - int(offs[-1])) // TILE)
    for k, n in ((256, 128), (1024, 768)):
        assert tgrp.fp8_plan_counts(gs, m, "gg", k, n) == \
            (tiles * (n // TILE), zero * (n // TILE), tiles * (n // TILE) * (k // TILE))


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_dw_items_cover_each_expert_row_once(case):
    """#13's items: (expert, K tile, N tile) for every expert, experts by
    falling row count (ties by index); each item's row tiles cover its
    expert's rows exactly once and each tile overlaps them; an empty
    expert's items are zero items."""
    m, sizes = PLAN_CASES[case]
    m = -(-m // TILE) * TILE
    k, n = 384, 256
    gs = torch.tensor(sizes, dtype=torch.int32)
    it = tgrp.fp8_dw_items(gs, m, k, n)
    per = (k // TILE) * (n // TILE)
    assert len(it["expert"]) == len(sizes) * per
    rows = np.diff(np.concatenate([[0], np.minimum(np.cumsum(sizes), m)]))
    order = it["expert"][::per].tolist()
    assert sorted(order) == list(range(len(sizes)))
    assert order == sorted(order, key=lambda e_: (-rows[e_], e_))
    assert {(a, b) for a, b in zip(it["k0"].tolist(), it["n0"].tolist())} == \
        {(a, b) for a in range(0, k, TILE) for b in range(0, n, TILE)}
    for e_, rs, re, t0, steps in zip(*(it[x].tolist() for x in ("expert", "rs", "re", "t0",
                                                               "steps"))):
        assert re - rs == rows[e_]
        if rs == re:
            assert steps == 0
            continue
        seen = np.zeros(m, dtype=np.int64)
        for t in range(t0, t0 + steps):
            lo, hi = max(rs, TILE * t), min(re, TILE * t + TILE)
            assert lo < hi  # the tile overlaps the expert's rows
            seen[lo:hi] += 1
        assert (seen[rs:re] == 1).all() and seen.sum() == re - rs
    busy = int((it["steps"] > 0).sum())
    assert tgrp.fp8_plan_counts(gs, m, "dw", k, n) == \
        (busy, len(it["steps"]) - busy, int(it["steps"].sum()))


def test_swizzle_chunk_mapping_is_tma_128b_swizzle():
    """`swizzle_128b` is the byte permutation of CU_TENSOR_MAP_SWIZZLE_128B
    (the offset o of a 1024-byte atom goes to o ^ ((o >> 7) & 7) << 4), a
    bijection of each 128-byte row."""
    rows, j = torch.arange(16)[:, None], torch.arange(TILE)[None, :]
    phys = tgrp.swizzle_128b(rows, j)
    o = (rows % 8) * TILE + j
    assert torch.equal(rows % 8 * TILE + phys, o ^ (((o >> 7) & 7) << 4))
    assert all(sorted(r) == list(range(TILE)) for r in phys.tolist())


@pytest.mark.parametrize("lo,hi", [(0, 128), (1, 128), (15, 128), (16, 128), (17, 128),
                                   (127, 128), (0, 1), (0, 15), (0, 16), (0, 17), (0, 127),
                                   (1, 2), (17, 100), (16, 32), (-5, 140), (40, 40)])
def test_straddle_masks_keep_exactly_the_expert_rows(lo, hi):
    """The kernel's byte masks, built per swizzled 16-byte chunk and read
    back through the chunk mapping, keep M position j of every smem row
    exactly when lo <= j < hi."""
    keep = tgrp.straddle_keep(TILE, lo, hi)
    j = torch.arange(TILE)
    assert torch.equal(keep, ((j >= lo) & (j < hi)).expand(TILE, -1))


def _launch_operands(m=256, k=256, n=128, e=2):
    """CPU operands in the kernels' layouts: #12's (xq, sx, wt, sw) and #13's
    (xt, sx, yt, sy), with (e,) int32 group sizes."""
    e4 = torch.float8_e4m3fn
    gg = (torch.zeros((m, k), dtype=e4), torch.ones((m, k // TILE)),
          torch.zeros((e, n, k), dtype=e4), torch.ones((e, k // TILE, n // TILE)))
    dw = (torch.zeros((m // TILE, k, TILE), dtype=e4), torch.ones((m // TILE, 1)),
          torch.zeros((m // TILE, n, TILE), dtype=e4), torch.ones((m // TILE, 1)))
    return gg, dw, torch.full((e,), m // e, dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("k_mismatch", "do not fit"),   # wt's K differs from xq's
    ("sx_shape", "do not fit"),     # one scale per row, not per 128-deep tile
    ("sw_shape", "do not fit"),
])
def test_gg_launch_refuses_what_the_kernel_cannot_take(case, match):
    """`fp8_grouped_gemm_launch` hands raw pointers to TMA maps: a CPU
    tensor or a shape outside its layout raises instead of reaching them."""
    (xq, sx, wt, sw), _, gs = _launch_operands()
    if case == "k_mismatch":
        wt = wt[:, :, :128].contiguous()
    elif case == "sx_shape":
        sx = torch.ones((xq.shape[0], 1))
    elif case == "sw_shape":
        sw = sw[:, :, :0]
    with pytest.raises(ValueError, match=match):
        tgrp.fp8_grouped_gemm_launch(xq, sx, wt, sw, gs)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("tiles_mismatch", "do not fit"),  # yt holds fewer row tiles than xt
    ("not_row_tiles", "do not fit"),   # (M, K) codes, not (M/128, K, 128)
    ("scale_shape", "do not fit"),
])
def test_dw_launch_refuses_what_the_kernel_cannot_take(case, match):
    """As above, for `fp8_grouped_dw_launch`."""
    _, (xt, sx, yt, sy), gs = _launch_operands()
    if case == "tiles_mismatch":
        yt = yt[:1].contiguous()
    elif case == "not_row_tiles":
        xt = xt.reshape(-1, 64, 2 * TILE)
    elif case == "scale_shape":
        sy = sy[:, 0]
    with pytest.raises(ValueError, match=match):
        tgrp.fp8_grouped_dw_launch(xt, sx, yt, sy, gs, len(gs))
