"""The grouped GEMM kernel's work list (`grouped_tile_plan`, and the counts
one launch walks, `grouped_plan_counts`) against the JAX package's visit
table (`xtuner_tpu/ops/fp8_grouped.py::build_visit_table`, which
`ops/bf16_grouped.py` uses) and a row-by-row check.

The kernel (`csrc/grouped_gemm.cu`) cuts each expert's rows into 128-row
tiles that start at the expert's first row and makes zero tiles of the
rows past the last group; it counts on the card what it walks, and the
card tests and `chip_smoke.py` hold those counts to this plan. Here the
plan must cover each row of each non-empty expert exactly once, keep every
tile inside one expert, make zero tiles of exactly the rows past the last
group, never take more tiles than JAX's valid visits, and cover the same
(row, expert) pairs as JAX does. Group sizes come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.fp8_grouped import build_visit_table
from xtuner_tpu_torch.ops import bf16_grouped as bg

TILE = bg.TILE_M


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(rng, m: int, e: int, used: int, empty: int) -> list:
    """`e` group sizes summing to `used` <= m, `empty` of them zero."""
    nonempty = rng.choice(e, e - empty, replace=False)
    sizes = np.zeros(e, dtype=np.int64)
    sizes[nonempty] = rng.multinomial(used - (e - empty), np.full(e - empty, 1 / (e - empty))) + 1
    return sizes.tolist()


CASES = {
    "empty_experts": (1024, [100, 0, 500, 0, 424]),
    "one_expert_every_row": (4096, [0, 0, 4096, 0]),
    "sizes_not_multiples": (1000, [37, 300, 1, 600, 62]),
    "sum_under_m": (700, [200, 0, 0, 400]),
    "m_not_multiple_of_128": (8191, [4000, 4191]),
    "e128": (8192, None),
    "e128_60_empty": (8192, [0] * 60 + [120] * 68),
    "e256": (16384, None),
}


def _case(name: str):
    m, sizes = CASES[name]
    if sizes is None:
        e = 128 if name == "e128" else 256
        rng = np.random.default_rng(len(name))
        sizes = _sizes(rng, m, e, m - 77, e // 8)
    return m, sizes


def _jax_pairs(sizes: list, m: int) -> tuple[set, int]:
    """The (row, expert) pairs JAX's valid visits cover, and their count."""
    t = {k: np.asarray(v) for k, v in
         build_visit_table(jnp.asarray(sizes, jnp.int32), m, TILE).items()}
    pairs = set()
    for i in np.flatnonzero(t["valid"]):
        lo = max(int(t["m_block"][i]) * TILE, int(t["row_start"][i]))
        hi = min(int(t["m_block"][i]) * TILE + TILE, int(t["row_end"][i]))
        pairs |= {(r, int(t["expert"][i])) for r in range(lo, hi)}
    return pairs, int(t["valid"].sum())


@pytest.mark.parametrize("name", list(CASES))
def test_plan_covers_each_row_once_inside_one_expert(name):
    m, sizes = _case(name)
    expert, rs, re = bg.grouped_tile_plan(torch.tensor(sizes, dtype=torch.int32), m)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    seen = np.zeros(m, dtype=np.int64)
    for e_, a, b in zip(expert.tolist(), rs.tolist(), re.tolist()):
        assert 0 < b - a <= TILE
        seen[a:b] += 1
        if e_ >= 0:
            assert offs[e_] <= a < b <= offs[e_ + 1]  # inside one expert
            assert (a - offs[e_]) % TILE == 0  # tiles start at the expert's first row
        else:
            assert a >= offs[-1]  # zero tiles: only rows past the last group
    assert (seen == 1).all()
    n_zero = int((expert < 0).sum())
    assert n_zero == -(-(m - offs[-1]) // TILE)
    assert len(expert) - n_zero == sum(-(-s // TILE) for s in sizes)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_against_jax_visit_table(name):
    """At most JAX's valid visits, and the same (row, expert) pairs."""
    m, sizes = _case(name)
    expert, rs, re = bg.grouped_tile_plan(torch.tensor(sizes, dtype=torch.int32), m)
    jax_pairs, jax_visits = _jax_pairs(sizes, m)
    busy = expert >= 0
    assert int(busy.sum()) <= jax_visits
    ours = {(r, e_) for e_, a, b in zip(expert[busy].tolist(), rs[busy].tolist(),
                                         re[busy].tolist()) for r in range(a, b)}
    assert ours == jax_pairs


@pytest.mark.parametrize("name", ["empty_experts", "sizes_not_multiples", "e128_60_empty",
                                  "e256"])
@pytest.mark.parametrize("k,n", [(96, 224), (1024, 128), (2048, 1536)])
def test_plan_counts(name, k, n):
    """What one launch walks: nn/nt the plan's tiles times the column
    blocks (128 wide at an output width of 128 or less, else 256) and the
    64-deep contraction chunks; dw one item per (expert, 128-row K tile,
    column block), zero for an empty expert, walking ceil(n_e / 64)
    chunks."""
    m, sizes = _case(name)
    gs = torch.tensor(sizes, dtype=torch.int32)
    tiles = sum(-(-s // TILE) for s in sizes)
    zero = -(-(m - sum(sizes)) // TILE)
    for kind, c, width in (("nn", k, n), ("nt", n, k)):
        blocks = -(-width // (128 if width <= 128 else 256))
        assert bg.grouped_plan_counts(gs, m, kind, k, n) == \
            (tiles * blocks, zero * blocks, tiles * blocks * -(-c // 64))
    per = -(-k // 128) * -(-n // (128 if n <= 128 else 256))
    busy = sum(1 for s in sizes if s)
    assert bg.grouped_plan_counts(gs, m, "dw", k, n) == \
        (busy * per, (len(sizes) - busy) * per, sum(-(-s // 64) for s in sizes) * per)
