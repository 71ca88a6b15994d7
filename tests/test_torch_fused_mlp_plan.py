"""The fused expert MLP's work decomposition (`ops/fused_moe_mlp.py`:
`fused_mlp_plan_counts`, `fused_mlp_chunked_plain`; the tiles of
`ops/bf16_grouped.py::grouped_tile_plan` at its 128 rows)
against the JAX package.

On a card the forward (TPU kernel #16) walks expert-pure tiles of 128 rows
(each expert's rows cut from its first row, rows past the last group as
zero tiles); per tile it runs gate|up over 128-column chunks of F with
the activation in registers, then out over 256-column passes of the whole
hidden tile. Here the tile plan is checked for coverage, and that order in
plain torch is held against JAX's `fused_moe_mlp` forward, whose Pallas
kernel runs in interpret mode on the CPU (as `tests/ops/test_fused_moe_mlp.py`
runs it), at moe_heavy's F768 and the longctx row's F128 scaled down
(F384: three chunks; F128: one; F192: a last chunk of 64). Inputs are numpy
arrays from a seed, in bf16. out and gu are bf16 roundings of the same f32
sums taken in another order: within one bf16 step (2^-8) of the largest
entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops import fused_moe_mlp as jfm
from xtuner_tpu_torch.ops import fused_moe_mlp as tfm
from xtuner_tpu_torch.ops.bf16_grouped import grouped_tile_plan

FWD_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _close(got, want, rtol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{msg}: {err} > {rtol}"


@pytest.mark.parametrize("sizes,m", [
    ([100, 0, 500, 400], 1000),          # an empty expert, unaligned sizes
    ([0, 1001, 0, 0], 1001),             # one expert with all rows
    ([37, 300, 1, 400], 777 + 39),       # a 1-row expert; 39 rows past the last group
    ([128, 256, 0, 0, 0], 384),          # whole tiles; empty experts at the end
    ([0, 0, 0], 300),                    # no routed row: zero tiles only
    ([300, 300], 450),                   # the sizes overrun M: offsets clamp to M
])
def test_tile_plan_covers_each_row_once(sizes, m):
    gs = torch.tensor(sizes, dtype=torch.int32)
    expert, rs, re = (t.tolist() for t in grouped_tile_plan(gs, m, tfm.TILE_M))
    ends = np.minimum(np.cumsum(sizes), m)
    starts = np.concatenate([[0], ends[:-1]])
    covered = np.zeros(m, np.int64)
    for e, a, b in zip(expert, rs, re):
        assert 0 < b - a <= tfm.TILE_M
        covered[a:b] += 1
        if e >= 0:  # never mixes experts; starts at a multiple of 128 from the expert's first row
            assert starts[e] <= a and b <= ends[e] and (a - starts[e]) % tfm.TILE_M == 0
        else:  # rows past the last group
            assert a >= ends[-1]
    assert (covered == 1).all()
    # experts in order, each expert's tiles together, zero tiles last
    busy = [e for e in expert if e >= 0]
    assert busy == sorted(busy) and expert[len(busy):] == [-1] * (len(expert) - len(busy))
    assert [e for e in range(len(sizes)) if ends[e] > starts[e]] == sorted(set(busy))


@pytest.mark.parametrize("h,f", [(1024, 768), (1024, 128), (1024, 1536), (256, 64), (384, 192)])
def test_plan_counts(h, f):
    """Per tile with products: ceil(F / 128) x H / 64 chunks of gate|up, then
    ceil(H / 256) x F / 64 chunks of the output passes."""
    gs = torch.tensor([300, 0, 1, 555], dtype=torch.int32)
    busy, zero, chunks = tfm.fused_mlp_plan_counts(gs, 900, h, f)
    assert (busy, zero) == (3 + 1 + 5, 1)  # 300 rows: 3 tiles, 1 row: 1, 555: 5; 44 rows past
    per = -(-f // 128) * (h // 64) + -(-h // 256) * (f // 64)
    assert chunks == busy * per
    if (h, f) == (1024, 768):
        assert per == 6 * 16 + 4 * 12


@pytest.mark.parametrize("m,h,f,e,seed", [
    (700, 256, 384, 4, 0),    # moe_heavy's F768 scaled down: three gate|up chunks
    (1000, 256, 128, 8, 1),   # the longctx row's F128: one chunk
    (700, 256, 192, 4, 2),    # a last chunk of 64 columns
])
def test_chunked_order_matches_jax(m, h, f, e, seed):
    rng = np.random.default_rng(seed)
    x = _bf(rng.normal(size=(m, h)))
    w_gu = _bf(rng.normal(size=(e, h, 2 * f)) * 0.05)
    w_dn = _bf(rng.normal(size=(e, f, h)) * 0.05)
    raw = rng.multinomial(m - 37, np.ones(e) / e)  # 37 rows past the last group
    raw[1] = 0  # an empty expert
    gs = raw.astype(np.int32)
    jx, jgu, jdn = (jnp.asarray(a, jnp.bfloat16) for a in (x, w_gu, w_dn))
    want_out, res = jax.jit(jfm._fmlp_fwd, static_argnums=4)(jx, jgu, jdn, jnp.asarray(gs),
                                                            True)
    t = [torch.from_numpy(a).bfloat16() for a in (x, w_gu, w_dn)]
    out, gu = tfm.fused_mlp_chunked_plain(*t, torch.from_numpy(gs))
    assert out.dtype == gu.dtype == torch.bfloat16
    n = int(gs.sum())
    _close(out[:n], np.asarray(want_out, np.float32)[:n], FWD_RTOL, "out")
    _close(gu[:n], np.asarray(res[3], np.float32)[:n], FWD_RTOL, "gu")
    assert (out[n:] == 0).all() and (gu[n:] == 0).all()
    # the order changes no value: the plain expert loop gives the same bits
    want = tfm.fused_moe_mlp_plain(*t, torch.from_numpy(gs))
    assert torch.equal(out, want[0]) and torch.equal(gu, want[1])
