"""The fused-CE backward's row-chunk plan (`ops/fused_ce.py`:
`ce_chunk_plan`, `ce_coeff_plain`, `ce_bwd_chunked_plain`) against the JAX
package.

On a card the backward runs one coefficient sweep per chunk of rows (the
bf16 c chunk in a reused scratch), then dh_chunk = c . w and dW += c^T .
h_chunk. `ce_bwd_chunked_plain` is that plan in plain torch; here it is
held against the VJP of JAX's `ce_stats_vh`, whose Pallas kernels run in
interpret mode on the CPU (as `tests/ops/test_fused_ce.py` runs them), at
a chunk size that does not divide N, a vocab that does not tile (the
kernel prefix + XLA tail split, and the pad path) and ignored rows.
Inputs are numpy arrays from a seed. Tolerances are
`tests/test_torch_fused_ce.py`'s: in f32 within 2e-5 of each gradient's
largest entry (the same products summed in another order); in bf16
within 1e-2 (both round the coefficient and the results to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.fused_ce import ce_stats_vh as j_ce_stats_vh
from xtuner_tpu_torch.ops import fused_ce as fc

F32_TOL = 2e-5
BF16_RTOL = 1e-2
CHUNK = 128  # rows per chunk in the tests: 320 rows -> chunks of 128, 128, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, v, hd, seed, ignored=0.0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, hd), dtype=np.float32)
    w = (rng.standard_normal((v, hd)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    keep = rng.random(n) >= ignored
    labels = np.where(keep, labels, 0).astype(np.int32)
    g_lse = np.where(keep, rng.random(n), 0).astype(np.float32)
    g_lab = np.where(keep, -rng.random(n), 0).astype(np.float32)
    return h, w, labels, g_lse, g_lab


def _close(got, want, rtol, msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _torch_args(h, w, labels, g_lse, g_lab, dtype):
    th, tw = torch.tensor(h).to(dtype), torch.tensor(w).to(dtype)
    tl = torch.tensor(labels)
    lse = fc.ce_fwd(th, tw, tl)[0]
    return th, tw, tl, lse, torch.tensor(g_lse), torch.tensor(g_lab)


@pytest.mark.parametrize("n,v,hd,ignored,dtype", [
    (320, 2 * 2048 + 384, 128, 0.0, "float32"),   # split path: prefix kernel + XLA tail
    (320, 1000, 128, 0.25, "float32"),            # pad path (V < one 2048 tile), ignored rows
    (320, 2 * 2048 + 384, 256, 0.25, "float32"),  # ignored rows: clamped, zero cotangents
    (320, 2 * 2048 + 384, 128, 0.1, "bfloat16"),  # the working dtype
])
def test_chunked_backward_matches_jax(monkeypatch, n, v, hd, ignored, dtype):
    monkeypatch.setattr(fc, "CHUNK_ROWS", CHUNK)
    plan = fc.ce_chunk_plan(n, v)
    assert [r for _, r in plan.chunks] == [128, 128, 64]  # the chunk size does not divide N
    h, w, labels, g_lse, g_lab = _inputs(n, v, hd, seed=n + v + hd, ignored=ignored)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def j_fn(h_, w_):
        lse, lab = j_ce_stats_vh(h_, w_, jnp.asarray(labels))
        return jnp.sum(lse * g_lse) + jnp.sum(lab * g_lab)

    jdh, jdw = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    dh, dw = fc.ce_bwd_chunked_plain(*_torch_args(h, w, labels, g_lse, g_lab, tdt))
    assert dh.dtype == dw.dtype == tdt and dw.shape == (v, hd)
    tol = F32_TOL if dtype == "float32" else BF16_RTOL
    _close(dh.float().numpy(), np.asarray(jdh, np.float32), tol, "dh")
    _close(dw.float().numpy(), np.asarray(jdw, np.float32), tol, "dw")
    dead = (g_lse == 0) & (g_lab == 0)
    if ignored:
        assert dead.any() and np.abs(dh.float().numpy()[dead]).max() == 0.0


@pytest.mark.parametrize("asked", ["dh", "dw"])
def test_chunked_backward_gives_only_what_is_asked(monkeypatch, asked):
    monkeypatch.setattr(fc, "CHUNK_ROWS", CHUNK)
    args = _torch_args(*_inputs(320, 1000, 128, seed=5, ignored=0.1), torch.float32)
    both = fc.ce_bwd_chunked_plain(*args)
    one = fc.ce_bwd_chunked_plain(*args, need_dh=asked == "dh", need_dw=asked == "dw")
    keep = 0 if asked == "dh" else 1
    assert one[1 - keep] is None and torch.equal(one[keep], both[keep])


def test_chunked_backward_matches_the_whole_plain_versions(monkeypatch):
    """The chunk plan changes only where the dW sum is cut, not what is
    summed: the plain versions of #9 and #10 over all rows agree."""
    monkeypatch.setattr(fc, "CHUNK_ROWS", CHUNK)
    args = _torch_args(*_inputs(320, 1000, 256, seed=9, ignored=0.1), torch.float32)
    dh, dw = fc.ce_bwd_chunked_plain(*args)
    _close(dh.numpy(), fc.ce_dh_plain(*args).numpy(), F32_TOL, "dh")
    _close(dw.numpy(), fc.ce_dw_plain(*args).numpy(), F32_TOL, "dw")


@pytest.mark.parametrize("v", [100, 1000, 2 * 2048 + 384])
def test_coefficient_chunk(v):
    """c sums over the vocab to g_lse + g_lab per row (p sums to 1), holds
    the label term at the label's column, and is exactly 0 past V."""
    th, tw, tl, lse, tgl, tgb = _torch_args(*_inputs(96, v, 128, seed=v, ignored=0.2),
                                            torch.float32)
    v_pad = fc.ce_chunk_plan(96, v).v_pad
    c = fc.ce_coeff_plain(th, tw, tl, lse, tgl, tgb, v_pad)
    assert c.shape == (96, v_pad) and v_pad % fc.VOCAB_TILE == 0 and v_pad >= v
    assert (c[:, v:] == 0).all()
    _close(c.sum(1).numpy(), (tgl + tgb).numpy(), 1e-5, "row sums")
    p_lab = torch.exp(th @ tw.T - lse[:, None]).gather(1, tl[:, None].long())[:, 0]
    _close(c.gather(1, tl[:, None].long())[:, 0].numpy(), (p_lab * tgl + tgb).numpy(), 1e-6)
    # the wrapper on CPU tensors is the plain version and launches nothing
    fc.reset_launches()
    assert torch.equal(fc.ce_coeff(th, tw, tl, lse, tgl, tgb, v_pad), c)
    assert fc.ce_coeff.launches == 0


@pytest.mark.parametrize("n", [1, 300, 4096, 4096 + 300, 16384, 65536, 1_000_000])
def test_chunk_plan_at_qwen_vocab(n):
    """At V151936 (Qwen's vocab, the sft and longctx paths) a chunk is at
    most 4096 rows whatever N is, the c scratch at most 1.25 GB, and the
    chunks cover the rows in order, all but the last a multiple of 128."""
    plan = fc.ce_chunk_plan(n, 151936)
    assert plan.nc == 4096 and plan.v_pad == 152064
    assert plan.scratch_bytes <= fc.C_SCRATCH_BYTES <= 1.25e9
    assert plan.scratch_bytes == 2 * plan.rows * plan.v_pad
    starts = [s for s, _ in plan.chunks]
    sizes = [r for _, r in plan.chunks]
    assert starts == [sum(sizes[:i]) for i in range(len(sizes))] and sum(sizes) == n
    assert all(0 < r <= plan.nc for r in sizes)
    assert all(r % 128 == 0 for r in sizes[:-1]) and len(sizes) == -(-n // plan.nc)
    if n == 65536:
        assert sizes == [4096] * 16 and plan.scratch_bytes == 2 * 4096 * 152064
    if n == 4096 + 300:  # two chunks of one size, the last one ragged
        assert sizes == [2304, 2092]


@pytest.mark.parametrize("v", [100, 5000, 151936, 262144, 1_000_000])
def test_chunk_plan_bounds_the_scratch_by_the_vocab(v):
    """Nc depends on V alone: the largest multiple of 128 up to 4096 whose
    bf16 (Nc, V_pad) chunk fits the bound."""
    plans = [fc.ce_chunk_plan(n, v) for n in (4096, 65536)]
    nc, v_pad = plans[0].nc, plans[0].v_pad
    assert all(p.nc == nc and p.v_pad == v_pad for p in plans)
    assert v_pad == -(-v // 256) * 256 and nc % 128 == 0 and nc <= fc.CHUNK_ROWS
    assert 2 * nc * v_pad <= fc.C_SCRATCH_BYTES
    assert nc == fc.CHUNK_ROWS or 2 * (nc + 128) * v_pad > fc.C_SCRATCH_BYTES


def test_cpu_backward_wrapper_runs_the_plain_versions():
    args = _torch_args(*_inputs(64, 300, 128, seed=3, ignored=0.1), torch.float32)
    fc.reset_launches()
    dh, dw = fc.ce_bwd(*args)
    assert torch.equal(dh, fc.ce_dh_plain(*args)) and torch.equal(dw, fc.ce_dw_plain(*args))
    assert fc.ce_bwd(*args, need_dw=False)[1] is None
    assert fc.ce_bwd(*args, need_dh=False)[0] is None
    assert (fc.ce_coeff.launches, fc.ce_dh.launches, fc.ce_dw.launches) == (0, 0, 0)
