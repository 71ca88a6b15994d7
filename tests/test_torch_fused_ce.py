"""The port's fused CE (`ops/fused_ce.py`, `ce_loss(mode="fused")`) against
the JAX package.

On the CPU the port's three kernel wrappers run their plain versions and
the JAX `ce_stats_vh` runs its Pallas kernels in interpret mode, as
`tests/ops/test_fused_ce.py` runs them, including the split of a vocab
that does not tile (kernel prefix + XLA tail merged by `logaddexp`).
Inputs are numpy arrays from a seed. In f32 both sides sum the same
products in another order: values within 2e-5, gradients within 2e-5 of
each one's largest entry. In bf16 both round the coefficient and the
results to bf16, so gradients agree within 1e-2 of the largest entry (the
kernels' bf16 bound).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.fused_ce import ce_stats_vh as j_ce_stats_vh
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.ops import fused_ce as fc

# the module (the JAX package's `loss/__init__.py` exports the function
# under the module's name)
jce = importlib.import_module("xtuner_tpu.loss.ce_loss")
F32_TOL = 2e-5
BF16_RTOL = 1e-2


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


@pytest.mark.parametrize("n,v,hd,ignored,dtype", [
    (64, 2 * 2048 + 384, 128, 0.0, "float32"),   # split path: prefix kernel + XLA tail
    (48, 1000, 128, 0.0, "float32"),             # pad path: V < one 2048 tile
    (64, 2 * 2048 + 384, 256, 0.25, "float32"),  # ignored rows: clamped, zero cotangents
    (64, 2 * 2048 + 384, 128, 0.1, "bfloat16"),  # the working dtype
])
def test_ce_stats_vh_matches_jax(n, v, hd, ignored, dtype):
    h, w, labels, g_lse, g_lab = _inputs(n, v, hd, seed=n + v, ignored=ignored)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def j_fn(h_, w_):
        lse, lab = j_ce_stats_vh(h_, w_, jnp.asarray(labels))
        return jnp.sum(lse * g_lse) + jnp.sum(lab * g_lab), (lse, lab)

    (_, (jlse, jlab)), (jdh, jdw) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    th = torch.tensor(h).to(tdt).requires_grad_(True)
    tw = torch.tensor(w).to(tdt).requires_grad_(True)
    tlse, tlab = fc.ce_stats_vh(th, tw, torch.tensor(labels))
    ((tlse * torch.tensor(g_lse)).sum() + (tlab * torch.tensor(g_lab)).sum()).backward()
    assert tlse.dtype == tlab.dtype == torch.float32
    assert th.grad.dtype == tw.grad.dtype == tdt
    stat_tol = F32_TOL if dtype == "float32" else 1e-4
    _close(tlse.detach().numpy(), jlse, stat_tol, "lse")
    _close(tlab.detach().numpy(), jlab, stat_tol, "label_logit")
    grad_tol = F32_TOL if dtype == "float32" else BF16_RTOL
    _close(th.grad.float().numpy(), np.asarray(jdh, np.float32), grad_tol, "dh")
    _close(tw.grad.float().numpy(), np.asarray(jdw, np.float32), grad_tol, "dw")
    if ignored:
        dropped = labels == 0
        assert np.abs(th.grad.float().numpy()[dropped & (g_lse == 0)]).max() == 0.0


@pytest.mark.parametrize("tied", [True, False])
def test_ce_loss_fused_matches_jax(tied):
    """ce_loss(mode="fused") at H = 128, with ignored labels and a global
    denominator; the tied head arrives as embed.T, the untied one as (H, V)."""
    rng = np.random.default_rng(7)
    b, l, hd, v = 2, 40, 128, 300
    h = rng.standard_normal((b, l, hd), dtype=np.float32)
    w = (rng.standard_normal((v, hd) if tied else (hd, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (b, l)).astype(np.int32)
    labels[rng.random((b, l)) < 0.25] = -100
    weights = np.where(labels != -100, rng.random((b, l)), 0).astype(np.float32)
    denom = float(weights.sum()) * 1.5

    def j_fn(h_, w_):
        head = w_.T if tied else w_
        loss, sum_ce, n = jce.ce_loss(h_, head, jnp.asarray(labels), jnp.asarray(weights),
                                      denom, jce.CELossConfig(mode="fused", chunk_size=16))
        return loss, (sum_ce, n)

    (jl, (js, jn)), (jgh, jgw) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h).requires_grad_(True)
    tw = torch.tensor(w).requires_grad_(True)
    tl, ts, tn = tce.ce_loss(th, tw.T if tied else tw, torch.tensor(labels),
                             torch.tensor(weights), denom,
                             tce.CELossConfig(mode="fused", chunk_size=16))
    tl.backward()
    _close(tl.item(), jl, F32_TOL)
    _close(ts.item(), js, F32_TOL)
    assert int(tn) == int(jn)
    _close(th.grad.numpy(), jgh, F32_TOL, "dh")
    _close(tw.grad.numpy(), jgw, F32_TOL, "dw")


def test_fused_mode_routes_to_chunk_below_128(monkeypatch):
    """hidden % 128 != 0 takes the chunk path in both packages (JAX's
    routing rule), with the same values as mode="chunk"."""
    def refuse(*a, **k):
        raise AssertionError("the fused path ran at H = 64")

    monkeypatch.setattr(jce, "_fused_ce", refuse)
    monkeypatch.setattr(tce, "_fused_ce", refuse)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((1, 50, 64), dtype=np.float32)
    w = (rng.standard_normal((64, 90)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 90, (1, 50)).astype(np.int32)
    weights = np.ones((1, 50), np.float32)
    out = {}
    for mode in ("fused", "chunk"):
        cfg = dict(mode=mode, chunk_size=16)
        jl, _, _ = jce.ce_loss(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                               jnp.asarray(weights), 50.0, jce.CELossConfig(**cfg))
        tl, _, _ = tce.ce_loss(torch.tensor(h), torch.tensor(w), torch.tensor(labels),
                               torch.tensor(weights), 50.0, tce.CELossConfig(**cfg))
        out[mode] = (float(jl), tl.item())
    assert out["fused"] == out["chunk"]
    _close(out["fused"][1], out["fused"][0], F32_TOL)


def test_cpu_wrappers_check_shapes_and_count_no_launch():
    h, w, labels, g_lse, g_lab = (torch.tensor(a) for a in _inputs(8, 50, 128, seed=1))
    fc.reset_launches()
    lse, _ = fc.ce_fwd(h, w, labels)
    fc.ce_dh(h, w, labels, lse, g_lse, g_lab)
    fc.ce_dw(h, w, labels, lse, g_lse, g_lab)
    assert (fc.ce_fwd.launches, fc.ce_dh.launches, fc.ce_dw.launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="do not fit"):
        fc.ce_fwd(h, w[:, :64], labels)
    with pytest.raises(ValueError, match="do not fit"):
        fc.ce_fwd(h, w, labels[:5])
