"""GLM-5.2's DSA ops and module in the PyTorch port against the JAX package,
on the CPU: the block-sparse attention (the plain versions of kernels #14
and #15, which the wrappers run for CPU tensors) against JAX's Pallas
kernels in interpret mode, the block and token selection, the lightning
indexer ops of `ops/sparse_mla.py`, and `dsa_forward` at both
granularities with every parameter's gradient.

Inputs are f32 from a seeded numpy generator, handed to both packages;
the JAX sides run under `jax.jit` (eager dispatch is ~10x slower here).
Both compute in f32 and differ only in summation order, so values and
gradients are held to 3e-5 (the bound of tests/ops/test_block_sparse.py),
relative and against each array's largest entry: rtol 3e-5 and atol
3e-5 * max(1, max |want|). Selections are compared integer for integer,
ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.module import dsa as jdsa
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.module.rope import rope_cos_sin as j_rope
from xtuner_tpu.ops import sparse_mla as jsm
from xtuner_tpu.ops.attention import block_sparse as jbs
from xtuner_tpu.parallel.sharding import NULL_SHARD_CTX
from xtuner_tpu_torch.module import dsa as tdsa
from xtuner_tpu_torch.module import mla as tmla
from xtuner_tpu_torch.module.params import tree_map, tree_paths
from xtuner_tpu_torch.module.rope import rope_cos_sin as t_rope
from xtuner_tpu_torch.ops import sparse_mla as tsm
from xtuner_tpu_torch.ops.attention import block_sparse as tbs

TOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max(initial=0))),
                               err_msg=msg)


# ------------------------------------------------------ block-sparse attention
L, BLOCK = 256, 64
NQ = L // BLOCK


def _segments():
    """Two documents and a padded tail."""
    seg = np.zeros((1, L), np.int32)
    seg[0, :120] = 1
    seg[0, 120:230] = 2
    return seg


def _all_causal_idx():
    idx = np.full((1, NQ, NQ), -1, np.int32)
    for i in range(NQ):
        idx[0, i, NQ - (i + 1):] = np.arange(i + 1)  # ascending, -1 slots first
    return idx


def _subset_idx():
    """3 slots of 4 blocks: empty slots in front, block 0 skipped by the
    last q-block, a gap in q-block 2's choice."""
    return np.array([[[-1, -1, 0], [-1, 0, 1], [-1, 0, 2], [1, 2, 3]]], np.int32)


@pytest.mark.parametrize("sel,hq,hkv,d,dv", [
    ("all_causal", 4, 2, 32, 32),
    ("subset", 4, 2, 32, 32),
    ("subset", 4, 4, 32, 32),
    ("subset", 4, 2, 32, 16),
])
def test_block_sparse_attention_matches_jax(sel, hq, hkv, d, dv):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, L, hq, d), dtype=np.float32)
    k = rng.standard_normal((1, L, hkv, d), dtype=np.float32)
    v = rng.standard_normal((1, L, hkv, dv), dtype=np.float32)
    g = rng.standard_normal((1, L, hq, dv), dtype=np.float32)
    seg = _segments()
    idx = _all_causal_idx() if sel == "all_causal" else _subset_idx()

    @jax.jit
    def j_fn(q_, k_, v_, g_):
        (out, mass), vjp = jax.vjp(
            lambda *a: jbs.block_sparse_attention(*a, jnp.asarray(idx), jnp.asarray(seg),
                                                  block=BLOCK, return_block_mass=True,
                                                  interpret=True), q_, k_, v_)
        return out, mass, vjp((g_, jnp.zeros_like(mass)))

    j_out, j_mass, (j_dq, j_dk, j_dv) = j_fn(*map(jnp.asarray, (q, k, v, g)))

    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    t_out, t_mass = tbs.block_sparse_attention(tq, tk, tv, _t(idx), _t(seg), block=BLOCK,
                                               return_block_mass=True)
    (t_out * _t(g)).sum().backward()
    valid = seg[0] != 0
    _close(t_out, j_out, "out")
    _close(t_mass[:, valid], np.asarray(j_mass)[:, valid], "mass")
    assert (t_mass[:, ~valid] == 0).all()
    for name, got, want in (("dq", tq.grad, j_dq), ("dk", tk.grad, j_dk), ("dv", tv.grad, j_dv)):
        _close(got, want, name)


def test_block_sparse_rows_with_nothing_visible():
    """Padding rows: out 0, lse 1e30, mass 0 (the kernels' contract)."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.standard_normal((1, L, 2, 16), dtype=np.float32)) for _ in range(3))
    out, lse, mass = tbs.block_sparse_fwd(q, k, v, _t(_subset_idx()), _t(_segments()), 0.25,
                                          BLOCK)
    pad = _segments()[0] == 0
    assert (out[:, pad] == 0).all() and (mass[:, pad] == 0).all()
    assert (lse[..., pad] == tbs.BIG_LSE).all() and torch.isfinite(lse[..., ~pad]).all()


# ------------------------------------------------------------------ selection
def _tied_scores(rng, b, l):
    """Small integers (many exact ties), -inf above the diagonal."""
    s = rng.integers(0, 3, (b, l, l)).astype(np.float32)
    return np.where(np.tril(np.ones((l, l), bool))[None], s, -np.inf).astype(np.float32)


@pytest.mark.parametrize("num_sel", [2, 3, 6])
def test_block_selection_matches_jax_with_ties(num_sel):
    rng = np.random.default_rng(num_sel)
    pooled = rng.integers(0, 3, (2, 5, 5)).astype(np.float32)
    pooled[0, 3, 1] = -np.inf  # a block nothing in it can see
    got = tbs.select_from_blockmax(_t(pooled), num_sel)
    want = jbs.select_from_blockmax(jnp.asarray(pooled), num_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    scores = _tied_scores(rng, 2, 64)
    got = tbs.select_key_blocks(_t(scores), 16, num_sel)
    want = jbs.select_key_blocks(jnp.asarray(scores), 16, num_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_select_matches_jax_with_ties():
    scores = _tied_scores(np.random.default_rng(7), 2, 24)
    for k in (1, 5, 24):
        got = tsm.topk_select(_t(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jsm.topk_select(
            jnp.asarray(scores), k)))


# -------------------------------------------------------------- sparse_mla ops
def _indexer_inputs(rng, b=2, l=64, hi=2, di=8):
    q = rng.standard_normal((b, l, hi, di), dtype=np.float32)
    k = rng.standard_normal((b, l, hi, di), dtype=np.float32)
    w = rng.standard_normal((b, l, hi), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    seg[0, :40], seg[0, 40:] = 1, 2
    seg[1, :50], seg[1, 50:60] = 1, 2  # and 4 padding tokens
    return q, k, w, seg


def _finite_sum(x, c, xp):
    return (xp.where(xp.isfinite(x), x, 0.0) * c).sum()


def test_indexer_scores_matches_jax():
    rng = np.random.default_rng(3)
    q, k, w, seg = _indexer_inputs(rng)
    c = rng.standard_normal((2, 64, 64), dtype=np.float32)
    want, vjp = jax.vjp(lambda *a: jsm.indexer_scores(*a, jnp.asarray(seg)),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(w))
    tq, tk, tw = (_t(a).requires_grad_(True) for a in (q, k, w))
    got = tsm.indexer_scores(tq, tk, tw, _t(seg))
    np.testing.assert_array_equal(np.isfinite(got.detach().numpy()), np.isfinite(want))
    fin = np.isfinite(np.asarray(want))
    _close(got.detach().numpy()[fin], np.asarray(want)[fin])
    cot = np.where(fin, c, 0).astype(np.float32)
    (got.masked_fill(~torch.isfinite(got), 0) * _t(cot)).sum().backward()
    for name, g_t, g_j in zip("qkw", (tq.grad, tk.grad, tw.grad), vjp(jnp.asarray(cot))):
        _close(g_t, g_j, name)


def test_indexer_block_stats_matches_jax():
    """Values of pooled_lse and blockmax, and the gradients into q_idx, k_idx
    and w through a loss on pooled_lse."""
    rng = np.random.default_rng(4)
    q, k, w, seg = _indexer_inputs(rng)
    block = 16
    c = rng.standard_normal((2, 64, 64 // block), dtype=np.float32)

    def j_loss(q_, k_, w_):
        pooled, _ = jsm.indexer_block_stats(q_, k_, w_, jnp.asarray(seg), block)
        return _finite_sum(pooled, jnp.asarray(c), jnp)

    j_pooled, j_bm = jax.jit(jsm.indexer_block_stats, static_argnums=4)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(w), jnp.asarray(seg), block)
    j_grads = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                           jnp.asarray(w))
    tq, tk, tw = (_t(a).requires_grad_(True) for a in (q, k, w))
    pooled, bm = tsm.indexer_block_stats(tq, tk, tw, _t(seg), block)
    for got, want in ((pooled.detach().numpy(), j_pooled), (bm.detach().numpy(), j_bm)):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        _close(got[np.isfinite(want)], want[np.isfinite(want)])
    _finite_sum(pooled, _t(c), torch).backward()
    for name, g_t, g_j in zip("qkw", (tq.grad, tk.grad, tw.grad), j_grads):
        assert torch.isfinite(g_t).all(), name
        _close(g_t, g_j, name)


def test_sparse_gather_attention_and_kl_loss_match_jax():
    rng = np.random.default_rng(5)
    b, l, hq, hkv, d, dv, kk = 1, 24, 4, 2, 8, 6, 5
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, dv), dtype=np.float32)
    idx = rng.integers(0, l, (b, l, kk)).astype(np.int32)
    sel = rng.standard_normal((b, l, kk)).astype(np.float32)
    sel[rng.random((b, l, kk)) < 0.3] = -np.inf
    sel[0, 3] = -np.inf  # a row with no valid slot
    valid_tok = (rng.random((b, l)) < 0.8).astype(np.float32)
    c = rng.standard_normal((b, l, hq, dv), dtype=np.float32)

    def j_fn(q_, k_, v_, s_):
        out, probs = jsm.sparse_gather_attention(q_, k_, v_, jnp.asarray(idx), s_,
                                                 return_probs=True)
        kl = jsm.indexer_kl_loss(s_, probs, jnp.asarray(valid_tok))
        return (out * jnp.asarray(c)).sum() + kl, (out, probs, kl)

    (_, (j_out, j_probs, j_kl)), j_grads = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, (q, k, v, sel)))
    tq, tk, tv, ts = (_t(a).requires_grad_(True) for a in (q, k, v, sel))
    out, probs = tsm.sparse_gather_attention(tq, tk, tv, _t(idx), ts, return_probs=True)
    kl = tsm.indexer_kl_loss(ts, probs, _t(valid_tok))
    ((out * _t(c)).sum() + kl).backward()
    _close(out, j_out, "out")
    _close(probs, j_probs, "probs")
    _close(kl, j_kl, "kl")
    for name, g_t, g_j in zip(("q", "k", "v", "select_scores"),
                              (tq.grad, tk.grad, tv.grad, ts.grad), j_grads):
        _close(g_t, g_j, name)
    _close(tsm.indexer_kl_loss(ts, probs), jsm.indexer_kl_loss(jnp.asarray(sel), j_probs))


# ------------------------------------------------------------------ dsa_forward
HIDDEN = 32


def _tiny_dsa(jax_side: bool, **kw):
    fields = dict(num_attention_heads=2, q_lora_rank=16, kv_lora_rank=8,
                  qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=6,
                  index_n_heads=2, index_head_dim=8, index_top_k=8)
    fields.update(kw)
    return jdsa.DSAConfig(**fields) if jax_side else tdsa.DSAConfig(**fields)


def _dsa_inputs(rng, l):
    x = rng.standard_normal((1, l, HIDDEN), dtype=np.float32)
    seg = np.ones((1, l), np.int32)
    seg[0, l // 2 + 3:] = 2
    seg[0, l - 5:] = 0
    pos = np.zeros((1, l), np.int32)
    for s_ in (1, 2):
        n = int((seg == s_).sum())
        pos[seg == s_] = np.arange(n)
    return x, seg, pos


@pytest.mark.parametrize("granularity,l,extra", [
    ("token", 24, {}),
    ("block", 64, {"index_block": 16, "index_top_k": 32}),
])
def test_dsa_forward_and_every_grad_match_jax(granularity, l, extra):
    jcfg = _tiny_dsa(True, select_granularity=granularity, **extra)
    tcfg = _tiny_dsa(False, select_granularity=granularity, **extra)
    jparams = j_init_params(jdsa.dsa_param_specs(jcfg, HIDDEN), jax.random.key(1))
    rng = np.random.default_rng(6)
    x, seg, pos = _dsa_inputs(rng, l)
    c = rng.standard_normal((1, l, HIDDEN), dtype=np.float32)
    cos, sin = j_rope(jnp.asarray(pos), jcfg.qk_rope_head_dim, 10000.0)

    def j_fn(p):
        out, sel, idx_loss = jdsa.dsa_forward(p, jcfg, jnp.asarray(x), cos, sin,
                                              jnp.asarray(seg), NULL_SHARD_CTX)
        return (out * jnp.asarray(c)).sum() + idx_loss, (out, sel, idx_loss)

    (_, (j_out, j_sel, j_idx)), j_grads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jparams)

    tparams = tree_map(lambda a: _t(np.asarray(a)).requires_grad_(True), jparams)
    tcos, tsin = t_rope(_t(pos), tcfg.qk_rope_head_dim, 10000.0)
    out, sel, idx_loss = tdsa.dsa_forward(tparams, tcfg, _t(x), tcos, tsin, _t(seg))
    ((out * _t(c)).sum() + idx_loss).backward()
    np.testing.assert_array_equal(sel.numpy(), np.asarray(j_sel))
    _close(out, j_out, "out")
    _close(idx_loss, j_idx, "idx_loss")
    assert float(idx_loss.detach()) > 0
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, j_grads)))
    tleaves = dict(tree_paths(tparams))
    assert sorted(jleaves) == sorted(tleaves)
    for path, leaf in tleaves.items():
        assert leaf.grad is not None, path
        _close(leaf.grad, jleaves[path], ".".join(path))
    for name in ("idx_q_proj", "idx_k_proj", "idx_w_proj"):
        assert float(tparams[name]["w"].grad.abs().sum()) > 0, name


def test_dsa_block_path_with_every_block_is_the_dense_limit():
    """index_top_k >= L: every causal block is selected, so the block path
    attends to what the token path's dense limit attends to (JAX pins the
    same with test_dsa_block_granularity against plain MLA)."""
    l = 64
    rng = np.random.default_rng(8)
    x, seg, pos = _dsa_inputs(rng, l)
    tok = _tiny_dsa(False, index_top_k=l)
    blk = _tiny_dsa(False, index_top_k=l, select_granularity="block", index_block=16)
    jparams = j_init_params(jdsa.dsa_param_specs(_tiny_dsa(True), HIDDEN), jax.random.key(2))
    params = tree_map(lambda a: _t(np.asarray(a)), jparams)
    cos, sin = t_rope(_t(pos), tok.qk_rope_head_dim, 10000.0)
    out_tok, _, _ = tdsa.dsa_forward(params, tok, _t(x), cos, sin, _t(seg))
    out_blk, sel, _ = tdsa.dsa_forward(params, blk, _t(x), cos, sin, _t(seg))
    valid = seg[0] != 0
    _close(out_blk[:, valid], out_tok[:, valid].numpy())
    assert sel.shape == (1, l // 16, l // 16)


def test_unported_mla_and_dsa_paths_raise():
    cfg = _tiny_dsa(False)
    with pytest.raises(NotImplementedError, match=r"\[mla\]"):
        tmla.mla_forward({}, cfg, None, None, None, None)
    with pytest.raises(NotImplementedError, match=r"\[serve-rest\]"):
        tdsa.dsa_cached_forward({}, cfg, None, None, None, None, None, 0)
    assert tmla.MLAConfig(num_attention_heads=4).head_dim == 64  # the rope dim
    assert cfg.qk_head_dim == 12 and cfg.num_key_value_heads == 2
    x = torch.arange(8.0).reshape(1, 8)
    assert tmla._deinterleave_rope(x).tolist() == [[0, 2, 4, 6, 1, 3, 5, 7]]
