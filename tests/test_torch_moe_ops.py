"""MoE ops of the PyTorch port against the JAX package: the grouped GEMMs
(`ops/bf16_grouped.py`), permute / unpermute (`ops/moe.py`), the greedy
router, the balancing and z losses, and the whole expert MLP
(`module/moe_layer.py::moe_mlp_forward`).

On the CPU the port's grouped-GEMM wrappers run their plain versions; the
JAX Pallas grouped GEMMs run in interpret mode, as the JAX package's own
tests run them. Inputs are numpy arrays from a seed, in fp32, so the two
sides differ only in summation order: tolerance 1e-5 absolute and relative;
2e-5 where a value is a sum over 256 or more products, and 1e-4 absolute
for weight gradients, sums over hundreds of rows with entries up to ~60.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.loss import moe_loss as jloss
from xtuner_tpu.module import moe_layer as jmoe_layer
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.ops import bf16_grouped as jbg
from xtuner_tpu.ops import moe as jmoe
from xtuner_tpu_torch.loss import moe_loss as tloss
from xtuner_tpu_torch.module import moe_layer as tmoe_layer
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.ops import bf16_grouped as tbg
from xtuner_tpu_torch.ops import moe as tmoe

TOL = 1e-5
SUM_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _grouped(m, k, n, sizes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * 0.05).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32)


# M = 1024 over 4 experts: one empty expert, sizes not aligned to any block
SIZES = [[300, 0, 517, 207], [0, 1024, 0, 0]]


@pytest.mark.parametrize("sizes", SIZES)
def test_grouped_gemm_nn_nt_match_jax(sizes):
    x, w, gs = _grouped(1024, 256, 128, sizes)
    want = jbg.grouped_gemm_bf16(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                                 interpret=True)
    got = tbg.grouped_gemm_bf16(_t(x), _t(w), _t(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SUM_TOL, rtol=SUM_TOL)
    # the plain grouped GEMM against the JAX `ragged_dot` slot
    want = jmoe.grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    got = tmoe.grouped_gemm(_t(x), _t(w), _t(gs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SUM_TOL, rtol=SUM_TOL)
    dy = np.random.default_rng(1).standard_normal((1024, 128), dtype=np.float32)
    want = jbg.grouped_gemm_bf16(jnp.asarray(dy), jnp.asarray(w), jnp.asarray(gs),
                                 transpose_rhs=True, interpret=True)
    got = tbg.grouped_gemm_bf16(_t(dy), _t(w), _t(gs), transpose_rhs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SUM_TOL, rtol=SUM_TOL)


@pytest.mark.parametrize("sizes", SIZES)
def test_grouped_gemm_dw_matches_jax(sizes):
    x, _, gs = _grouped(1024, 256, 128, sizes)
    dy = np.random.default_rng(2).standard_normal((1024, 128), dtype=np.float32)
    want = jbg.grouped_gemm_bf16_dw(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs), 4,
                                    interpret=True)
    got = tbg.grouped_gemm_bf16_dw(_t(x), _t(dy), _t(gs), 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=SUM_TOL)
    for e, n in enumerate(sizes):
        if n == 0:
            assert (got[e] == 0).all()


def test_grouped_linear_grads_match_jax():
    x, w, gs = _grouped(1111, 256, 128, [400, 0, 600, 111], seed=3)
    co = np.random.default_rng(4).standard_normal((1111, 128), dtype=np.float32)

    def j_loss(x_, w_):
        return jnp.sum(jbg.bf16_grouped_linear(x_, w_, jnp.asarray(gs), True) * co)

    jgx, jgw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    (tbg.bf16_grouped_linear(tx, tw, _t(gs)) * _t(co)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=SUM_TOL, rtol=SUM_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-4, rtol=SUM_TOL)


def _routing(n=48, k=3, e=6, h=16, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h), dtype=np.float32)
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k), dtype=np.float32)
    return x, idx, w


def test_permute_matches_jax():
    x, idx, w = _routing()
    j = jmoe.permute(jnp.asarray(x), jnp.asarray(idx), 6, topk_weights=jnp.asarray(w))
    t = tmoe.permute(_t(x), _t(idx).long(), 6, topk_weights=_t(w))
    np.testing.assert_array_equal(t.group_sizes.numpy(), np.asarray(j.group_sizes))
    np.testing.assert_array_equal(t.token_idx.numpy(), np.asarray(j.token_idx))
    np.testing.assert_array_equal(t.inv_pos.numpy(), np.asarray(j.inv_pos))
    np.testing.assert_array_equal(t.sorted_tokens.numpy(), np.asarray(j.sorted_tokens))
    np.testing.assert_array_equal(tmoe.histogram(_t(idx), 6).numpy(),
                                  np.asarray(jmoe.histogram(jnp.asarray(idx), 6)))


def test_permute_unpermute_grads_match_jax():
    x, idx, w = _routing(seed=6)
    scale = np.random.default_rng(7).standard_normal((x.shape[0] * 3, 1), dtype=np.float32)
    co = np.random.default_rng(8).standard_normal(x.shape, dtype=np.float32)

    def j_fn(x_, w_):
        info = jmoe.permute(x_, jnp.asarray(idx), 6, topk_weights=w_)
        out = jmoe.unpermute(info.sorted_tokens * scale, info, x_.shape[0])
        return jnp.sum(out * co), out

    (_, jout), (jgx, jgw) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    info = tmoe.permute(tx, _t(idx).long(), 6, topk_weights=tw)
    out = tmoe.unpermute(info.sorted_tokens * _t(scale), info, x.shape[0])
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scoring,norm", [("softmax", True), ("sigmoid", False)])
def test_greedy_route_matches_jax(scoring, norm):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((40, 32), dtype=np.float32)
    p = {"w": rng.standard_normal((32, 8), dtype=np.float32) * 0.3,
         "b": rng.standard_normal((8,), dtype=np.float32) * 0.1}
    jc = jrouter.GreedyRouterConfig(scoring_func=scoring, norm_topk_prob=norm,
                                    routed_scaling_factor=1.5, router_bias=True)
    tc = trouter.GreedyRouterConfig(scoring_func=scoring, norm_topk_prob=norm,
                                    routed_scaling_factor=1.5, router_bias=True)
    j = jrouter.greedy_route(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x), 3)
    t = trouter.greedy_route({k: _t(v) for k, v in p.items()}, tc, _t(x), 3)
    np.testing.assert_array_equal(t.topk_idx.numpy(), np.asarray(j.topk_idx))
    for a, b in ((t.topk_weights, j.topk_weights), (t.logits, j.logits), (t.probs, j.probs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_noaux_router_and_replay_raise():
    """`route` dispatches to the noaux router as JAX's does
    (`tests/test_torch_moe_noaux.py` holds it to JAX in depth). Replay is
    ported (`tests/test_torch_gpt_oss_train.py` holds it to JAX): forced
    ids give JAX's routing here too, and what still raises is a forced-id
    tensor that is not (N, K)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((40, 32), dtype=np.float32)
    p = {"w": rng.standard_normal((32, 8), dtype=np.float32) * 0.3,
         "e_score_correction_bias": rng.standard_normal((8,), dtype=np.float32) * 0.1}
    j = jrouter.route(jax.tree.map(jnp.asarray, p), jrouter.NoAuxRouterConfig(n_group=2),
                      jnp.asarray(x), 3)
    t = trouter.route({k: _t(v) for k, v in p.items()}, trouter.NoAuxRouterConfig(n_group=2),
                      _t(x), 3)
    np.testing.assert_array_equal(t.topk_idx.numpy(), np.asarray(j.topk_idx))
    for a, b in ((t.topk_weights, j.topk_weights), (t.probs, j.probs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    forced = np.where(np.arange(40)[:, None] % 2 == 0, 0, -1).astype(np.int32)
    jf = jrouter.route(jax.tree.map(jnp.asarray, p), jrouter.GreedyRouterConfig(),
                       jnp.asarray(x), 1, forced_idx=jnp.asarray(forced))
    tf = trouter.route({k: _t(v) for k, v in p.items()}, trouter.GreedyRouterConfig(), _t(x), 1,
                       forced_idx=_t(forced))
    np.testing.assert_array_equal(tf.topk_idx.numpy(), np.asarray(jf.topk_idx))
    np.testing.assert_allclose(tf.topk_weights.numpy(), np.asarray(jf.topk_weights),
                               atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="forced_idx"):
        trouter.route({k: _t(v) for k, v in p.items()}, trouter.GreedyRouterConfig(), _t(x), 1,
                      forced_idx=torch.zeros(40, 2))


def test_balancing_and_z_loss_match_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((50, 8), dtype=np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    valid = rng.random(50) > 0.2

    def j_fn(pr, lg):
        bal, counts = jloss.balancing_loss(pr, jnp.asarray(idx), jnp.asarray(valid), 8, 2)
        return bal + jloss.z_loss(lg, jnp.asarray(valid)), (bal, counts)

    (jv, (jbal, jcounts)), (jgp, jgl) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(probs), jnp.asarray(logits))
    tp, tl = _t(probs).requires_grad_(True), _t(logits).requires_grad_(True)
    tbal, tcounts = tloss.balancing_loss(tp, _t(idx).long(), _t(valid), 8, 2)
    tv = tbal + tloss.z_loss(tl, _t(valid))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tbal.item(), float(jbal), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), atol=TOL, rtol=TOL)


def _expert_params(h, f, e, seed):
    rng = np.random.default_rng(seed)
    experts = {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
               for name, shape in (("gate_proj", (e, h, f)), ("up_proj", (e, h, f)),
                                   ("down_proj", (e, f, h)))}
    router = {"w": (rng.standard_normal((h, e)) * 0.3).astype(np.float32)}
    return experts, router


def test_moe_mlp_forward_matches_jax():
    h, f, e, k = 128, 64, 8, 2
    experts, router = _expert_params(h, f, e, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 24, h), dtype=np.float32)
    co = np.random.default_rng(13).standard_normal(x.shape, dtype=np.float32)
    jcfg = jrouter.GreedyRouterConfig()

    def j_fn(ex, ro, x_):
        out, r, load = jmoe_layer.moe_mlp_forward(ex, ro, jcfg, x_, num_experts=e, top_k=k,
                                                  compute_dtype=jnp.float32, gemm_impl="auto")
        return jnp.sum(out * co), (out, load)

    (_, (jout, jload)), jgrads = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, experts), jax.tree.map(jnp.asarray, router), jnp.asarray(x))
    tex = {n: _t(v).requires_grad_(True) for n, v in experts.items()}
    tro = {"w": _t(router["w"]).requires_grad_(True)}
    tx = _t(x).requires_grad_(True)
    out, _, load = tmoe_layer.moe_mlp_forward(tex, tro, trouter.GreedyRouterConfig(), tx,
                                              num_experts=e, top_k=k,
                                              compute_dtype=torch.float32)
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    jex, jro, jx = jgrads
    for n in experts:
        np.testing.assert_allclose(tex[n].grad.numpy(), np.asarray(jex[n]), atol=TOL,
                                   rtol=TOL, err_msg=n)
    # the router gradient sums over every token and expert, entries up to
    # ~10: the bound is 1e-5 of its largest entry
    jw = np.asarray(jro["w"])
    np.testing.assert_allclose(tro["w"].grad.numpy(), jw, atol=TOL * np.abs(jw).max(), rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), atol=TOL, rtol=TOL)


def test_moe_mlp_unported_options_raise():
    experts, router = _expert_params(16, 8, 4, seed=14)
    args = ({n: _t(v) for n, v in experts.items()}, {"w": _t(router["w"])},
            trouter.GreedyRouterConfig(), torch.zeros(1, 4, 16))
    with pytest.raises(NotImplementedError, match="parallelism"):
        tmoe_layer.moe_mlp_forward(*args, num_experts=4, top_k=1, dispatcher="a2a")
    # clipped experts and the gelus are ported (tests/test_torch_gpt_oss.py
    # and tests/test_torch_qwen3_vl.py hold them to JAX); another activation
    # still raises
    with pytest.raises(NotImplementedError, match="leaf-ops"):
        tmoe_layer.moe_mlp_forward(*args, num_experts=4, top_k=1, act="relu")
