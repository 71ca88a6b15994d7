"""The fused MoE expert MLP of the PyTorch port (TPU kernel #16 and its
VJP, `ops/fused_moe_mlp.py`) and the MoE layer's fused branch
(`XTUNER_FUSED_MLP`) against the JAX package.

On the CPU the port's wrappers run their plain versions; JAX's Pallas
kernels run in interpret mode, as the JAX package's own tests run them
(`tests/ops/test_fused_moe_mlp.py`, whose shapes these are). Inputs are
numpy arrays from a seed, in bf16. out and gu are bf16 roundings of the
same f32 sums taken in another order: within one bf16 step (2^-8) of the
largest entry. The gradients pass through two more bf16 roundings (the
activation's gradient and dhidden): within 1e-2 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.module import moe_layer as jmoe_layer
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.ops import fused_moe_mlp as jfm
from xtuner_tpu_torch.module import moe_layer as tmoe_layer
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.ops import fused_moe_mlp as tfm
from xtuner_tpu_torch.ops.bf16_grouped import bf16_grouped_linear

FWD_RTOL = 2.0 ** -8
GRAD_RTOL = 1e-2


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
    return torch.from_numpy(np.array(a, np.float32)).bfloat16()


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _mk(m, h, f, e, seed=0, skew=False):
    """The JAX test's inputs (`tests/ops/test_fused_moe_mlp.py::_mk`), as f32
    numpy arrays rounded to bf16."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    x = bf(rng.normal(size=(m, h)))
    w_gu = bf(rng.normal(size=(e, h, 2 * f)) * 0.05)
    w_dn = bf(rng.normal(size=(e, f, h)) * 0.05)
    if skew:  # empty experts and one dominant group
        raw = np.zeros(e, np.int64)
        raw[1] = m - (e - 3)
        raw[3:e] = 1
        raw[1] += m - raw.sum()
    else:
        raw = rng.multinomial(m, np.ones(e) / e)
    assert raw.sum() == m
    return x, w_gu, w_dn, raw.astype(np.int32)


def _close(got, want, rtol, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{msg}: {err} > {rtol}"


SHAPES = [  # (m, h, f, e, seed, skew): the JAX tests' shapes
    (1536, 256, 128, 8, 0, False),
    (1536, 256, 128, 8, 0, True),   # empty experts, one dominant group
    (1024, 256, 128, 4, 1, False),
    (700, 256, 128, 4, 3, False),   # M not a multiple of JAX's 256-row block
]


@pytest.mark.parametrize("m,h,f,e,seed,skew", SHAPES)
def test_fused_forward_matches_jax(m, h, f, e, seed, skew):
    x, w_gu, w_dn, gs = _mk(m, h, f, e, seed, skew)
    jx, jgu, jdn = (jnp.asarray(a, jnp.bfloat16) for a in (x, w_gu, w_dn))
    want_out, res = jax.jit(jfm._fmlp_fwd, static_argnums=4)(jx, jgu, jdn, jnp.asarray(gs),
                                                            True)
    want_gu = res[3]
    tfm.reset_launches()
    out, gu = tfm.fused_moe_mlp_fwd(_t(x), _t(w_gu), _t(w_dn), torch.from_numpy(gs))
    assert out.dtype == gu.dtype == torch.bfloat16
    _close(out, want_out, FWD_RTOL, "out")
    _close(gu, want_gu, FWD_RTOL, "gu")
    assert tfm.fused_moe_mlp_fwd.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("m,h,f,e,seed,skew", [SHAPES[1], SHAPES[3]])
def test_fused_grads_match_jax(m, h, f, e, seed, skew):
    x, w_gu, w_dn, gs = _mk(m, h, f, e, seed, skew)
    cot = np.random.default_rng(2).normal(size=(m, h)).astype(np.float32)
    jgs = jnp.asarray(gs)

    def j_loss(x_, wg_, wd_):
        return jnp.sum(jfm.fused_moe_mlp(x_, wg_, wd_, jgs, True).astype(jnp.float32) * cot)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w_gu, w_dn)))
    leaves = [_t(a).requires_grad_(True) for a in (x, w_gu, w_dn)]
    (tfm.fused_moe_mlp(*leaves, torch.from_numpy(gs)).float() * torch.from_numpy(cot)) \
        .sum().backward()
    for got, w, name in zip(leaves, want, ("dx", "dw_gu", "dw_dn")):
        assert got.grad.dtype == torch.bfloat16, name
        _close(got.grad, w, GRAD_RTOL, name)


def test_fused_equals_the_decomposed_path():
    """As JAX's test holds its kernel to its decomposed path: the fused
    forward equals two grouped GEMMs with silu(gate) * up between them bit
    for bit (both round gu to bf16 before the activation)."""
    x, w_gu, w_dn, gs = _mk(700, 256, 128, 4, seed=3)
    tx, tgu, tdn, tgs = _t(x), _t(w_gu), _t(w_dn), torch.from_numpy(gs)
    gu = bf16_grouped_linear(tx, tgu, tgs)
    hidden = (torch.nn.functional.silu(gu[:, :128].float()) * gu[:, 128:].float()).bfloat16()
    want = bf16_grouped_linear(hidden, tdn, tgs)
    assert torch.equal(tfm.fused_moe_mlp(tx, tgu, tdn, tgs), want)


def test_plain_rows_past_the_last_group_are_zero():
    x, w_gu, w_dn, _ = _mk(300, 128, 64, 3, seed=4)
    gs = torch.tensor([100, 0, 150], dtype=torch.int32)
    out, gu = tfm.fused_moe_mlp_plain(_t(x), _t(w_gu), _t(w_dn), gs)
    assert out.shape == (300, 128) and gu.shape == (300, 128)
    assert (out[250:] == 0).all() and (gu[250:] == 0).all()


@pytest.mark.parametrize("switch", ["1", "0"])
def test_moe_mlp_forward_fused_branch_matches_jax(monkeypatch, switch):
    """`moe_mlp_forward` with `XTUNER_FUSED_MLP` set against JAX's with
    `gemm_impl="pallas"` and the same switch (read when JAX traces), bf16
    compute: the output and every gradient. With the switch at "0" both
    take the decomposed grouped-GEMM path."""
    monkeypatch.setenv("XTUNER_FUSED_MLP", switch)
    h, f, e, k = 256, 128, 4, 2
    rng = np.random.default_rng(21)
    experts = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
               for n, s in (("gate_proj", (e, h, f)), ("up_proj", (e, h, f)),
                            ("down_proj", (e, f, h)))}
    router = {"w": (rng.standard_normal((h, e)) * 0.3).astype(np.float32)}
    x = rng.standard_normal((1, 160, h)).astype(np.float32)
    co = rng.standard_normal(x.shape).astype(np.float32)

    def j_fn(ex, ro, x_):
        out, _, load = jmoe_layer.moe_mlp_forward(
            ex, ro, jrouter.GreedyRouterConfig(), x_, num_experts=e, top_k=k,
            compute_dtype=jnp.bfloat16, gemm_impl="pallas")
        return jnp.sum(out.astype(jnp.float32) * co), (out, load)

    (_, (jout, jload)), jgrads = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2),
                                                            has_aux=True))(
        jax.tree.map(jnp.asarray, experts), jax.tree.map(jnp.asarray, router), jnp.asarray(x))
    tex = {n: torch.from_numpy(v).requires_grad_(True) for n, v in experts.items()}
    tro = {"w": torch.from_numpy(router["w"]).requires_grad_(True)}
    tx = torch.from_numpy(x).requires_grad_(True)
    tfm.reset_launches()
    out, _, load = tmoe_layer.moe_mlp_forward(tex, tro, trouter.GreedyRouterConfig(), tx,
                                              num_experts=e, top_k=k,
                                              compute_dtype=torch.bfloat16)
    (out.float() * torch.from_numpy(co)).sum().backward()
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    _close(out, jout, FWD_RTOL, "out")
    jex, jro, jx = jgrads
    for n in experts:
        _close(tex[n].grad, jex[n], GRAD_RTOL, n)
    _close(tro["w"].grad, jro["w"], GRAD_RTOL, "router")
    _close(tx.grad, jx, GRAD_RTOL, "dx")
