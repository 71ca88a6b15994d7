"""The MoE SFT train step of the PyTorch port against the JAX package: the
CE loss, the collators, AdamW with its LR schedules against optax,
`MoE.loss` (and `Dense.loss`) with every gradient leaf through the weight
bridge, and a 5-step `TrainEngine` loss curve.

The model has the slice's structure at a tiny size: 2 layers, hidden 256,
4 q / 2 kv heads of head_dim 128 with qk-norm, 8 experts top-2, moe_inter
128, an untied vocab of 512, chunked CE, remat "full", compute in fp32 in
both packages. On the CPU the port's kernel wrappers run their plain
versions and the JAX package takes its CPU paths (reference attention,
`ragged_dot`). Inputs are numpy arrays from a seed; the two sides differ
only in summation order: losses and metrics within 1e-5 relative, gradient
leaves within 1e-5 of each leaf's largest entry plus 1e-5 relative,
engine metrics over 5 optimizer steps within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto import SequenceContext as JSeq
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.loss.ce_loss import ce_loss as j_ce_loss
from xtuner_tpu.model import dense as jdense
from xtuner_tpu.model import moe as jmoe
from xtuner_tpu.module.attention import MHAConfig as JMHA
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import fake_collator, sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import dense as tdense
from xtuner_tpu_torch.model import moe as tmoe
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.module.attention import MHAConfig as TMHA
from xtuner_tpu_torch.module.params import params_from_numpy, tree_paths
from xtuner_tpu_torch.module.router import NoAuxRouterConfig
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-5
CURVE_RTOL = 1e-4
VOCAB, SEQ = 512, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(dense: bool = False, **extra):
    """The tiny JAX and port configs of one model: the MoE slice model, or
    (dense=True) its dense counterpart."""
    common = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_size=256,
                  intermediate_size=512, rope_theta=1e6)
    if not dense:
        common.update(moe_intermediate_size=128, n_routed_experts=8, num_experts_per_tok=2,
                      balancing_loss_coef=0.001, z_loss_coef=0.001)
    common.update(extra)
    jcls, tcls = (jdense.DenseConfig, tdense.DenseConfig) if dense else \
        (jmoe.MoEConfig, tmoe.MoEConfig)
    j = jcls(**common, attention=JMHA(num_attention_heads=4, num_key_value_heads=2,
                                      head_dim=128, qk_norm=True),
             lm_loss_cfg=JCE(chunk_size=48))
    t = tcls(**common, attention=TMHA(num_attention_heads=4, num_key_value_heads=2,
                                      head_dim=128, qk_norm=True),
             lm_loss_cfg=tce.CELossConfig(chunk_size=48))
    return j, t


def _packed_batch(rows: int, seed: int):
    """(rows, SEQ) packed batch: 1-3 documents per row and a padded tail."""
    rng = np.random.default_rng(seed)
    packs = []
    for _ in range(rows):
        n_docs = int(rng.integers(1, 4))
        lens = rng.integers(8, SEQ // n_docs, size=n_docs)
        packs.append([{"input_ids": rng.integers(1, VOCAB, size=n), "labels":
                       np.where(rng.random(n) < 0.2, -100, rng.integers(1, VOCAB, size=n))}
                      for n in lens])
    return sft_llm_collator(packs, SEQ)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


# ---------------------------------------------------------------- CE loss
@pytest.mark.parametrize("mode,chunk", [("eager", 1024), ("chunk", 16), ("chunk", 1024)])
def test_ce_loss_matches_jax(mode, chunk):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 40, 64), dtype=np.float32)
    w = rng.standard_normal((64, 100), dtype=np.float32) * 0.2
    labels = rng.integers(0, 100, (2, 40)).astype(np.int32)
    labels[rng.random((2, 40)) < 0.25] = -100
    weights = np.where(labels != -100, rng.random((2, 40)), 0).astype(np.float32)
    denom = float(weights.sum()) * 1.5  # the global denominator of a larger batch

    def j_fn(h_, w_):
        loss, sum_ce, n = j_ce_loss(h_, w_, jnp.asarray(labels), jnp.asarray(weights), denom,
                                    JCE(mode=mode, chunk_size=chunk))
        return loss, (sum_ce, n)

    (jl, (js, jn)), (jgh, jgw) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    tl, ts, tn = tce.ce_loss(th, tw, _t(labels), _t(weights), denom,
                             tce.CELossConfig(mode=mode, chunk_size=chunk))
    tl.backward()
    _close(tl.item(), jl)
    _close(ts.item(), js)
    assert int(tn) == int(jn)
    _close(th.grad.numpy(), jgh)
    _close(tw.grad.numpy(), jgw)


def test_ce_fused_mode_raises():
    """Fused mode runs (tests/test_torch_fused_ce.py); what still raises in
    it is a head bias, which JAX routes to the chunk path."""
    with pytest.raises(NotImplementedError, match="bias"):
        tce.ce_loss(torch.zeros(1, 2, 128), torch.zeros(128, 8),
                    torch.zeros(1, 2, dtype=torch.long), torch.ones(1, 2), 2.0,
                    tce.CELossConfig(mode="fused"), lm_head_b=torch.zeros(8))


@pytest.mark.parametrize("reduction", ["token", "sample", "square"])
def test_loss_weights_and_collators_match_jax(reduction):
    from xtuner_tpu.datasets import collator as jcol

    rng = np.random.default_rng(1)
    packs = [[{"input_ids": rng.integers(1, 50, size=n), "labels": rng.integers(1, 50, size=n)}
              for n in (5, 9)], [{"input_ids": rng.integers(1, 50, size=20),
                                  "labels": rng.integers(1, 50, size=20)}]]
    want = jcol.sft_llm_collator(packs, 16, reduction, pad_token_id=3)
    got = sft_llm_collator(packs, 16, reduction, pad_token_id=3)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want, got = jcol.fake_collator(2, 8, 50, seed=4), fake_collator(2, 8, 50, seed=4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------- AdamW + schedule
@pytest.mark.parametrize("lr_type,warmup", [("cosine", 2), ("linear", 1), ("constant", 1),
                                            ("cosine", 0)])
def test_lr_schedules_match_optax(lr_type, warmup):
    ocfg = joptim.AdamWConfig(lr=3e-3)
    want = joptim.build_lr_schedule(ocfg, joptim.LRConfig(lr_type=lr_type, warmup_steps=warmup,
                                                          lr_min=1e-4), 6)
    got = toptim.build_lr_schedule(toptim.AdamWConfig(lr=3e-3),
                                   toptim.LRConfig(lr_type=lr_type, warmup_steps=warmup,
                                                   lr_min=1e-4), 6)
    for step in range(9):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)


def test_adamw_matches_optax_over_five_updates():
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "norm": (5,)}
    params = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    ocfg = dict(lr=1e-2, weight_decay=0.1, betas=(0.9, 0.95), eps=1e-8)
    lcfg = dict(lr_type="cosine", warmup_steps=2, lr_min=1e-3)
    tx = joptim.build_optimizer(joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), 5)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tparams = {k: _t(v) for k, v in params.items()}
    names = sorted(tparams)
    opt = toptim.AdamW([tparams[k] for k in names], [tparams[k].dim() >= 2 for k in names],
                       toptim.AdamWConfig(**ocfg),
                       toptim.build_lr_schedule(toptim.AdamWConfig(**ocfg),
                                                toptim.LRConfig(**lcfg), 5))
    lrs = []
    for _ in range(5):
        grads = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        lrs.append(opt.step([_t(grads[k]) for k in names]))
    assert lrs[0] == 0.0  # optax evaluates the schedule at count 0 first
    for k in names:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ MoE.loss and grads
@pytest.mark.parametrize("extra", [
    {},  # the slice's model
    {"first_k_dense_replace": 1, "n_shared_experts": 1, "num_hidden_layers": 3},
    {"dense": True},  # Dense.loss: the same layers with a dense MLP
])
def test_moe_loss_and_every_grad_leaf_match_jax(extra):
    jcfg, tcfg = _cfgs(**extra)
    jmodel, tmodel = jcfg.build(), tcfg.build()
    jparams = j_init_params(jmodel.param_specs(), jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    batch = _packed_batch(2, seed=3)
    denom = float(batch["loss_weights"].sum())
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]))

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="full")
        return out.total_loss(), out

    (jl, jout), jgrads = jax.value_and_grad(j_fn, has_aux=True)(jparams)
    tparams = params_from_numpy(np_tree, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    tout = tmodel.loss(tparams, tseq, _t(batch["shifted_labels"]), _t(batch["loss_weights"]),
                       denom, compute_dtype=torch.float32, remat="full")
    tl = tout.total_loss()
    tl.backward()
    _close(tl.item(), jl)
    for name in ("loss", "balancing_loss", "z_loss", "sum_ce"):
        if getattr(jout, name) is not None:
            _close(getattr(tout, name).item(), getattr(jout, name), name)
    if jout.expert_load is not None:
        np.testing.assert_array_equal(tout.expert_load.numpy(), np.asarray(jout.expert_load))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        _close(v.grad.numpy(), jleaves[path], ".".join(path))


def test_moe_presets_match_jax():
    from xtuner_tpu.model.registry import get_model_config as j_get

    for name in ("qwen3-moe-30b-a3", "qwen3-moe-235b-a22"):
        jspecs = dict(tree_paths(j_get(name).build().param_specs()))
        tspecs = dict(tree_paths(get_model_config(name).build().param_specs()))
        assert sorted(jspecs) == sorted(tspecs)
        for k in jspecs:
            assert tuple(jspecs[k].shape) == tuple(tspecs[k].shape), k


def test_unported_moe_options_raise():
    _, tcfg = _cfgs(mtp_num_layers=1)
    with pytest.raises(NotImplementedError, match=r"\[moe\]"):
        tcfg.build().param_specs()
    _, tcfg = _cfgs()
    tcfg.router = NoAuxRouterConfig()
    with pytest.raises(NotImplementedError, match=r"\[moe\]"):
        TEngine(tcfg, toptim.AdamWConfig(), toptim.LRConfig(), TMesh(), 2, device="cpu")
    jcfg, tcfg = _cfgs()
    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(jcfg.build().param_specs(), jax.random.key(0))), tcfg, "cpu")
    with pytest.raises(NotImplementedError, match="train-slice"):
        tcfg.build().loss(params, TSeq.from_input_ids(np.ones((1, 8), np.int32)),
                          torch.zeros(1, 8, dtype=torch.long), torch.ones(1, 8), 8.0,
                          compute_dtype=torch.float32, remat="dots")


# ------------------------------------------------------------- 5-step curve
def test_train_engine_curve_matches_jax():
    """A = 2 micro-batches of 2 packed rows; a clip that engages; step 3 has
    an infinite loss weight, so its grads are not finite and both engines
    skip it."""
    jcfg, tcfg = _cfgs()
    ocfg = dict(lr=2e-3, max_grad_norm=0.05, weight_decay=0.01)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 5,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.init_random(0)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="full"), 5, device="cpu")
    teng.load_params(params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg, "cpu"))
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "maxvio",
            "skipped")
    curves = {"jax": [], "torch": []}
    for step in range(1, 6):
        micro = [_packed_batch(2, seed=10 * step + a) for a in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        if step == 3:
            batch["loss_weights"][0, 0, 5] = np.inf
        jm = jeng.train_step(batch, step)
        tm = teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
    j, t = np.asarray(curves["jax"]), np.asarray(curves["torch"])
    np.testing.assert_allclose(t, j, rtol=CURVE_RTOL, atol=1e-7)
    skipped = t[:, keys.index("skipped")]
    assert skipped.tolist() == [0, 0, 1, 0, 0]
    norms = t[:, keys.index("grad_norm")]
    assert (norms[skipped == 0] > ocfg["max_grad_norm"]).all()  # the clip engaged
    assert t[-1, keys.index("reduced_llm_loss")] < t[0, keys.index("reduced_llm_loss")]
