"""The aux-free (noaux) router, MoE layers with MLA and DSA attention and
multi-token prediction in the PyTorch port against the JAX package, on
the CPU.

- `noaux_route` with one and two expert groups, on random scores and on
  purpose-made ties. `jax.lax.top_k` takes equal values lowest index
  first; `torch.topk` does not promise an order among equals (top-4 of
  200 rows of 16 integer scores in 0-2: other indices in 196 rows on the
  CPU), so the port selects with `topk_lowest_first`, a stable
  descending sort.
- `update_noaux_bias`, `shift_for_mtp` and `mtp_fuse`.
- `MoE.loss` and every gradient leaf of `deepseek_v3_tiny()` (MLA in the
  MoE layers, the noaux router with 2 groups, a shared expert), without
  and with one MTP layer, and of a tiny GLM-5.2-shaped MoE (block DSA
  attention in the dense and MoE layers, two MTP depths sharing one
  layer), all through the weight bridge in f32.
- A 3-step `TrainEngine` curve of `deepseek_v3_tiny` with one MTP layer:
  losses, grad norm, `maxvio` and both stacks' correction biases after
  each step, a skipped step leaving the biases alone.
- The reference fault: JAX's AdamW decays the stacked (L, E) bias (its
  `_decay_mask` marks every leaf of 2 or more dims); the port keeps it out
  of the optimizer.
- The GLM-4.5-Air head recipe against `glm_45_air()` field by field.

JAX's MLA runs its XLA reference attention at these head dims and its
block-sparse DSA kernels in interpret mode; the port's wrappers run their
plain versions. The two sides differ in summation order only: losses and
gradient leaves within 1e-5 relative and of each leaf's largest entry
(1e-4 with DSA, as `tests/test_torch_dsa_model.py`); expert loads and
routing ids exactly; engine metrics within 1e-4 relative and biases
within 1e-7.
"""

import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto import SequenceContext as JSeq
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import deepseek as jds
from xtuner_tpu.model import glm as jglm
from xtuner_tpu.module import mtp as jmtp
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.module.dsa import DSAConfig as JDSA
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import deepseek as tds
from xtuner_tpu_torch.model import glm as tglm
from xtuner_tpu_torch.model import moe as tmoe
from xtuner_tpu_torch.module import mtp as tmtp
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.module.dsa import DSAConfig as TDSA
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-5
DSA_TOL = 1e-4
CURVE_RTOL = 1e-4
BIAS_ATOL = 1e-7
VOCAB, SEQ = 128, 64
# glm_45_air() at 2 layers (the dense layer and one MoE layer), no MTP
GLM45_AIR_HEAD_PARAMS = 3_826_565_248


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
    return torch.from_numpy(np.array(a))


def _close(got, want, msg="", tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=msg)


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


# ------------------------------------------------------------------ router
def _router_cfgs(n_group: int, topk_group: int):
    kw = dict(n_group=n_group, topk_group=topk_group, routed_scaling_factor=2.5,
              router_bias=True)
    return jrouter.NoAuxRouterConfig(**kw), trouter.NoAuxRouterConfig(**kw)


def _route_both(p: dict, x: np.ndarray, n_group: int, topk_group: int, top_k: int):
    jc, tc = _router_cfgs(n_group, topk_group)
    j = jrouter.route(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x), top_k)
    t = trouter.route({k: _t(v) for k, v in p.items()}, tc, _t(x), top_k)
    return j, t


@pytest.mark.parametrize("n_group,topk_group", [(1, 1), (2, 1), (4, 2)])
def test_noaux_route_matches_jax(n_group, topk_group):
    rng = np.random.default_rng(20 + n_group)
    x = rng.standard_normal((96, 32), dtype=np.float32)
    p = {"w": rng.standard_normal((32, 16), dtype=np.float32) * 0.3,
         "b": rng.standard_normal((16,), dtype=np.float32) * 0.1,
         "e_score_correction_bias": rng.standard_normal((16,), dtype=np.float32) * 0.2}
    j, t = _route_both(p, x, n_group, topk_group, 4)
    np.testing.assert_array_equal(t.topk_idx.numpy(), np.asarray(j.topk_idx))
    for a, b in ((t.topk_weights, j.topk_weights), (t.logits, j.logits), (t.probs, j.probs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    # the bias moves selection only: the combine weights are unbiased scores
    w = np.take_along_axis(t.probs.numpy(), t.topk_idx.numpy(), axis=-1)
    np.testing.assert_allclose(t.topk_weights.numpy(),
                               2.5 * w / w.sum(-1, keepdims=True), rtol=1e-6)
    if n_group > 1:  # every selected expert lies in one of the kept groups
        groups = t.topk_idx.numpy() // (16 // n_group)
        assert max(len(set(row)) for row in groups) <= topk_group


@pytest.mark.parametrize("n_group,topk_group", [(1, 1), (2, 1)])
def test_noaux_route_ties_match_jax(n_group, topk_group):
    """Exact ties: x in {0, 1} and w in quarters make every logit exact, and
    experts 4-7 copy experts 0-3 (so the two groups tie too); the bias,
    also in quarters, ties a few more."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2, (64, 8)).astype(np.float32)
    half = rng.integers(-4, 5, (8, 4)).astype(np.float32) / 4
    p = {"w": np.concatenate([half, half], axis=1),
         "e_score_correction_bias": np.array([0, 0.25, 0, 0.25, 0, 0.25, 0, 0.25],
                                             np.float32)}
    j, t = _route_both(p, x, n_group, topk_group, 3)
    np.testing.assert_array_equal(t.topk_idx.numpy(), np.asarray(j.topk_idx))
    np.testing.assert_allclose(t.topk_weights.numpy(), np.asarray(j.topk_weights), atol=TOL)


def test_topk_lowest_first_matches_jax_top_k_on_ties():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 3, (200, 16)).astype(np.float32)
    x[::7, 3] = -np.inf
    for k in (1, 4, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = trouter.topk_lowest_first(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_update_noaux_bias_matches_jax():
    rng = np.random.default_rng(9)
    bias = rng.standard_normal((3, 8)).astype(np.float32) * 0.01
    load = rng.integers(0, 40, (3, 8)).astype(np.float32)
    load[1] = 10.0  # a uniform row: no entry moves
    want = jrouter.update_noaux_bias(jnp.asarray(bias), jnp.asarray(load), 0.001)
    got = _t(bias)
    trouter.update_noaux_bias(got, _t(load), 0.001)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1], bias[1])


# --------------------------------------------------------------------- MTP
def test_shift_for_mtp_matches_jax():
    rng = np.random.default_rng(10)
    seg = np.array([[1, 1, 1, 2, 2, 0, 0], [1, 2, 2, 2, 3, 3, 3]], np.int32)
    ids = rng.integers(1, 50, seg.shape).astype(np.int32)
    weights = rng.random(seg.shape).astype(np.float32)
    for x, fill in ((ids, 0), (ids, -100), (weights, 0.0)):
        want = jmtp.shift_for_mtp(jnp.asarray(x), jnp.asarray(seg), fill)
        got = tmtp.shift_for_mtp(_t(x), _t(seg), fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmtp.shift_for_mtp(_t(ids), _t(seg), -1).numpy()[0],
                                  [ids[0, 1], ids[0, 2], -1, ids[0, 4], -1, -1, -1])


def test_mtp_fuse_matches_jax():
    rng = np.random.default_rng(11)
    extra = {"proj": {"w": rng.standard_normal((32, 16), dtype=np.float32) * 0.1},
             "hidden_norm": rng.random(16).astype(np.float32) + 0.5,
             "embed_norm": rng.random(16).astype(np.float32) + 0.5}
    h = rng.standard_normal((2, 5, 16), dtype=np.float32)
    e = rng.standard_normal((2, 5, 16), dtype=np.float32)
    want = jmtp.mtp_fuse(jax.tree.map(jnp.asarray, extra), jnp.asarray(h), jnp.asarray(e), 1e-5)
    got = tmtp.mtp_fuse({"proj": {"w": _t(extra["proj"]["w"])},
                         "hidden_norm": _t(extra["hidden_norm"]),
                         "embed_norm": _t(extra["embed_norm"])}, _t(h), _t(e), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    specs = dict(tree_paths(tmtp.mtp_extra_param_specs(16)))
    jspecs = dict(tree_paths(jmtp.mtp_extra_param_specs(16)))
    assert sorted(specs) == sorted(jspecs)
    assert all(tuple(specs[k].shape) == tuple(jspecs[k].shape) for k in specs)


# ------------------------------------------------------- MoE.loss and grads
AUX = dict(balancing_loss_coef=0.001, z_loss_coef=0.001)


def _deepseek_cfgs(**kw):
    kw = {**AUX, **kw}
    return (jds.deepseek_v3_tiny(**kw, lm_loss_cfg=JCE(chunk_size=48)),
            tds.deepseek_v3_tiny(**kw, lm_loss_cfg=tce.CELossConfig(chunk_size=48)))


def _glm_dsa_cfgs():
    """GLM-5.2's layer structure at a tiny size: a dense head layer, one
    MoE layer, block DSA attention (qk_nope 8 != v 12), the noaux router
    with routed scaling and a shared expert, two MTP depths on one shared
    layer."""
    attn = dict(num_attention_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=12, index_n_heads=2, index_head_dim=8,
                index_top_k=32, select_granularity="block", index_block=16)
    common = dict(vocab_size=VOCAB, num_hidden_layers=2, first_k_dense_replace=1,
                  hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                  n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                  rms_norm_eps=1e-5, rope_theta=1e4, mtp_num_layers=2, mtp_share_weights=True,
                  **AUX)
    router = dict(routed_scaling_factor=2.5)
    return (jglm.GLMConfig(**common, attention=JDSA(**attn),
                           router=jrouter.NoAuxRouterConfig(**router),
                           lm_loss_cfg=JCE(chunk_size=48)),
            tglm.GLMConfig(**common, attention=TDSA(**attn),
                           router=trouter.NoAuxRouterConfig(**router),
                           lm_loss_cfg=tce.CELossConfig(chunk_size=48)))


def _bias_nonzero(np_tree, seed: int):
    """Give every correction bias nonzero values (a trained router's), so
    that selection depends on it."""
    rng = np.random.default_rng(seed)
    for key in ("moe_layers", "mtp_layers"):
        if key in np_tree:
            b = np_tree[key]["router"]["e_score_correction_bias"]
            np_tree[key]["router"]["e_score_correction_bias"] = \
                (rng.standard_normal(b.shape) * 0.05).astype(np.float32)
    return np_tree


@pytest.mark.parametrize("which", ["deepseek", "deepseek_mtp", "glm_dsa_shared_mtp"])
def test_moe_loss_and_every_grad_leaf_match_jax(which):
    jcfg, tcfg = {"deepseek": lambda: _deepseek_cfgs(),
                  "deepseek_mtp": lambda: _deepseek_cfgs(mtp_num_layers=1),
                  "glm_dsa_shared_mtp": _glm_dsa_cfgs}[which]()
    tol = DSA_TOL if which.startswith("glm") else TOL
    jmodel, tmodel = jcfg.build(), tcfg.build()
    np_tree = _bias_nonzero(jax.tree.map(
        np.asarray, j_init_params(jmodel.param_specs(), jax.random.key(0))), 1)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    batch = _packed_batch(2, seed=3)
    denom = float(batch["loss_weights"].sum())
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]))
    names = ("loss", "sum_ce", "balancing_loss", "z_loss", "mtp_loss", "dsa_index_loss")

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="full")
        return out.total_loss(), ({n: getattr(out, n) for n in names},
                                  out.expert_load, out.mtp_expert_load)

    (jl, (jparts, jload, jmtp_load)), jgrads = jax.jit(
        jax.value_and_grad(j_fn, has_aux=True))(jparams)
    tparams = params_from_numpy(np_tree, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    tout = tmodel.loss(tparams, tseq, _t(batch["shifted_labels"]), _t(batch["loss_weights"]),
                       denom, compute_dtype=torch.float32, remat="full")
    total = tout.total_loss()
    total.backward()
    _close(total.item(), jl, "total", tol)
    for name in names:
        if jparts[name] is None:
            assert getattr(tout, name) is None, name
        else:
            _close(getattr(tout, name).item(), jparts[name], name, tol)
    np.testing.assert_array_equal(tout.expert_load.numpy(), np.asarray(jload))
    if jmtp_load is None:
        assert tout.mtp_expert_load is None and tout.mtp_loss is None
    else:
        np.testing.assert_array_equal(tout.mtp_expert_load.numpy(), np.asarray(jmtp_load))
        assert tout.mtp_loss.item() > 0
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        if path[-1] == "e_score_correction_bias":  # a buffer: no gradient on either side
            assert v.grad is None and not np.asarray(jleaves[path]).any()
            continue
        _close(v.grad.numpy(), jleaves[path], ".".join(path), tol)
    if jmtp_load is not None:
        assert float(tparams["mtp_layers"]["proj"]["w"].grad.abs().sum()) > 0


# ------------------------------------------------------------ 3-step curve
def _engines(ocfg: dict, lcfg: dict, steps: int, **kw):
    jcfg, tcfg = _deepseek_cfgs(**kw)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, steps,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.init_random(0)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="full"), steps, device="cpu")
    teng.load_params(params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg, "cpu"))
    return jeng, teng


def _biases(params, keys=("moe_layers", "mtp_layers")) -> dict:
    return {k: np.array(params[k]["router"]["e_score_correction_bias"]) for k in keys
            if k in params}


def test_noaux_train_engine_curve_matches_jax():
    """3 optimizer steps of `deepseek_v3_tiny` with one MTP layer, A = 2
    micro-batches of 1 packed row; step 2 has an infinite loss weight, so
    its grads are not finite and both engines skip it, biases included.
    No weight decay: JAX's AdamW would decay the bias, which the port does
    not (the fault `test_jax_adamw_decays_the_bias_and_the_port_does_not`
    pins)."""
    ocfg = dict(lr=2e-3, max_grad_norm=0.05, weight_decay=0.0)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    jeng, teng = _engines(ocfg, lcfg, 3, mtp_num_layers=1)
    assert not any(p is teng.params["moe_layers"]["router"]["e_score_correction_bias"]
                   for p in teng.optimizer.params)
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "maxvio",
            "skipped")
    curves = {"jax": [], "torch": []}
    biases = []
    for step in range(1, 4):
        micro = [_packed_batch(1, seed=10 * step + a) for a in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        if step == 2:  # a supervised position's weight
            pos = int(np.flatnonzero(batch["loss_weights"][0, 0] > 0)[0])
            batch["loss_weights"][0, 0, pos] = np.inf
        jm = jeng.train_step(batch, step)
        tm = teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
        jb, tb = _biases(jax.tree.map(np.asarray, jeng.params)), _biases(teng.params)
        assert sorted(jb) == sorted(tb) == ["moe_layers", "mtp_layers"]
        for k in jb:
            np.testing.assert_allclose(tb[k], jb[k], rtol=0, atol=BIAS_ATOL, err_msg=k)
        biases.append(tb)
    j, t = np.asarray(curves["jax"]), np.asarray(curves["torch"])
    np.testing.assert_allclose(t, j, rtol=CURVE_RTOL, atol=1e-7)
    assert t[:, keys.index("skipped")].tolist() == [0, 1, 0]
    for k, b in biases[0].items():  # step 1 moves every entry by 0 or +-speed
        assert set(np.unique(np.abs(b))) <= {0.0, np.float32(0.001)}, k
        assert np.abs(b).max() > 0, k
        np.testing.assert_array_equal(biases[1][k], b)  # the skipped step
        assert not np.array_equal(biases[2][k], b)
    assert (t[:, keys.index("maxvio")] >= 1).all()


def test_jax_adamw_decays_the_bias_and_the_port_does_not():
    """A reference fault (ROADMAP.md, known faults): JAX's `_decay_mask`
    marks every leaf of 2 or more dims, and the stacked (L, E) correction
    bias is one, so optax's AdamW decays it by lr x wd each step, though
    JAX's engine calls it a buffer no gradient update touches. The port
    keeps it out of the optimizer (no moments, no decay). One step from a
    nonzero bias at a constant lr of 1e-2 and wd 0.5: both engines route
    alike (the step's loads are computed before the update), so the biases
    differ by exactly JAX's decay."""
    lr, wd, speed = 1e-2, 0.5, 0.001
    ocfg = dict(lr=lr, max_grad_norm=1.0, weight_decay=wd)
    lcfg = dict(lr_type="constant", warmup_steps=0)
    jeng, teng = _engines(ocfg, lcfg, 2)
    np_tree = _bias_nonzero(jax.tree.map(np.asarray, jeng.params), 5)
    jeng.params = jax.tree.map(jnp.asarray, np_tree)
    jeng.opt_state = jeng.tx.init(jeng.params)
    teng.load_params(params_from_numpy(np_tree, teng.model_cfg, "cpu"))
    b0 = np_tree["moe_layers"]["router"]["e_score_correction_bias"]
    batch = {k: v[None] for k, v in _packed_batch(2, seed=4).items()}
    jeng.train_step(batch, 1)
    teng.train_step(batch, 1)
    jb = np.asarray(jeng.params["moe_layers"]["router"]["e_score_correction_bias"])
    tb = teng.params["moe_layers"]["router"]["e_score_correction_bias"].numpy()
    moved = tb - b0
    np.testing.assert_allclose(np.abs(moved)[moved != 0], speed, rtol=1e-3)
    assert (moved != 0).any()
    np.testing.assert_allclose(jb, b0 * (1 - lr * wd) + moved, rtol=0, atol=1e-6)
    assert np.abs(jb - tb).max() > 0.5 * lr * wd * np.abs(b0).max()


# --------------------------------------------------------- GLM-4.5-Air head
def test_glm45_air_head_recipe():
    recipe = Path(tmoe.__file__).resolve().parents[1] / "recipes" / "sft_glm45_air_head.py"
    tcfg = runpy.run_path(str(recipe))["trainer"]
    model_cfg, air = tcfg.model_cfg, tglm.glm_45_air()
    assert type(model_cfg) is tglm.GLMConfig
    cuts = {"num_hidden_layers": 2, "mtp_num_layers": 0}
    for f in dataclasses.fields(model_cfg):
        want = cuts.get(f.name, getattr(air, f.name))
        assert getattr(model_cfg, f.name) == want, f.name
    assert (air.num_hidden_layers, air.mtp_num_layers, model_cfg.first_k_dense_replace) == \
        (46, 1, 1)
    assert model_cfg.router.router_type == "noaux" and model_cfg.attention.qkv_bias
    specs = model_cfg.build().param_specs()
    assert count_params(specs) == GLM45_AIR_HEAD_PARAMS
    assert tcfg.dataloader_cfg.pack_max_length == 8192 and tcfg.total_steps == 4
    assert (tcfg.global_batch_rows, tcfg.micro_batch_rows) == (1, 1)
    assert tcfg.mesh_cfg.remat == "full" and model_cfg.lm_loss_cfg.mode == "chunk"
    # JAX builds the same parameter tree from the same fields
    jcfg = jglm.glm_45_air().model_copy(update=cuts)
    jspecs = dict(tree_paths(jcfg.build().param_specs()))
    tspecs = dict(tree_paths(specs))
    assert sorted(jspecs) == sorted(tspecs)
    assert all(tuple(jspecs[k].shape) == tuple(tspecs[k].shape) for k in jspecs)


def test_moe_heavy_mtp_recipe():
    rdir = Path(tmoe.__file__).resolve().parents[1] / "recipes"
    base = runpy.run_path(str(rdir / "sft_moe_heavy.py"))["trainer"]
    mtp = runpy.run_path(str(rdir / "sft_moe_heavy_mtp.py"))["trainer"]
    assert mtp.model_cfg == dataclasses.replace(base.model_cfg, mtp_num_layers=1)
    assert dataclasses.replace(mtp, model_cfg=base.model_cfg, exp_name=base.exp_name) == base
    specs = mtp.model_cfg.build().param_specs()
    assert list(specs) == ["embed", "final_norm", "moe_layers", "mtp_layers"]


def test_still_unported_moe_options_raise():
    """A window (a pattern or the config's) on DSA or MLA attention
    raises: JAX's DSA path takes none and its `mla_forward` never passes
    one on, so the reference would drop it. The noaux router replays
    forced ids (tests/test_torch_gpt_oss_train.py holds both routers to
    JAX)."""
    for cfg in (_glm_dsa_cfgs()[1], tds.deepseek_v3_tiny()):
        for kw in ({"layer_window_pattern": [4, None]},
                   {"use_sliding_window": True, "sliding_window": 4}):
            windowed = dataclasses.replace(cfg, **kw)
            windowed.build().param_specs()  # builds; its training forward raises
            with pytest.raises(NotImplementedError, match=r"window pattern on .*\[moe\]"):
                windowed.build().forward(None, None)
    p = {"w": torch.zeros(4, 2), "e_score_correction_bias": torch.zeros(2)}
    r = trouter.route(p, trouter.NoAuxRouterConfig(), torch.zeros(3, 4), 1,
                      forced_idx=torch.tensor([[1], [-1], [0]]))
    assert r.topk_idx[:, 0].tolist() == [1, 0, 0]
