"""DeepSeek-V3's plain MLA in the PyTorch port against the JAX package, on
the CPU: `mla_forward` (projections, flash attention at a v head dim other
than q and k's, the yarn softmax scale, the output projection), a tiny
`Dense` model with MLA attention and yarn rope, its `loss()` and every
gradient leaf through the weight bridge under each ported remat policy, a
3-step `TrainEngine` curve; the DeepSeek-V3 presets, `deepseek_config_from_hf`
on DeepSeek-V3's published config values, the registry name and the recipe
of its three dense head layers.

The model: 2 layers, hidden 64, MLA with 2 heads, q_lora 16, kv_lora 8,
qk_nope 16 + rope 8 (q/k dim 24) and v 16, yarn rope (factor 4 over 32
positions, mscale 1 against mscale_all_dim 0.8, so both the cos/sin
scaling and the softmax scale move), an untied vocab of 128, chunked CE,
compute in f32 in both packages. JAX's attention there is its XLA
reference (its dispatch for head dims that are not a multiple of 128);
the port's flash wrappers run their plain versions, which
`tests/test_torch_flash_{fwd,bwd}.py` hold to JAX's Pallas kernels at the
same dims. `mla_forward` is held to 1e-5; losses and gradient leaves to
1e-5 relative and against each leaf's largest entry; engine metrics over 3
steps to 1e-4 relative (the bound of tests/test_torch_train_step.py's
engine curve).
"""

import dataclasses
import runpy
from pathlib import Path
from types import SimpleNamespace

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
from xtuner_tpu.model import dense as jdense
from xtuner_tpu.module import mla as jmla
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu.parallel.sharding import NULL_SHARD_CTX
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import deepseek as tds
from xtuner_tpu_torch.model import dense as tdense
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.module import mla as tmla
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.module.router import GreedyRouterConfig
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-5
ENGINE_TOL = 1e-4
VOCAB, SEQ, HIDDEN = 128, 64, 64
REMATS = ["none", "full", "save_attn_residuals", "save_out_lse"]
ATTN = dict(num_attention_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
YARN = dict(rope_type="yarn", factor=4.0, beta_fast=32.0, beta_slow=1.0, mscale=1.0,
            mscale_all_dim=0.8, original_max_position_embeddings=32)
DEEPSEEK_V3_HEAD_PARAMS = 3_603_815_424
# DeepSeek-V3's published HF config (config.json of deepseek-ai/DeepSeek-V3)
DEEPSEEK_V3_HF = dict(
    vocab_size=129280, max_position_embeddings=163840, eos_token_id=1, num_hidden_layers=61,
    first_k_dense_replace=3, hidden_size=7168, intermediate_size=18432,
    moe_intermediate_size=2048, n_routed_experts=256, num_experts_per_tok=8,
    n_shared_experts=1, rms_norm_eps=1e-6, hidden_act="silu", rope_theta=10000,
    rope_scaling={"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0,
                  "mscale_all_dim": 1.0, "original_max_position_embeddings": 4096,
                  "type": "yarn"},
    tie_word_embeddings=False, norm_topk_prob=True, routed_scaling_factor=2.5, n_group=8,
    topk_group=4, num_attention_heads=128, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


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


def _assert_same_config(t, j, name=""):
    """A port dataclass config against a JAX pydantic one, field by field
    (nested configs by their own fields)."""
    assert type(t).__name__ == type(j).__name__, name
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _assert_same_config(tv, jv, f"{name}.{f.name}")
        else:
            assert tv == jv, f"{name}.{f.name}: {tv!r} != {jv!r}"


# -------------------------------------------------------------- mla_forward
@pytest.mark.parametrize("q_lora", [16, None])
def test_mla_forward_matches_jax(q_lora):
    """Two documents and a padded tail, yarn rope and scale, f32."""
    attn = dict(ATTN, q_lora_rank=q_lora)
    jcfg, tcfg = jmla.MLAConfig(**attn), tmla.MLAConfig(**attn)
    jr, tr = jrope.RopeScalingConfig(**YARN), trope.RopeScalingConfig(**YARN)
    rng = np.random.default_rng(5)
    jparams = j_init_params(jmla.mla_param_specs(jcfg, HIDDEN), jax.random.key(1))
    x = rng.standard_normal((1, SEQ, HIDDEN), dtype=np.float32)
    seg = np.array([[1] * 23 + [2] * 31 + [0] * 10], np.int32)
    pos = np.array([list(range(23)) + list(range(31)) + [0] * 10], np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim, 1e4, jr, 128)
    want = jmla.mla_forward(jparams, jcfg, jnp.asarray(x), jc, js, jnp.asarray(seg),
                            NULL_SHARD_CTX, rope_scaling=jr)
    tc, ts = trope.rope_cos_sin(_t(pos), tcfg.head_dim, 1e4, tr, 128)
    tparams = jax.tree.map(lambda a: _t(np.asarray(a)), jparams)
    got = tmla.mla_forward(tparams, tcfg, _t(x), tc, ts, _t(seg), rope_scaling=tr)
    assert got.shape == (1, SEQ, HIDDEN)
    _close(got.numpy(), want)
    # the scale: qk_head_dim ** -0.5 times yarn's mscale squared
    m = 0.1 * 0.8 * np.log(4.0) + 1.0
    assert tmla.mla_softmax_scale(tcfg, tr) == pytest.approx(24 ** -0.5 * m * m, rel=1e-12)
    assert tmla.mla_softmax_scale(tcfg, tr) == jmla.mla_softmax_scale(jcfg, jr)


# --------------------------------------------------------- the Dense model
def _cfgs(layers: int = 2):
    common = dict(vocab_size=VOCAB, num_hidden_layers=layers, hidden_size=HIDDEN,
                  intermediate_size=96, rope_theta=1e4, rms_norm_eps=1e-6,
                  max_position_embeddings=128)
    j = jdense.DenseConfig(**common, attention=jmla.MLAConfig(**ATTN),
                           rope_scaling_cfg=jrope.RopeScalingConfig(**YARN),
                           lm_loss_cfg=JCE(chunk_size=48))
    t = tdense.DenseConfig(**common, attention=tmla.MLAConfig(**ATTN),
                           rope_scaling_cfg=trope.RopeScalingConfig(**YARN),
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


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX's Dense.loss (remat "full") and its gradient, computed once."""
    jcfg, _ = _cfgs()
    jmodel = jcfg.build()
    jparams = j_init_params(jmodel.param_specs(), jax.random.key(0))
    batch = _packed_batch(2, seed=3)
    denom = float(batch["loss_weights"].sum())
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]))

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="full")
        return out.total_loss(), (out.loss, out.sum_ce)

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(jparams)
    return (jax.tree.map(np.asarray, jparams), batch, denom, float(jl),
            [float(x) for x in jparts], dict(tree_paths(jax.tree.map(np.asarray, jgrads))))


@pytest.mark.parametrize("remat", REMATS)
def test_mla_dense_loss_and_every_grad_leaf_match_jax(jax_loss_and_grads, remat):
    """Under "save_out_lse" and "save_attn_residuals" the backward re-runs
    `mla_project` (the layer's `pre`); under "full" the whole layer."""
    np_params, batch, denom, jl, (j_ce, j_sum_ce), jleaves = jax_loss_and_grads
    _, tcfg = _cfgs()
    tparams = params_from_numpy(np_params, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    tout = tcfg.build().loss(tparams, tseq, _t(batch["shifted_labels"]),
                             _t(batch["loss_weights"]), denom, compute_dtype=torch.float32,
                             remat=remat)
    total = tout.total_loss()
    total.backward()
    _close(total.item(), jl, "total")
    _close(tout.loss.item(), j_ce, "ce")
    _close(tout.sum_ce.item(), j_sum_ce, "sum_ce")
    assert tout.dsa_index_loss is None
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        _close(v.grad.numpy(), jleaves[path], ".".join(path))
    for name in ("q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "o_proj"):
        assert float(tparams["layers"]["attn"][name]["w"].grad.abs().sum()) > 0, name


def test_mla_dense_remat_policies_give_the_same_gradients():
    """The four policies against each other (the same autograd graph, so
    the same bits up to recompute order), on one fresh set of weights."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    np_params = {}
    for path, spec in tree_paths(tcfg.build().param_specs()):
        node = np_params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (1.0 if spec.init == "ones" else 0.05) * (
            rng.standard_normal(spec.shape).astype(np.float32) if spec.init != "ones"
            else np.ones(spec.shape, np.float32))
    batch = _packed_batch(1, seed=12)
    denom = float(batch["loss_weights"].sum())
    tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    grads = {}
    for remat in REMATS:
        tparams = params_from_numpy(np_params, tcfg, "cpu", torch.float32)
        leaves = dict(tree_paths(tparams))
        for v in leaves.values():
            v.requires_grad_(True)
        out = tcfg.build().loss(tparams, tseq, _t(batch["shifted_labels"]),
                                _t(batch["loss_weights"]), denom,
                                compute_dtype=torch.float32, remat=remat)
        out.total_loss().backward()
        grads[remat] = (out.loss.item(), {p: v.grad for p, v in leaves.items()})
    base_loss, base = grads["none"]
    for remat in REMATS[1:]:
        loss, g = grads[remat]
        assert loss == pytest.approx(base_loss, rel=1e-6), remat
        for path, v in g.items():
            _close(v.numpy(), base[path].numpy(), f"{remat}: {'.'.join(path)}")


def test_mla_train_engine_curve_matches_jax():
    """3 optimizer steps, A = 2 micro-batches of 1 packed row (new rows each
    step), a clip that engages; the port under remat "save_out_lse"."""
    jcfg, tcfg = _cfgs()
    ocfg = dict(lr=2e-3, max_grad_norm=0.05, weight_decay=0.01)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 3,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.init_random(0)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="save_out_lse"), 3, device="cpu")
    teng.load_params(params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg, "cpu"))
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "skipped")
    curves = {"jax": [], "torch": []}
    for step in range(1, 4):
        micro = [_packed_batch(1, seed=10 * step + a) for a in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        jm = jeng.train_step(batch, step)
        tm = teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
    j, t = np.asarray(curves["jax"]), np.asarray(curves["torch"])
    np.testing.assert_allclose(t, j, rtol=ENGINE_TOL, atol=1e-7)
    assert (t[:, keys.index("skipped")] == 0).all()
    assert (t[1:, keys.index("grad_norm")] > ocfg["max_grad_norm"]).all()  # the clip engaged


# ------------------------------------------------------ presets and recipe
def test_deepseek_presets_match_jax_and_resolve():
    _assert_same_config(tds.deepseek_v3(), jds.deepseek_v3(), "deepseek_v3")
    _assert_same_config(tds.deepseek_v3_tiny(), jds.deepseek_v3_tiny(), "deepseek_v3_tiny")
    _assert_same_config(tds.deepseek_v3_tiny(hidden_size=48), jds.deepseek_v3_tiny(hidden_size=48))
    cfg = get_model_config("deepseek-v3")
    assert isinstance(cfg, tds.DeepSeekV3Config) and cfg.model_type == "deepseek_v3"
    assert cfg.attention.qk_head_dim == 192 and cfg.attention.head_dim == 64
    assert cfg.rope_scaling_cfg.rope_type == "yarn"
    # the MoE models build: the same parameter tree as JAX's, MTP included
    for t, j in ((cfg, jds.deepseek_v3()), (tds.deepseek_v3_tiny(), jds.deepseek_v3_tiny())):
        tspecs = dict(tree_paths(t.build().param_specs()))
        jspecs = dict(tree_paths(j.build().param_specs()))
        assert sorted(tspecs) == sorted(jspecs)
        assert all(tuple(tspecs[k].shape) == tuple(jspecs[k].shape) for k in jspecs)
    assert ("mtp_layers", "proj", "w") in dict(tree_paths(cfg.build().param_specs()))


def test_deepseek_config_from_hf_matches_jax():
    """DeepSeek-V3's published config values on a plain object."""
    hf = SimpleNamespace(**DEEPSEEK_V3_HF)
    t, j = tds.deepseek_config_from_hf(hf), jds.deepseek_config_from_hf(hf)
    _assert_same_config(t, j, "from_hf")
    _assert_same_config(t.rope_scaling_cfg, tds.deepseek_v3().rope_scaling_cfg, "rope")
    # without rope scaling, and with a tied head
    hf2 = SimpleNamespace(**dict(DEEPSEEK_V3_HF, rope_scaling=None, tie_word_embeddings=True,
                                 eos_token_id=None))
    t2, j2 = tds.deepseek_config_from_hf(hf2), jds.deepseek_config_from_hf(hf2)
    _assert_same_config(t2, j2, "from_hf_plain")
    assert t2.rope_scaling_cfg is None and t2.tie_word_embeddings and t2.eos_token_id == 1


def test_deepseek_v3_head_recipe():
    recipe = Path(tdense.__file__).resolve().parents[1] / "recipes" / \
        "sft_deepseek_v3_mla_head.py"
    tcfg = runpy.run_path(str(recipe))["trainer"]
    model_cfg, ds = tcfg.model_cfg, tds.deepseek_v3()
    assert type(model_cfg) is tdense.DenseConfig
    for f in dataclasses.fields(model_cfg):
        if f.name != "num_hidden_layers":
            assert getattr(model_cfg, f.name) == getattr(ds, f.name), f.name
    assert model_cfg.num_hidden_layers == ds.first_k_dense_replace == 3
    model = model_cfg.build()
    model.check_ported()
    assert count_params(model.param_specs()) == DEEPSEEK_V3_HEAD_PARAMS
    assert tcfg.dataloader_cfg.pack_max_length == 16384 and tcfg.total_steps == 4
    assert tcfg.mesh_cfg.remat_policy == "full" and model_cfg.lm_loss_cfg.mode == "chunk"
    assert tmla.mla_softmax_scale(model_cfg.attention, model_cfg.rope_scaling_cfg) == \
        pytest.approx(192 ** -0.5 * (0.1 * np.log(40) + 1) ** 2, rel=1e-12)


def test_mla_paths_still_unported_raise():
    cfg = tmla.MLAConfig(**ATTN)
    with pytest.raises(NotImplementedError, match=r"\[serve-rest\]"):
        tmla.mla_cached_forward({}, cfg, None, None, None, None, None, 0)
    # MoE layers with MLA attention build under either router; a per-layer
    # window pattern builds, and its training forward still waits for [moe]
    moe = tds.deepseek_v3_tiny(router=GreedyRouterConfig())
    specs = moe.build().param_specs()
    assert "e_score_correction_bias" not in specs["moe_layers"]["router"]
    assert specs["moe_layers"]["attn"]["kv_a_proj"]["w"].shape[0] == 2
    moe.layer_window_pattern = [4, None]
    assert moe.build().param_specs()["moe_layers"]["attn"]["kv_a_proj"]["w"].shape[0] == 2
    with pytest.raises(NotImplementedError, match=r"window pattern.*\[moe\]"):
        moe.build().loss(None, None, None, None, 1.0)
