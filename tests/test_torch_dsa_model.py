"""GLM-5.2's DSA training path in the PyTorch port against the JAX package,
on the CPU: a tiny `Dense` model with block-granular DSA attention, its
`loss()` (CE plus `dsa_index_loss`) and every gradient leaf through the
weight bridge, a 3-step `TrainEngine` curve; the GLM presets, the registry
name and the recipe of GLM-5.2's three dense head layers.

The model: 2 layers, hidden 64, DSA with 2 heads, q_lora 16, kv_lora 8,
qk_nope 8 != v_head 12, rope 4, an indexer of 2 heads x 8 with top-k 32
over blocks of 16 (2 of 4 key blocks per q-block), an untied vocab of 128,
chunked CE, compute in f32 in both packages. JAX runs its block-sparse
Pallas kernels in interpret mode, the port their plain versions. Losses
and gradient leaves are held to 1e-4 relative and against each leaf's
largest entry (the bound of tests/test_torch_train_step.py's engine
curve; here the indexer statistics add an f32 logsumexp per key block to
each path); engine metrics over 3 steps within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto import SequenceContext as JSeq
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import dense as jdense
from xtuner_tpu.model import glm as jglm
from xtuner_tpu.module.dsa import DSAConfig as JDSA
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import dense as tdense
from xtuner_tpu_torch.model import glm as tglm
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.module.dsa import DSAConfig as TDSA
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.module.router import GreedyRouterConfig
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-4
VOCAB, SEQ = 128, 64
GLM52_HEAD_PARAMS = 3_156_198_912


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _cfgs():
    common = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_size=64,
                  intermediate_size=96, rope_theta=1e4, rms_norm_eps=1e-5)
    attn = dict(num_attention_heads=2, q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=12, index_n_heads=2, index_head_dim=8,
                index_top_k=32, select_granularity="block", index_block=16)
    j = jdense.DenseConfig(**common, attention=JDSA(**attn), lm_loss_cfg=JCE(chunk_size=48))
    t = tdense.DenseConfig(**common, attention=TDSA(**attn),
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
        return out.total_loss(), (out.loss, out.sum_ce, out.dsa_index_loss)

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(jparams)
    return (jax.tree.map(np.asarray, jparams), batch, denom, float(jl),
            [float(x) for x in jparts], dict(tree_paths(jax.tree.map(np.asarray, jgrads))))


@pytest.mark.parametrize("remat", ["full", "none"])
def test_dsa_dense_loss_and_every_grad_leaf_match_jax(jax_loss_and_grads, remat):
    np_params, batch, denom, jl, (j_ce, j_sum_ce, j_idx), jleaves = jax_loss_and_grads
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
    _close(tout.dsa_index_loss.item(), j_idx, "dsa_index_loss")
    assert 0 < tout.dsa_index_loss.item()
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        _close(v.grad.numpy(), jleaves[path], ".".join(path))
    for name in ("idx_q_proj", "idx_k_proj", "idx_w_proj"):  # trained by the indexer loss
        assert float(tparams["layers"]["attn"][name]["w"].grad.abs().sum()) > 0, name


def test_dsa_train_engine_curve_matches_jax():
    """3 optimizer steps, A = 2 micro-batches of 1 packed row, a clip that
    engages; the port also reports the indexer loss."""
    jcfg, tcfg = _cfgs()
    ocfg = dict(lr=2e-3, max_grad_norm=0.05, weight_decay=0.01)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 3,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.init_random(0)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="full"), 3, device="cpu")
    teng.load_params(params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg, "cpu"))
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "skipped")
    curves = {"jax": [], "torch": []}
    idx_losses = []
    for step in range(1, 4):
        micro = [_packed_batch(1, seed=10 * step + a) for a in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        jm = jeng.train_step(batch, step)
        tm = teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
        idx_losses.append(tm["dsa_index_loss"])
    j, t = np.asarray(curves["jax"]), np.asarray(curves["torch"])
    np.testing.assert_allclose(t, j, rtol=TOL, atol=1e-7)
    assert (t[:, keys.index("skipped")] == 0).all()
    assert (t[1:, keys.index("grad_norm")] > ocfg["max_grad_norm"]).all()  # the clip engaged
    assert all(np.isfinite(idx_losses)) and min(idx_losses) > 0
    # the total is CE plus the indexer loss, both summed over the micro-batches
    assert t[-1, keys.index("reduced_llm_loss")] < t[0, keys.index("reduced_llm_loss")]


# ------------------------------------------------------ presets and recipe
def test_glm_presets_match_jax_and_resolve():
    for name in ("glm_45_air", "glm_52"):
        t, j = getattr(tglm, name)(), getattr(jglm, name)()
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(tv):  # attention, router, CE config
                assert type(tv).__name__ == type(jv).__name__, f.name
                for g in dataclasses.fields(tv):
                    assert getattr(tv, g.name) == getattr(jv, g.name), f"{f.name}.{g.name}"
            else:
                assert tv == jv, f.name
    cfg = get_model_config("glm-5.2")
    assert isinstance(cfg, tglm.GLMConfig) and cfg.attention.select_granularity == "token"
    assert cfg.attention.qk_head_dim == 256 and cfg.attention.head_dim == 64
    # the MoE models build: the same parameter tree as JAX's
    for name in ("glm_45_air", "glm_52"):
        tspecs = dict(tree_paths(getattr(tglm, name)().build().param_specs()))
        jspecs = dict(tree_paths(getattr(jglm, name)().build().param_specs()))
        assert sorted(tspecs) == sorted(jspecs), name
        assert all(tuple(tspecs[k].shape) == tuple(jspecs[k].shape) for k in jspecs), name


def test_glm52_head_recipe():
    import runpy
    from pathlib import Path

    recipe = Path(tdense.__file__).resolve().parents[1] / "recipes" / "sft_glm52_dsa_head.py"
    tcfg = runpy.run_path(str(recipe))["trainer"]
    model_cfg, glm = tcfg.model_cfg, tglm.glm_52()
    assert type(model_cfg) is tdense.DenseConfig
    for f in dataclasses.fields(model_cfg):
        if f.name not in ("num_hidden_layers", "attention"):
            assert getattr(model_cfg, f.name) == getattr(glm, f.name), f.name
    assert model_cfg.num_hidden_layers == glm.first_k_dense_replace == 3
    assert model_cfg.attention == dataclasses.replace(glm.attention, select_granularity="block",
                                                      index_block=256)
    assert model_cfg.attention.index_top_k // model_cfg.attention.index_block == 8
    assert count_params(model_cfg.build().param_specs()) == GLM52_HEAD_PARAMS
    assert tcfg.dataloader_cfg.pack_max_length == 16384 and tcfg.total_steps == 4
    assert tcfg.mesh_cfg.remat == "full" and model_cfg.lm_loss_cfg.mode == "chunk"
    # JAX builds the same parameter tree from the same fields
    jattn = JDSA(**dataclasses.asdict(model_cfg.attention))
    jfields = {f.name: getattr(model_cfg, f.name) for f in dataclasses.fields(model_cfg)
               if f.name in jdense.DenseConfig.model_fields
               and f.name not in ("attention", "lm_loss_cfg", "float8_cfg")}
    jspecs = dict(tree_paths(jdense.DenseConfig(**jfields, attention=jattn).build()
                             .param_specs()))
    tspecs = dict(tree_paths(model_cfg.build().param_specs()))
    assert sorted(jspecs) == sorted(tspecs)
    assert all(tuple(jspecs[k].shape) == tuple(tspecs[k].shape) for k in jspecs)


def test_unported_dsa_options_raise():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="train-slice"):
        tcfg.build().loss({"embed": {"w": torch.zeros(VOCAB, 64)}, "layers": [{}],
                           "final_norm": torch.ones(64), "lm_head": {"w": torch.zeros(64, VOCAB)}},
                          TSeq.from_input_ids(np.ones((1, 16), np.int32)),
                          torch.zeros(1, 16, dtype=torch.long), torch.ones(1, 16), 16.0,
                          compute_dtype=torch.float32, remat="save_attn_residuals")
    # MoE layers with DSA attention build (tests/test_torch_moe_noaux.py
    # holds them to JAX); a per-layer window pattern builds too, and its
    # training forward still waits for [moe] (the check comes first, before
    # any weight is read)
    moe = tglm.glm_52()
    moe.router = GreedyRouterConfig()
    moe.mtp_num_layers = 0
    assert "idx_q_proj" in moe.build().param_specs()["moe_layers"]["attn"]
    moe.layer_window_pattern = [128, None]
    assert "idx_q_proj" in moe.build().param_specs()["moe_layers"]["attn"]
    with pytest.raises(NotImplementedError, match=r"window pattern.*\[moe\]"):
        moe.build().loss(None, TSeq.from_input_ids(np.ones((1, 16), np.int32)),
                         torch.zeros(1, 16, dtype=torch.long), torch.ones(1, 16), 16.0)
