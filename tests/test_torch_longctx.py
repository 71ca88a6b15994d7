"""The longctx slice of the PyTorch port against the JAX package: the
two-pass dk/dv backward (TPU kernel #4, `XTUNER_ATTN_BWD=two_pass`), remat
"save_out_lse", a tiny MoE under both switches, and the
`recipes/bench_longctx_64k.py` config.

On the CPU the port's kernel wrappers run their plain versions; JAX's
Pallas kernels run in interpret mode, as the JAX package's own tests run
them (`tests/ops/test_flash_attention.py` sets `flash.ATTN_BWD` the same
way; `XTUNER_FUSED_MLP` is read when JAX traces, so each JAX function here
is traced fresh under the setting it tests). Inputs are numpy arrays from a
seed, in f32: the two sides differ only in summation order and exp vs
exp2. Flash gradients within 1e-5 (as tests/test_torch_flash_bwd.py);
model losses and gradient leaves within 1e-5 of each leaf's largest entry,
the 3-step engine curve within 1e-4 relative (as
tests/test_torch_train_step.py); "save_out_lse" against "full" in the port
within 1e-6.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto import SequenceContext as JSeq
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import moe as jmoe
from xtuner_tpu.module.attention import MHAConfig as JMHA
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.parallel.mesh import MeshConfig as JMesh
from xtuner_tpu.parallel.mesh import build_mesh
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import moe as tmoe
from xtuner_tpu_torch.module.attention import MHAConfig as TMHA
from xtuner_tpu_torch.module.params import params_from_numpy, tree_paths
from xtuner_tpu_torch.ops import fused_moe_mlp as tfm
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-5
CURVE_RTOL = 1e-4
POLICY_TOL = 1e-6
BLOCK = 64
VOCAB, SEQ = 512, 256


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


def _packed(b, l, hq, hkv, docs, seed, d=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(16, l - 40), docs - 1, replace=False))
        bounds = [0, *cuts.tolist(), l - int(rng.integers(1, 30))]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


# ------------------------------------------------------ #4, the two-pass dk/dv
@pytest.mark.parametrize("b,hq,hkv,docs,max_logit", [
    (1, 4, 2, 3, 11.3),   # GQA ratio 2, max-free forward
    (2, 8, 2, 2, None),   # GQA ratio 4, running-max forward, two rows
])
def test_two_pass_grads_match_jax(monkeypatch, b, hq, hkv, docs, max_logit):
    monkeypatch.setattr(jflash, "ATTN_BWD", "two_pass")
    monkeypatch.setenv("XTUNER_ATTN_BWD", "two_pass")
    q, k, v, seg = _packed(b, 256, hq, hkv, docs, seed=20 + hq)
    co = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)
    jseg, jco = jnp.asarray(seg), jnp.asarray(co)
    ml = None if max_logit is None else jnp.float32(max_logit)

    def j_loss(q_, k_, v_):
        out = jflash.flash_attention(q_, k_, v_, jseg, max_logit=ml, block_q=BLOCK,
                                     block_k=BLOCK, interpret=True)
        return jnp.sum(out * jco)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                        jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    calls = []
    orig = tflash.flash_bwd
    monkeypatch.setattr(tflash, "flash_bwd", lambda *a, **kw: calls.append(
        "two_pass" if a[8] else "grouped") or orig(*a, **kw))
    tflash.reset_launches()
    tml = None if max_logit is None else torch.tensor(max_logit)
    out, _ = tflash.flash_attention(*leaves, _t(seg), max_logit=tml)
    (out * _t(co)).sum().backward()
    assert calls == ["two_pass"]
    assert tflash.flash_bwd.launches["two_pass"] == 0  # CPU tensors: the plain version
    for got, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


def test_the_switch_is_read_when_the_forward_runs(monkeypatch):
    """The backward runs the path chosen when the graph was built."""
    q, k, v, seg = _packed(1, 128, 4, 2, 2, seed=5)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    calls = []
    orig = tflash.flash_bwd
    monkeypatch.setattr(tflash, "flash_bwd", lambda *a, **kw: calls.append(
        "two_pass" if a[8] else "grouped") or orig(*a, **kw))
    monkeypatch.setenv("XTUNER_ATTN_BWD", "anything but grouped")
    out, _ = tflash.flash_attention(*leaves, _t(seg))
    monkeypatch.setenv("XTUNER_ATTN_BWD", "grouped")
    out.sum().backward()
    assert calls == ["two_pass"]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_two_pass_plain_group_sum_equals_grouped_plain(hq, hkv):
    q, k, v, seg = _packed(2, 128, hq, hkv, 2, seed=7)
    q, k, v, seg = _t(q), _t(k), _t(v), _t(seg)
    scale = 128 ** -0.5
    out, lse = tflash.flash_attention_plain(q, k, v, seg, scale)
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32))
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    dk_h, dv_h = tflash.flash_dkv_two_pass_plain(q, k, v, seg, lse, delta, do, scale)
    assert dk_h.shape == dv_h.shape == q.shape
    dk, dv = tflash.flash_dkv_plain(q, k, v, seg, lse, delta, do, scale)
    np.testing.assert_allclose(tflash.group_sum(dk_h, hkv, k.dtype).numpy(), dk.numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tflash.group_sum(dv_h, hkv, v.dtype).numpy(), dv.numpy(),
                               atol=TOL, rtol=TOL)


# ------------------------------------------------------------- the model
def _cfgs():
    """The tiny JAX and port MoE: 2 layers, hidden 128, 2/1 heads of 128
    (JAX's flash path takes head_dim 128; `attn_impl="pallas"` engages it
    on the CPU), 4 experts top-2, moe_inter 128, vocab 512."""
    common = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_size=128,
                  intermediate_size=256, rope_theta=1e6, moe_intermediate_size=128,
                  n_routed_experts=4, num_experts_per_tok=2, balancing_loss_coef=0.001,
                  z_loss_coef=0.001)
    attn = dict(num_attention_heads=2, num_key_value_heads=1, head_dim=128, qk_norm=True)
    j = jmoe.MoEConfig(**common, attention=JMHA(**attn), lm_loss_cfg=JCE(chunk_size=96),
                       attn_impl="pallas", grouped_gemm_impl="pallas")
    t = tmoe.MoEConfig(**common, attention=TMHA(**attn),
                       lm_loss_cfg=tce.CELossConfig(chunk_size=96))
    return j, t


@functools.lru_cache(maxsize=None)
def _np_params():
    """The tiny model's params from JAX's initialiser as numpy arrays, made
    once per module (read only)."""
    return jax.tree.map(np.asarray, j_init_params(_cfgs()[0].build().param_specs(),
                                                  jax.random.key(0)))


def _packed_batch(rows: int, seed: int):
    """(rows, SEQ) packed batch: 1-3 documents per row and a padded tail."""
    rng = np.random.default_rng(seed)
    packs = []
    for _ in range(rows):
        n_docs = int(rng.integers(1, 4))
        lens = rng.integers(16, SEQ // n_docs, size=n_docs)
        packs.append([{"input_ids": rng.integers(1, VOCAB, size=n), "labels":
                       np.where(rng.random(n) < 0.2, -100, rng.integers(1, VOCAB, size=n))}
                      for n in lens])
    return sft_llm_collator(packs, SEQ)


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def _switches(monkeypatch):
    monkeypatch.setattr(jflash, "ATTN_BWD", "two_pass")
    monkeypatch.setenv("XTUNER_ATTN_BWD", "two_pass")
    monkeypatch.setenv("XTUNER_FUSED_MLP", "1")


def _port_loss(tcfg, np_tree, batch, remat):
    """The port's loss and every gradient leaf, f32 on the CPU."""
    tparams = params_from_numpy(np_tree, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    seq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    out = tcfg.build().loss(tparams, seq, _t(batch["shifted_labels"]),
                            _t(batch["loss_weights"]), float(batch["loss_weights"].sum()),
                            compute_dtype=torch.float32, remat=remat)
    total = out.total_loss()
    total.backward()
    return total.item(), {p: v.grad.numpy() for p, v in leaves.items()}


def test_moe_save_out_lse_with_both_switches_matches_jax(monkeypatch):
    _switches(monkeypatch)
    jcfg, tcfg = _cfgs()
    jmodel = jcfg.build()
    np_tree = _np_params()
    jparams = jax.tree.map(jnp.asarray, np_tree)
    batch = _packed_batch(2, seed=3)
    denom = float(batch["loss_weights"].sum())
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]))

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="save_out_lse")
        return out.total_loss()

    jl, jgrads = jax.jit(jax.value_and_grad(j_fn))(jparams)
    tfm.reset_launches()
    tl, tgrads = _port_loss(tcfg, np_tree, batch, "save_out_lse")
    _close(tl, jl)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jleaves) == sorted(tgrads)
    for path, g in tgrads.items():
        _close(g, jleaves[path], ".".join(path))


def test_train_engine_curve_with_both_switches_matches_jax(monkeypatch):
    """3 optimizer steps of 2 packed rows under remat "save_out_lse" and
    both switches, the clip engaged."""
    _switches(monkeypatch)
    jcfg, tcfg = _cfgs()
    ocfg = dict(lr=2e-3, max_grad_norm=0.05, weight_decay=0.01)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    mesh_cfg = JMesh(fsdp_size=1, param_dtype="float32", remat_policy="save_out_lse")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 3,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.init_random(0)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="save_out_lse"), 3, device="cpu")
    teng.load_params(params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg, "cpu"))
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "maxvio",
            "skipped")
    curves = {"jax": [], "torch": []}
    for step in range(1, 4):
        batch = {k: v[None] for k, v in _packed_batch(2, seed=10 * step).items()}
        jm, tm = jeng.train_step(batch, step), teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
    j, t = np.asarray(curves["jax"]), np.asarray(curves["torch"])
    np.testing.assert_allclose(t, j, rtol=CURVE_RTOL, atol=1e-7)
    assert (t[:, keys.index("skipped")] == 0).all()
    assert (t[:, keys.index("grad_norm")] > ocfg["max_grad_norm"]).all()  # the clip engaged


# ------------------------------------------------------------- the policy
@pytest.mark.parametrize("switched", [False, True])
def test_save_out_lse_equals_full(monkeypatch, switched):
    if switched:
        _switches(monkeypatch)
    _, tcfg = _cfgs()
    np_tree = _np_params()
    batch = _packed_batch(2, seed=4)
    fl, fgrads = _port_loss(tcfg, np_tree, batch, "full")
    sl, sgrads = _port_loss(tcfg, np_tree, batch, "save_out_lse")
    np.testing.assert_allclose(sl, fl, rtol=POLICY_TOL, atol=POLICY_TOL)
    for path, g in fgrads.items():
        np.testing.assert_allclose(sgrads[path], g, rtol=POLICY_TOL,
                                   atol=POLICY_TOL * max(1.0, np.abs(g).max()),
                                   err_msg=".".join(path))


@pytest.mark.parametrize("remat,per_layer", [
    ("save_attn_residuals", {"q_sized": 2, "kv_sized": 2}),  # q and out; k and v
    ("save_out_lse", {"q_sized": 1, "kv_sized": 0}),         # out alone
    ("full", {"q_sized": 0, "kv_sized": 0}),
])
def test_save_out_lse_saves_no_q_k_or_v(remat, per_layer):
    """Count, with a saved-tensors hook, the distinct (B, L, Hq, D)- and
    (B, L, Hkv, D)-shaped tensors kept for the backward outside the
    checkpoint regions (what a checkpoint recomputes never reaches an outer
    hook; what it keeps of its inputs does): under "save_out_lse" one per
    layer, the flash output, and no q, k or v."""
    _, tcfg = _cfgs()
    np_tree = _np_params()
    batch = _packed_batch(2, seed=5)
    tparams = params_from_numpy(np_tree, tcfg, "cpu", torch.float32)
    for _, v in tree_paths(tparams):
        v.requires_grad_(True)
    a = tcfg.attention
    q_shape = (2, SEQ, a.num_attention_heads, a.head_dim)
    kv_shape = (2, SEQ, a.num_key_value_heads, a.head_dim)
    assert q_shape != kv_shape
    saved = set()

    def pack(t):
        saved.add((tuple(t.shape), t.untyped_storage().data_ptr()))
        return t

    seq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tcfg.build().loss(tparams, seq, _t(batch["shifted_labels"]),
                                _t(batch["loss_weights"]), float(batch["loss_weights"].sum()),
                                compute_dtype=torch.float32, remat=remat)
    out.total_loss().backward()
    layers = tcfg.num_hidden_layers
    shapes = [shape for shape, _ in saved]
    assert shapes.count(q_shape) == per_layer["q_sized"] * layers, shapes
    assert shapes.count(kv_shape) == per_layer["kv_sized"] * layers, shapes


def test_other_named_policies_still_raise():
    _, tcfg = _cfgs()
    params = params_from_numpy(_np_params(), tcfg, "cpu")
    for remat in ("dots", "save_attn_residuals_moe", "save_out_lse_moe"):
        with pytest.raises(NotImplementedError, match="train-slice"):
            tcfg.build().loss(params, TSeq.from_input_ids(np.ones((1, 8), np.int32)),
                              torch.zeros(1, 8, dtype=torch.long), torch.ones(1, 8), 8.0,
                              compute_dtype=torch.float32, remat=remat)


# ------------------------------------------------------------- the recipe
def test_recipe_is_bench_longctx_row(monkeypatch):
    """`recipes/bench_longctx_64k.py` equals `bench.py`'s longctx row
    (`_build_cfg(layers=10, moe_inter=128, experts=64, topk=4)`) in every
    field the port's config has; the JAX-only fields (`grouped_gemm_impl`,
    `attn_impl`, HF and MTP options) choose TPU kernels or unported
    features. The run settings are `_run_shape`'s."""
    from xtuner_tpu_torch.datasets.collator import fake_collator
    from xtuner_tpu_torch.recipes import bench_longctx_64k as r

    monkeypatch.delenv("BENCH_CE", raising=False)
    monkeypatch.delenv("BENCH_FP8", raising=False)
    bench = importlib.import_module("bench")
    want = dict(bench._build_cfg(layers=10, moe_inter=128, experts=64, topk=4))
    got = r.model_cfg
    for f in dataclasses.fields(got):
        mine, value = getattr(got, f.name), want[f.name]
        if dataclasses.is_dataclass(mine):  # nested configs: the port's fields
            mine, value = vars(mine), {k: getattr(value, k) for k in vars(mine)}
        assert mine == value, f.name
    assert r.mesh_cfg.remat == "save_out_lse" and r.mesh_cfg.param_dtype == "bfloat16"
    assert (r.optim_cfg.lr, r.lr_cfg.warmup_steps, r.TOTAL_STEPS, r.SEQ) == (1e-5, 2, 100, 65536)
    assert r.SWITCHES == {"XTUNER_ATTN_BWD": "two_pass", "XTUNER_FUSED_MLP": "1"}
    from xtuner_tpu_torch.module.params import count_params

    assert round(count_params(r.model_cfg.build().param_specs()) / 1e6, 1) == 470.8
    flat = fake_collator(1, r.SEQ, r.model_cfg.vocab_size, seed=3)
    got_batch = r.batch(3)
    for k, v in flat.items():
        assert got_batch[k].shape == (1, 1, r.SEQ)
        np.testing.assert_array_equal(got_batch[k][0], v, err_msg=k)
