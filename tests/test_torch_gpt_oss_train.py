"""gpt-oss's training path in the PyTorch port (`xtuner_tpu_torch`) against
the JAX package, on the CPU: the flash backward with a sliding window and
sinks, rollout-routing replay, and gpt-oss-tiny's loss, gradients and
engine curve.

Every input comes from a numpy seed and reaches both packages as the same
arrays; the JAX Pallas kernels run in interpret mode, the port's kernel
wrappers their plain PyTorch versions (CPU tensors). In f32 the two sides
differ only in summation order and exp vs exp2:

- `flash_backward` (delta, the backward kernels' plain versions and
  dsinks) against JAX `_flash_bwd_rule` from JAX's forward residuals
  (lse with the sinks folded in), grouped and two-pass, at (D, Dv) =
  (64, 64) and (8, 8), windows 8 and 16, two documents and a padded
  tail: dq, dk, dv and dsinks within 1e-5; autograd through
  `flash_attention` with the sinks as a leaf against jax.grad: 1e-5;
- `route(forced_idx=)` for the greedy and the noaux router against JAX
  `route`: ids exactly, weights 1e-6;
- one gpt-oss MoE layer with a window and forced routing against JAX
  `_moe_layer_forward(window=, forced_routing=)`, its output and every
  gradient: 1e-5 relative to each leaf's largest entry;
- `MoE.loss` and every gradient leaf with replay, on a tiny model without
  a window pattern (where JAX's replay branch runs): 1e-5;
- gpt-oss-tiny's loss and every gradient leaf (sinks and biases included)
  without and with replay: without it against JAX's `MoE.loss`; with it
  against JAX's own layer function run with the pattern's windows and the
  forced routing, since JAX's forward drops the replay under a window
  pattern (`test_jax_ignores_replay_under_a_window_pattern_and_the_port_
  does_not` shows that, and no JAX value of the faulty path is the port's);
- a 3-step `TrainEngine` curve of gpt-oss-tiny at weight decay 0 against
  JAX's engine, without replay and with it (JAX's step built on a loss
  that passes the replay and the forward above): 1e-4 relative;
- the gpt-oss-20b head recipe: 2 layers of the preset, 2,804,090,688
  params.

The greedy softmax router selects with `torch.topk` where JAX uses
`jax.lax.top_k`; the two break ties differently, so the routers here see
random f32 weights, whose probabilities do not tie.
"""

import dataclasses
import runpy
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto.sequence_context import SequenceContext as JSeq
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import gpt_oss as jgpt
from xtuner_tpu.model.moe import MoEConfig as JMoEConfig
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.module.attention import MHAConfig as JMHA
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.module.rope import _rope_dim as j_rope_dim
from xtuner_tpu.module.rope import model_rope_cos_sin as j_rope_cos_sin
from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.ops.rms_norm import rms_norm as j_rms_norm
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu.parallel.sharding import NULL_SHARD_CTX
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets.collator import sft_llm_collator
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import gpt_oss as tgpt
from xtuner_tpu_torch.model import moe as tmoe
from xtuner_tpu_torch.model.moe import MoEConfig as TMoEConfig
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.module.attention import MHAConfig as TMHA
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.module.rope import _rope_dim, rope_cos_sin
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh

TOL = 1e-5
CURVE_RTOL = 1e-4
BLOCK = 64
VOCAB, SEQ = 128, 64
GPT_OSS_20B_HEAD_PARAMS = 2_804_090_688


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


# ------------------------------------------------------- flash backward
def _two_docs(l, hq, hkv, d, seed):
    """q, k, v (B1, f32), two documents and a padded tail of 19 rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((1, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((1, l, hkv, d), dtype=np.float32)
    seg = np.zeros((1, l), np.int32)
    cut = int(rng.integers(70, 150))
    seg[0, :cut], seg[0, cut:l - 19] = 1, 2
    return q, k, v, seg


@pytest.mark.parametrize("variant", ["grouped", "two_pass"])
@pytest.mark.parametrize("d", [64, 8])
@pytest.mark.parametrize("window", [8, 16])
def test_flash_bwd_window_sinks_matches_jax_bwd_rule(monkeypatch, variant, d, window):
    """`flash_backward` (the backward the autograd function runs) against
    JAX `_flash_bwd_rule` with the same `ATTN_BWD`, both from JAX's
    forward residuals: out and lse with the sinks folded in."""
    monkeypatch.setattr(jflash, "ATTN_BWD", variant)
    hq, hkv = 8, 2
    q, k, v, seg = _two_docs(256, hq, hkv, d, seed=d + window)
    rng = np.random.default_rng(window)
    g = rng.standard_normal(q.shape, dtype=np.float32)
    sinks = (rng.standard_normal(hq) * 2).astype(np.float32)
    scale = d ** -0.5
    heads_first = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    jq, jk, jv, jg = (heads_first(a) for a in (q, k, v, g))
    jseg, jsinks = jnp.asarray(seg), jnp.asarray(sinks)
    out, lse = jflash._flash_forward(jq, jk, jv, jseg, jsinks, None, scale, True, window,
                                     BLOCK, BLOCK, True)
    jdq, jdk, jdv, _, jds, _ = jflash._flash_bwd_rule(
        scale, True, window, BLOCK, BLOCK, True, 0, (jq, jk, jv, jseg, jsinks, out, lse), jg)
    t_out = _t(np.asarray(out).transpose(0, 2, 1, 3))
    dq, dk, dv, dsinks = tflash.flash_backward(_t(q), _t(k), _t(v), _t(seg), t_out,
                                               _t(lse), _t(g), scale, variant, window,
                                               _t(sinks))
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                                   atol=TOL, rtol=TOL, err_msg=name)
        assert (got.numpy()[seg == 0] == 0).all(), name  # padding rows: exactly zero
    np.testing.assert_allclose(dsinks.numpy(), np.asarray(jds), atol=TOL, rtol=TOL)
    assert np.abs(dsinks.numpy()).max() > 1e-3  # the sinks' gradient is exercised


@pytest.mark.parametrize("window", [8, 16])
def test_flash_attention_grads_with_window_and_sinks_match_jax(window):
    """Autograd through `flash_attention` (the plain forward, the fold, the
    backward's plain versions and dsinks) with the sinks as a leaf,
    against jax.grad through JAX's Pallas kernels in interpret mode."""
    q, k, v, seg = _two_docs(256, 4, 2, 64, seed=50 + window)
    rng = np.random.default_rng(51)
    co = rng.standard_normal(q.shape, dtype=np.float32)
    sinks = (rng.standard_normal(4) * 2).astype(np.float32)
    jseg, jco = jnp.asarray(seg), jnp.asarray(co)

    def j_loss(q_, k_, v_, s_):
        out = jflash.flash_attention(q_, k_, v_, jseg, window=window, sinks=s_, block_q=BLOCK,
                                     block_k=BLOCK, interpret=True)
        return jnp.sum(out * jco)

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, sinks)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, sinks)]
    out, _ = tflash.flash_attention(*leaves[:3], _t(seg), window=window, sinks=leaves[3])
    (out * _t(co)).sum().backward()
    for got, w, name in zip(leaves, want, ("q", "k", "v", "sinks")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


# --------------------------------------------------------------- router
@pytest.mark.parametrize("kind", ["greedy", "noaux"])
def test_route_forced_idx_matches_jax(kind):
    """Forced ids where an entry is 0 or more (whole rows, single entries,
    an id fresh routing would not pick), fresh routing elsewhere."""
    rng = np.random.default_rng(3)
    n, h, e, k = 24, 16, 8, 3
    x = rng.standard_normal((n, h), dtype=np.float32)
    p = {"w": rng.standard_normal((h, e), dtype=np.float32) * 0.5}
    if kind == "greedy":
        jc = jrouter.GreedyRouterConfig(routed_scaling_factor=1.5)
        tc = trouter.GreedyRouterConfig(routed_scaling_factor=1.5)
    else:
        p["e_score_correction_bias"] = rng.standard_normal(e, dtype=np.float32) * 0.1
        kw = dict(n_group=2, topk_group=1, routed_scaling_factor=2.5)
        jc, tc = jrouter.NoAuxRouterConfig(**kw), trouter.NoAuxRouterConfig(**kw)
    forced = np.full((n, k), -1, np.int32)
    forced[:8] = rng.integers(0, e, (8, k))
    forced[8:16, 1] = rng.integers(0, e, 8)
    j = jrouter.route(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x), k,
                      forced_idx=jnp.asarray(forced))
    t = trouter.route({a: _t(b) for a, b in p.items()}, tc, _t(x), k, forced_idx=_t(forced))
    np.testing.assert_array_equal(t.topk_idx.numpy(), np.asarray(j.topk_idx))
    np.testing.assert_array_equal(t.topk_idx.numpy()[forced >= 0], forced[forced >= 0])
    for a, b in ((t.topk_weights, j.topk_weights), (t.logits, j.logits), (t.probs, j.probs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    fresh = trouter.route({a: _t(b) for a, b in p.items()}, tc, _t(x), k)
    assert torch.equal(t.topk_idx[16:], fresh.topk_idx[16:])
    assert not torch.equal(t.topk_idx[:8], fresh.topk_idx[:8])


# ---------------------------------------------------------- models
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


def _replay(batch, n_layers: int, k: int, e: int, seed: int):
    """(B, L, n_layers, K) forced ids: distinct random experts at 2 of every
    3 real positions, -1 at the rest and at padding."""
    rng = np.random.default_rng(seed)
    b, l = batch["input_ids"].shape
    ids = np.argsort(rng.random((b, l, n_layers, e)), axis=-1)[..., :k].astype(np.int32)
    keep = (batch["segment_ids"] != 0) & (np.arange(l) % 3 != 0)[None]
    return np.where(keep[..., None, None], ids, -1).astype(np.int32)


def _gpt_oss_cfgs(n_layers: int = 2):
    kw = dict(num_hidden_layers=n_layers, vocab_size=VOCAB, balancing_loss_coef=0.01,
              z_loss_coef=1e-3)
    return (jgpt.gpt_oss_tiny(**kw, lm_loss_cfg=JCE(chunk_size=48)),
            tgpt.gpt_oss_tiny(**kw, lm_loss_cfg=tce.CELossConfig(chunk_size=48)))


def _gpt_oss_tree(jcfg, seed: int = 0):
    """JAX's init with nonzero sinks and q/k/v/o biases (both init at 0)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg.build().param_specs(),
                                                  jax.random.key(seed)))
    attn = tree["moe_layers"]["attn"]
    attn["sinks"] = (rng.standard_normal(attn["sinks"].shape) * 0.5).astype(np.float32)
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        attn[proj]["b"] = (rng.standard_normal(attn[proj]["b"].shape) * 0.1).astype(np.float32)
    return tree


def _replaying_forward(jmodel):
    """JAX's MoE forward under a window pattern, with the replay applied:
    JAX's own layer function `_moe_layer_forward` per layer with the
    pattern's window and the layer's forced routing (what the pattern
    branch would run if it took the replay), in a Python loop."""
    cfg = jmodel.cfg

    def forward(self, params, seq_ctx, sc=NULL_SHARD_CTX, compute_dtype=jnp.bfloat16,
                remat="full"):
        x = jnp.take(params["embed"]["w"], seq_ctx.input_ids, axis=0).astype(compute_dtype)
        cos, sin = j_rope_cos_sin(seq_ctx, j_rope_dim(cfg.attention), cfg.rope_theta,
                                  cfg.rope_scaling_cfg, cfg.max_position_embeddings)
        seg = seq_ctx.segment_ids
        valid = (seg != 0).reshape(-1)
        rre, pattern = seq_ctx.rollout_routed_experts, cfg.layer_window_pattern
        aux = []
        for i in range(params["moe_layers"]["input_norm"].shape[0]):
            lp = jax.tree.map(lambda a: a[i], params["moe_layers"])
            fr = None if rre is None else rre[:, :, i].reshape(-1, rre.shape[-1])
            x, a = self._moe_layer_forward(x, lp, cfg, cos, sin, seg, valid, sc, compute_dtype,
                                           window=pattern[i % len(pattern)], forced_routing=fr)
            aux.append(a)
        self._last_trunk = x
        self._last_aux = tuple(jnp.stack([a[j] for a in aux]) for j in range(3))
        self._last_idx_loss = jnp.float32(0.0)
        x = j_rms_norm(x, params["final_norm"].astype(jnp.float32), cfg.rms_norm_eps,
                       cfg.rms_norm_type == "zero_centered")
        return x.astype(compute_dtype)

    return types.MethodType(forward, jmodel)


def _loss_and_grads_both(jcfg, tcfg, tree, batch, replay=None, j_forward=None, remat="full"):
    """JAX's `MoE.loss` under remat "full" and the port's under `remat`,
    in f32, on one packed batch, held to each other: loss parts, expert
    loads, every gradient leaf. Returns the port's (outputs, param leaves
    with .grad)."""
    jmodel, tmodel = jcfg.build(), tcfg.build()
    if j_forward is not None:
        jmodel.forward = j_forward(jmodel)
    denom = float(batch["loss_weights"].sum())
    rre = None if replay is None else jnp.asarray(replay)
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]), rollout_routed_experts=rre)
    names = ("loss", "sum_ce", "balancing_loss", "z_loss")

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="full")
        return out.total_loss(), ({n: getattr(out, n) for n in names}, out.expert_load)

    (jl, (jparts, jload)), jgrads = jax.value_and_grad(j_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    tparams = params_from_numpy(tree, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]),
                None if replay is None else _t(replay))
    tout = tmodel.loss(tparams, tseq, _t(batch["shifted_labels"]), _t(batch["loss_weights"]),
                       denom, compute_dtype=torch.float32, remat=remat)
    total = tout.total_loss()
    total.backward()
    _close(total.item(), jl, "total")
    for name in names:
        _close(getattr(tout, name).item(), jparts[name], name)
    np.testing.assert_array_equal(tout.expert_load.numpy(), np.asarray(jload))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        _close(v.grad.numpy(), jleaves[path], ".".join(path))
    return tout, leaves


def _used_ids(monkeypatch):
    """Record the expert ids each MoE layer's router returns in the port's
    forward (the first n calls: remat "full" routes again in the
    backward)."""
    used = []
    orig = tmoe.moe_mlp_forward

    def spy(*a, **kw):
        out = orig(*a, **kw)
        used.append(out[1].topk_idx.detach().clone())
        return out

    monkeypatch.setattr(tmoe, "moe_mlp_forward", spy)
    return used


def test_replayed_moe_loss_and_every_grad_leaf_match_jax(monkeypatch):
    """A tiny MoE without a window pattern, where JAX's replay branch
    runs: loss parts, expert loads and every gradient leaf with replay;
    the ids the port's layers use are the forced ones wherever an entry is
    0 or more."""
    kw = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_size=32, intermediate_size=64,
              moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
              balancing_loss_coef=0.01, z_loss_coef=1e-3)
    attn = dict(num_attention_heads=4, num_key_value_heads=2, head_dim=8)
    jcfg = JMoEConfig(**kw, attention=JMHA(**attn), lm_loss_cfg=JCE(chunk_size=48))
    tcfg = TMoEConfig(**kw, attention=TMHA(**attn), lm_loss_cfg=tce.CELossConfig(chunk_size=48))
    tree = jax.tree.map(np.asarray, j_init_params(jcfg.build().param_specs(),
                                                  jax.random.key(1)))
    batch = _packed_batch(2, seed=5)
    replay = _replay(batch, 2, 2, 4, seed=6)
    used = _used_ids(monkeypatch)
    _loss_and_grads_both(jcfg, tcfg, tree, batch, replay)
    for i in range(2):
        forced = replay[:, :, i].reshape(-1, 2)
        np.testing.assert_array_equal(used[i].numpy()[forced >= 0], forced[forced >= 0])


def test_gpt_oss_moe_layer_with_window_and_forced_routing_matches_jax():
    """One gpt-oss MoE layer (window 8, sinks, biases, clipped experts)
    with forced routing against JAX `_moe_layer_forward(window=,
    forced_routing=)`: its output, aux losses, load and the gradients of
    x and of every parameter."""
    jcfg, tcfg = _gpt_oss_cfgs(2)
    tree = _gpt_oss_tree(jcfg, seed=2)
    batch = _packed_batch(1, seed=7)
    replay = _replay(batch, 1, jcfg.num_experts_per_tok, jcfg.n_routed_experts, seed=8)[:, :, 0]
    forced = replay.reshape(-1, replay.shape[-1])
    lp_np = jax.tree.map(lambda a: a[0], tree["moe_layers"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, SEQ, jcfg.hidden_size), dtype=np.float32)
    co = rng.standard_normal(x.shape, dtype=np.float32)
    seg, pos = batch["segment_ids"], batch["position_ids"]
    jmodel = jcfg.build()
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]), segment_ids=jnp.asarray(seg),
                position_ids=jnp.asarray(pos))
    cos, sin = j_rope_cos_sin(jseq, j_rope_dim(jcfg.attention), jcfg.rope_theta,
                              jcfg.rope_scaling_cfg, jcfg.max_position_embeddings)
    jvalid = jnp.asarray(seg != 0).reshape(-1)

    def j_fn(x_, lp):
        y, (bal, zl, load, _) = jmodel._moe_layer_forward(
            x_, lp, jcfg, cos, sin, jnp.asarray(seg), jvalid, NULL_SHARD_CTX, jnp.float32,
            window=8, forced_routing=jnp.asarray(forced))
        return jnp.sum(y * jnp.asarray(co)) + bal + zl, (y, bal, zl, load)

    (_, (jy, jbal, jzl, jload)), jgrads = jax.value_and_grad(j_fn, argnums=(0, 1),
                                                             has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp_np))
    tmodel = tcfg.build()
    tx = _t(x).requires_grad_(True)
    tlp = jax.tree.map(lambda a: _t(a).requires_grad_(True), lp_np)
    tcos, tsin = rope_cos_sin(_t(pos), _rope_dim(tcfg.attention), tcfg.rope_theta,
                              tcfg.rope_scaling_cfg, tcfg.max_position_embeddings)
    tseg = _t(seg)
    fn = tmodel._moe_layer_fn(tcos, tsin, tseg, (tseg != 0).reshape(-1), torch.float32,
                              "full", 8, _t(forced))
    y, bal, zl, load, _ = fn(tx, tlp)
    ((y * _t(co)).sum() + bal + zl).backward()
    _close(y.detach().numpy(), jy, "out")
    _close(bal.item(), jbal, "bal")
    _close(zl.item(), jzl, "z")
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    _close(tx.grad.numpy(), jgrads[0], "dx")
    jl = dict(tree_paths(jax.tree.map(np.asarray, jgrads[1])))
    tl = dict(tree_paths(tlp))
    assert sorted(jl) == sorted(tl)
    for path, v in tl.items():
        _close(v.grad.numpy(), jl[path], ".".join(path))
    assert np.abs(tl[("attn", "sinks")].grad.numpy()).max() > 0


@pytest.mark.parametrize("replayed,remat", [
    (False, "full"), (True, "full"), (False, "none"), (False, "save_attn_residuals"),
    (False, "save_out_lse"), (True, "save_out_lse")])
def test_gpt_oss_tiny_loss_and_every_grad_leaf_match_jax(monkeypatch, replayed, remat):
    """gpt-oss-tiny (window 8 on layer 0, full on layer 1, sinks, biases)
    through `MoE.loss` under each remat policy the port takes (every one
    carries the window and the sinks): without replay against JAX's
    `MoE.loss`; with it against JAX's layer function under the pattern's
    windows and the forced routing (`_replaying_forward`). With replay the
    port's layers use the forced ids wherever an entry is 0 or more."""
    jcfg, tcfg = _gpt_oss_cfgs(2)
    tree = _gpt_oss_tree(jcfg, seed=4)
    batch = _packed_batch(2, seed=11)
    replay = _replay(batch, 2, jcfg.num_experts_per_tok, jcfg.n_routed_experts, seed=12) \
        if replayed else None
    used = _used_ids(monkeypatch)
    _, leaves = _loss_and_grads_both(jcfg, tcfg, tree, batch, replay,
                                     _replaying_forward if replayed else None, remat)
    assert np.abs(leaves[("moe_layers", "attn", "sinks")].grad.numpy()).max() > 0
    assert np.abs(leaves[("moe_layers", "attn", "o_proj", "b")].grad.numpy()).max() > 0
    if replayed:
        for i in range(2):
            forced = replay[:, :, i].reshape(-1, replay.shape[-1])
            np.testing.assert_array_equal(used[i].numpy()[forced >= 0], forced[forced >= 0])


def test_jax_ignores_replay_under_a_window_pattern_and_the_port_does_not():
    """A reference fault (ROADMAP.md, known faults): JAX's `MoE.forward`
    tests `layer_window_pattern` before `rollout_routed_experts`, so for
    gpt-oss (the one model with a pattern, and the one whose routing its
    serving engine records) it routes afresh and drops the replay: its
    expert loads are those of no replay. The port's loads are those of
    the forced ids at every replayed position, in every layer."""
    jcfg, tcfg = _gpt_oss_cfgs(2)
    tree = _gpt_oss_tree(jcfg, seed=6)
    batch = _packed_batch(1, seed=13)
    k, e = jcfg.num_experts_per_tok, jcfg.n_routed_experts
    replay = np.where((batch["segment_ids"] != 0)[..., None, None],
                      np.broadcast_to(np.arange(k, dtype=np.int32), (*batch["segment_ids"].shape,
                                                                     2, k)), -1)
    jmodel, tmodel = jcfg.build(), tcfg.build()
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, tcfg, "cpu", torch.float32)
    loads = {}
    for name, rre in (("fresh", None), ("replay", replay)):
        jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                    segment_ids=jnp.asarray(batch["segment_ids"]),
                    position_ids=jnp.asarray(batch["position_ids"]),
                    rollout_routed_experts=None if rre is None else jnp.asarray(rre))
        jmodel.forward(jparams, jseq, compute_dtype=jnp.float32, remat="none")
        tseq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]),
                    _t(batch["position_ids"]), None if rre is None else _t(rre))
        with torch.no_grad():
            tout = tmodel.loss(tparams, tseq, _t(batch["shifted_labels"]),
                               _t(batch["loss_weights"]), 1.0, compute_dtype=torch.float32,
                               remat="none")
        loads[name] = (np.asarray(jmodel._last_aux[2]), tout.expert_load.numpy())
    # JAX: the replay changed nothing
    np.testing.assert_array_equal(loads["replay"][0], loads["fresh"][0])
    # the port: every real position of every layer went to experts 0..k-1
    n_real = int((batch["segment_ids"] != 0).sum())
    pad = int((batch["segment_ids"] == 0).sum())
    got = loads["replay"][1]
    assert (got[:, :k] >= n_real).all() and got[:, k:].sum() <= pad * k, got
    assert not np.array_equal(got, loads["fresh"][1])
    np.testing.assert_array_equal(loads["fresh"][1], loads["fresh"][0])


def _gpt_oss_engines(replayed: bool):
    ocfg = dict(lr=2e-3, max_grad_norm=1.0, weight_decay=0.0)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    jcfg, tcfg = _gpt_oss_cfgs(2)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 3,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    tree = _gpt_oss_tree(jcfg, seed=8)
    jeng.params = jax.tree.map(jnp.asarray, tree)
    jeng.opt_state = jeng.tx.init(jeng.params)
    if replayed:  # JAX's step on a loss that passes the replay, as its RL loss does
        model = jeng.model
        model.forward = _replaying_forward(model)

        def loss_fn(params, mb, denom):
            seq_ctx = JSeq(input_ids=mb["input_ids"], segment_ids=mb["segment_ids"],
                           position_ids=mb["position_ids"],
                           rollout_routed_experts=mb["rollout_routed_experts"])
            out = model.loss(params, seq_ctx, mb["shifted_labels"], mb["loss_weights"], denom,
                             compute_dtype=jnp.float32, remat="full")
            return out.total_loss(), {"sum_ce": out.sum_ce, "num_tokens": out.num_tokens,
                                      "expert_load": out.expert_load}

        jeng._step_fn = jeng._build_step_fn(loss_fn)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="full"), 3, device="cpu")
    teng.load_params(params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, jeng, teng


@pytest.mark.parametrize("replayed", [False, True])
def test_gpt_oss_tiny_train_engine_curve_matches_jax(replayed):
    """3 optimizer steps of gpt-oss-tiny, A = 2 micro-batches of 1 packed
    row, weight decay 0: total loss, CE, tokens, grad norm, lr and maxvio
    each step, and the sinks after the last."""
    jcfg, jeng, teng = _gpt_oss_engines(replayed)
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "maxvio",
            "skipped")
    curves = {"jax": [], "torch": []}
    for step in range(1, 4):
        micro = [_packed_batch(1, seed=20 * step + a) for a in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        if replayed:
            batch["rollout_routed_experts"] = np.stack([
                _replay(m, 2, jcfg.num_experts_per_tok, jcfg.n_routed_experts, seed=step + a)
                for a, m in enumerate(micro)])
        jm = jeng.train_step(batch, step)
        tm = teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
    np.testing.assert_allclose(np.asarray(curves["torch"]), np.asarray(curves["jax"]),
                               rtol=CURVE_RTOL, atol=1e-7)
    assert not any(np.asarray(curves["torch"])[:, keys.index("skipped")])
    np.testing.assert_allclose(teng.params["moe_layers"]["attn"]["sinks"].numpy(),
                               np.asarray(jeng.params["moe_layers"]["attn"]["sinks"]),
                               rtol=CURVE_RTOL, atol=1e-6)


def test_gpt_oss_20b_head_recipe():
    rdir = Path(tmoe.__file__).resolve().parents[1] / "recipes"
    trainer = runpy.run_path(str(rdir / "sft_gpt_oss_20b_head.py"))["trainer"]
    cfg = trainer.model_cfg
    assert cfg == dataclasses.replace(tgpt.gpt_oss_20b(), num_hidden_layers=2)
    assert cfg.layer_window_pattern == [128, None] and cfg.attention.with_sinks
    assert count_params(cfg.build().param_specs()) == GPT_OSS_20B_HEAD_PARAMS
    assert tmoe.MoE(cfg).moe_windows(2) == [128, None]
    assert trainer.mesh_cfg.remat_policy == "full"
    assert cfg.lm_loss_cfg.mode == "chunk"
    assert trainer.dataloader_cfg.pack_max_length == 8192
