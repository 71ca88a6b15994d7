"""Qwen3.5's serving path in the PyTorch port (`xtuner_tpu_torch`) against
the JAX package, on the CPU.

Every input comes from a numpy seed and reaches both packages as the same
arrays; the JAX Pallas kernels run in interpret mode, the port's kernel
wrappers their plain PyTorch versions (CPU tensors). In f32 the two sides
differ only in summation order and exp vs exp2, so 1e-5 (absolute and
relative), and 1e-4 for what passes through several layers: the
hybrid's logits, states and K/V, and the engine's logprobs (the MoE's
logits, O(1-4), erred up to 7e-5; the port's prefill runs the chunked
recurrence where JAX runs the scan):

- gated attention (`with_gate`: q_proj's (q_h | gate_h) per head, the
  sigmoid gate before o_proj) with zero-centred qk-norm and partial rotary
  0.25: the port's projections, flash attention and `mha_out` against JAX
  `mha_forward`, and `mha_cached_forward` (the prefill) against JAX's;
- the plain #1 at (D, Dv) = (256, 256), both variants, against JAX
  `_flash_forward` in interpret mode, and the 64-key tile plan the
  kernel walks there;
- the plain #5 at D 256 and its split work order against JAX
  `paged_decode_attn` in interpret mode;
- `Hybrid.forward_cached` and `HybridMoE.forward_cached` (a right-padded
  prompt) against JAX's: logits, the linear slots' states and the full
  slots' K/V; `params_from_numpy` on the pattern tree;
- `PagedGenerator.generate` against JAX's engine on tiny hybrids, dense and
  MoE, greedy, prompts off the 64-token bucket and across 16-token blocks,
  more requests than slots, a GRPO pair: equal token ids, logprobs within
  1e-4;
- the reference's routing fault: JAX's hybrid `routed_experts` lacks the
  prompt's row (N - 1 rows, each one token late); the port's has N, and
  its rows 1.. are JAX's rows 0..;
- the registry's preset against JAX `qwen3_5_moe_35b_a3b`: the same tree,
  34,660,610,688 params.

The greedy softmax router selects with `torch.topk` where JAX uses
`jax.lax.top_k`; the two break ties differently, so the router inputs are
random f32 weights, whose probabilities do not tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.loss.ce_loss import CELossConfig as JCELoss
from xtuner_tpu.model import hybrid as jhybrid
from xtuner_tpu.model.generate import GenerateConfig as JGenerateConfig
from xtuner_tpu.model.paged_generate import PagedGenerator as JPagedGenerator
from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module import gated_deltanet as jgdn
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.module.params import count_params as j_count_params
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.ops.attention.paged_decode import paged_decode_attn as j_paged_decode
from xtuner_tpu.parallel.sharding import NULL_SHARD_CTX
from xtuner_tpu_torch.model import hybrid as thybrid
from xtuner_tpu_torch.model.generate import GenerateConfig
from xtuner_tpu_torch.model.paged_generate import PagedGenerator, paged_eligible
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module import gated_deltanet as tgdn
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.module.params import count_params, params_from_numpy
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.ops.attention import paged_decode as tpd

TOL = 1e-5
LP_TOL = 1e-4
EOS, VOCAB = 150, 160


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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# ------------------------------------------------------- gated attention
ATTN = dict(num_attention_heads=4, num_key_value_heads=2, head_dim=16, qk_norm=True,
            with_gate=True, rms_norm_type="zero_centered", partial_rotary_factor=0.25)


def _gated_params(hidden, seed):
    rng = np.random.default_rng(seed)
    hq, hkv, d = 4, 2, 16
    p = {"q_proj": {"w": rng.standard_normal((hidden, 2 * hq * d)) * 0.3},
         "k_proj": {"w": rng.standard_normal((hidden, hkv * d)) * 0.3},
         "v_proj": {"w": rng.standard_normal((hidden, hkv * d)) * 0.3},
         "o_proj": {"w": rng.standard_normal((hq * d, hidden)) * 0.3},
         "q_norm": rng.standard_normal(d) * 0.2, "k_norm": rng.standard_normal(d) * 0.2}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def test_gated_attention_matches_jax_mha_forward():
    """Packed rows of three documents: the port's training-side pieces
    (projections with the gate, flash attention with the qk-norm bound,
    `mha_out` with the gate) against JAX `mha_forward`."""
    hidden, b, l = 32, 2, 96
    p = _gated_params(hidden, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, l, hidden)).astype(np.float32)
    seg = np.ones((b, l), np.int32)
    seg[0, 40:] = 2
    seg[1, 70:] = 3
    seg[1, 90:] = 0
    pos = np.concatenate([np.arange(40), np.arange(56)])[None].repeat(b, 0).astype(np.int32)
    jcfg, tcfg = jattn.MHAConfig(**ATTN), tattn.MHAConfig(**ATTN)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), jcfg.rope_dim, 1e7)
    want = jattn.mha_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), jcos, jsin,
                             jnp.asarray(seg), NULL_SHARD_CTX)
    tp = jax.tree.map(_t, p)
    tcos, tsin = trope.rope_cos_sin(_t(pos), tcfg.rope_dim, 1e7)
    assert tcfg.rope_dim == 4
    q, k, v, gate = tattn.project_qkv(tp, tcfg, _t(x), tcos, tsin)
    assert gate.shape == q.shape
    gq, gk = 1.0 + tp["q_norm"], 1.0 + tp["k_norm"]
    bound = 16 ** 0.5 * gq.abs().max() * gk.abs().max()
    o, _ = tflash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), _t(seg),
                                  max_logit=bound)
    got = tattn.mha_out(tp, tcfg, o, gate=gate)
    valid = seg != 0
    _close(got.numpy()[valid], np.asarray(want)[valid])
    # the gate matters: without it the output differs
    assert not np.allclose(tattn.mha_out(tp, tcfg, o).numpy()[valid], np.asarray(want)[valid],
                           atol=1e-2)


def test_gated_prefill_matches_jax():
    """`mha_cached_forward` at cache_len 0 with the gate, on a prompt of 45
    tokens right-padded to 64: out at real rows, the cache below the
    prompt length."""
    hidden, pb, p_len = 32, 64, 45
    p = _gated_params(hidden, 2)
    x = np.random.default_rng(3).standard_normal((1, pb, hidden)).astype(np.float32)
    pos = np.minimum(np.arange(pb), p_len - 1)[None].astype(np.int32)
    kv_mask = (np.arange(pb) < p_len)[None]
    jcfg, tcfg = jattn.MHAConfig(**ATTN), tattn.MHAConfig(**ATTN)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 4, 1e7)
    zeros = jnp.zeros((1, pb, 2, 16), jnp.float32)
    jo, jck, jcv = jattn.mha_cached_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                                            jcos, jsin, zeros, zeros, jnp.int32(0),
                                            kv_mask=jnp.asarray(kv_mask))
    tcos, tsin = trope.rope_cos_sin(_t(pos), 4, 1e7)
    ck, cv = torch.zeros((1, pb, 2, 16)), torch.zeros((1, pb, 2, 16))
    to, _, _ = tattn.mha_cached_forward(jax.tree.map(_t, p), tcfg, _t(x), tcos, tsin, ck, cv,
                                        0, kv_mask=_t(kv_mask))
    _close(to.numpy()[:, :p_len], np.asarray(jo)[:, :p_len])
    _close(ck.numpy()[:, :p_len], np.asarray(jck)[:, :p_len])
    _close(cv.numpy()[:, :p_len], np.asarray(jcv)[:, :p_len])


# ------------------------------------------------ #1 at (256, 256)
def _packed256(b=1, l=300, hq=4, hkv=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, 256), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, 256), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, 256), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    seg[:, :100] = 1
    seg[:, 100:170] = 2
    seg[:, 170:290] = 3
    return q, k, v, seg


@pytest.mark.parametrize("max_free", [False, True])
def test_flash_forward_256_matches_jax(max_free):
    """The plain forward at (256, 256) (what the wrapper runs on the CPU)
    against JAX `_flash_forward` in interpret mode, with the running max
    or a max-free bound (unit-scale q and k keep every scaled logit far
    below 45): out at real rows, lse everywhere (1e30 at padding)."""
    q, k, v, seg = _packed256()
    l = q.shape[1]
    lp = -(-l // 128) * 128
    padq = ((0, 0), (0, 0), (0, lp - l), (0, 0))
    jq, jk, jv = (jnp.pad(jnp.swapaxes(jnp.asarray(a), 1, 2), padq) for a in (q, k, v))
    jseg = jnp.pad(jnp.asarray(seg), ((0, 0), (0, lp - l)))
    bound = jnp.float32(40.0) if max_free else None
    jout, jlse = jflash._flash_forward(jq, jk, jv, jseg, None, bound, 256 ** -0.5, True, None,
                                       128, 128, True)
    jout = np.swapaxes(np.asarray(jout), 1, 2)[:, :l]
    out, lse = tflash.flash_attention(_t(q), _t(k), _t(v), _t(seg),
                                      max_logit=torch.tensor(40.0) if max_free else None)
    valid = seg != 0
    _close(out.numpy()[valid], jout[valid])
    _close(lse.numpy(), np.asarray(jlse)[:, :, :l])
    np.testing.assert_array_equal(out.numpy()[~valid], 0.0)


def test_fwd_tile_plan_256_walks_64_key_tiles():
    """At (256, 256) the kernel walks 64-key tiles: the plan never skips a
    tile with a visible pair, walks none wholly above a q tile's last row,
    and marks full exactly the tiles below both halves inside the q
    tile's one document; at 128-key tiles it is the plan it was."""
    assert tflash.fwd_key_tile(256, 256) == 64 and tflash.fwd_key_tile(128, 128) == 128
    l = 700
    seg = np.zeros((2, l), np.int32)
    for bi, lens in enumerate(([600], [17, 300, 90, 140, 5])):
        off = 0
        for i, n in enumerate(lens):
            seg[bi, off:off + n] = i + 1
            off += n
    walk, full = (t.numpy() for t in tflash.fwd_tile_plan(_t(seg), key_tile=64))
    lp = -(-l // 128) * 128
    seg_p = np.pad(seg, ((0, 0), (0, lp - l)))
    same = (seg_p[:, :, None] == seg_p[:, None, :]) & (seg_p[:, :, None] != 0)
    vis = same & (np.arange(lp)[:, None] >= np.arange(lp)[None, :])
    m = vis.reshape(2, lp // 128, 128, lp // 64, 64)
    any_vis, all_vis = m.any(axis=(2, 4)), m.all(axis=(2, 4))
    assert walk.shape == (2, lp // 128, lp // 64)
    np.testing.assert_array_equal(walk & any_vis, any_vis)
    q_last = 128 * np.arange(lp // 128)[:, None] + 127
    assert not (walk & (64 * np.arange(lp // 64)[None, :] > q_last)).any()
    assert not (full & ~all_vis).any() and full.any()
    w128, f128 = tflash.fwd_tile_plan(_t(seg))
    assert w128.shape == (2, lp // 128, lp // 128)


# -------------------------------------------------- #5 at D 256
def test_paged_decode_256_matches_jax():
    """The gather plain version and the split work order (1, 2, 3 and 64
    splits) at head dim 256, rep 8 (Qwen3.5's 16/2 heads), against JAX's
    kernel in interpret mode: lengths on both sides of block edges, an
    inactive slot."""
    rng = np.random.default_rng(4)
    bs, hq, hkv, d, nb, mb = 16, 16, 2, 256, 24, 5
    pk = rng.standard_normal((2, nb, bs, hkv, d), dtype=np.float32)
    pv = rng.standard_normal((2, nb, bs, hkv, d), dtype=np.float32)
    q = rng.standard_normal((4, 1, hq, d), dtype=np.float32)
    lens = np.array([47, 0, 15, 63], np.int32)
    table = np.zeros((4, mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for bi, n in enumerate(lens):
        for t in range(-(-(int(n) + 1) // bs) if n else 0):
            table[bi, t] = free.pop()
    scale = d ** -0.5
    want = np.asarray(j_paged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), 1,
                                     jnp.asarray(table), jnp.asarray(lens), scale=scale,
                                     interpret=True))
    args = (_t(q), _t(pk), _t(pv), 1, _t(table), _t(lens))
    live = lens > 0
    _close(tpd.paged_decode_attn(*args, scale=scale).numpy()[live], want[live])
    for splits in (1, 2, 3, 64):
        _close(tpd.paged_decode_split_plain(*args, scale=scale, splits=splits).numpy()[live],
               want[live])
    assert 256 in tpd.HEAD_DIMS


# ----------------------------------------------------- the hybrid models
def _cfg_fields(moe: bool, pattern, n_layers):
    kw = dict(vocab_size=VOCAB, num_hidden_layers=n_layers, hidden_size=32, eos_token_id=EOS,
              rms_norm_type="zero_centered", rope_theta=1e7)
    attn = dict(ATTN)
    gdn = dict(num_v_heads=4, num_k_heads=2, head_k_dim=8, head_v_dim=8, conv_kernel_size=4)
    jkw = dict(kw, layer_types_pattern=list(pattern), lm_loss_cfg=JCELoss(chunk_size=64),
               attention=jattn.MHAConfig(**attn),
               linear_attention=jgdn.GatedDeltaNetConfig(**gdn))
    tkw = dict(kw, layer_types_pattern=list(pattern), attention=tattn.MHAConfig(**attn),
               linear_attention=tgdn.GatedDeltaNetConfig(**gdn))
    if moe:
        extra = dict(moe_intermediate_size=16, n_routed_experts=4, num_experts_per_tok=2,
                     n_shared_experts=1, with_shared_expert_gate=True, intermediate_size=0)
        return (jhybrid.HybridMoEConfig(router=jrouter.GreedyRouterConfig(), **extra, **jkw),
                thybrid.HybridMoEConfig(router=trouter.GreedyRouterConfig(), **extra, **tkw))
    return (jhybrid.HybridConfig(intermediate_size=64, **jkw),
            thybrid.HybridConfig(intermediate_size=64, **tkw))


def _tiny_pair(moe: bool, seed: int = 3, pattern=("linear", "full"), n_layers=4):
    """A tiny hybrid in both packages with one weight tree: JAX's init,
    every matrix redrawn at std 0.3 (so greedy decoding does not collapse
    to one token), the norms, a_log and dt_bias drawn away from their
    init."""
    jcfg, tcfg = _cfg_fields(moe, pattern, n_layers)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(jcfg.build().param_specs(), jax.random.key(seed)))

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        std = 0.2 if ("norm" in name or "a_log" in name or "dt_bias" in name) else 0.3
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tree


@pytest.mark.parametrize("moe", [False, True])
def test_hybrid_forward_cached_matches_jax(moe):
    """The prefill forward on a prompt of 21 tokens right-padded to 32:
    logits at real rows, every linear slot's state and conv buffer, every
    full slot's K/V below the prompt length; the port's routing is the
    (B, C, nL, K) expert ids in HF layer order."""
    jcfg, jparams, tcfg, tree = _tiny_pair(moe)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    pb, p_len = 32, 21
    ids = np.zeros((1, pb), np.int32)
    ids[0, :p_len] = np.random.default_rng(5).integers(2, 140, size=p_len)
    pos = np.minimum(np.arange(pb), p_len - 1)[None].astype(np.int32)
    kv_mask = (np.arange(pb) < p_len)[None]
    jmodel, tmodel = jcfg.build(), tcfg.build()
    jl, jc, jr = jmodel.forward_cached(jparams, jnp.asarray(ids), jnp.asarray(pos),
                                       jmodel.init_decode_cache(1, pb, jnp.float32),
                                       jnp.int32(0), jnp.float32, jnp.asarray(kv_mask),
                                       n_valid=jnp.asarray([p_len]))
    assert jr is None  # JAX returns no routing (the reference fault)
    tl, tc, tr = tmodel.forward_cached(tparams, _t(ids).long(), _t(pos),
                                       tmodel.init_decode_cache(1, pb, torch.float32, "cpu"),
                                       0, torch.float32, _t(kv_mask), record_routing=True,
                                       n_valid=torch.tensor([p_len]))
    _close(tl.numpy()[:, :p_len], np.asarray(jl)[:, :p_len], LP_TOL)
    for i, kind in enumerate(jcfg.layer_types_pattern):
        key = f"p{i}"
        if kind == "linear":
            _close(tc[key][0], jc[key][0], LP_TOL)
            _close(tc[key][1], jc[key][1], LP_TOL)
        else:
            _close(tc[key][0].numpy()[:, :, :p_len], np.asarray(jc[key][0])[:, :, :p_len],
                   LP_TOL)
            _close(tc[key][1].numpy()[:, :, :p_len], np.asarray(jc[key][1])[:, :, :p_len],
                   LP_TOL)
    if moe:
        assert tr.shape == (1, pb, 4, 2)
        assert ((tr >= 0) & (tr < 4)).all()
    else:
        assert tr is None
    with pytest.raises(NotImplementedError, match=r"\[hybrid\]"):
        tmodel.forward(tparams, None)


def test_params_from_numpy_takes_the_pattern_tree():
    jcfg, _, tcfg, tree = _tiny_pair(True)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    assert sorted(tparams["pattern"]) == ["p0", "p1"]
    assert tuple(tparams["pattern"]["p1"]["attn"]["q_proj"]["w"].shape) == (2, 32, 128)
    assert tuple(tparams["pattern"]["p0"]["shared_expert_gate"]["w"].shape) == (2, 32, 1)
    np.testing.assert_array_equal(tparams["pattern"]["p0"]["attn"]["conv_w"].numpy(),
                                  tree["pattern"]["p0"]["attn"]["conv_w"])
    bad = jax.tree.map(lambda a: a, tree)
    bad["pattern"]["p0"]["attn"]["a_log"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="a_log"):
        params_from_numpy(bad, tcfg, "cpu")
    del bad["pattern"]["p1"]
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(bad, tcfg, "cpu")


def _requests():
    """6 requests on 2 slots: prompts off the 64-token bucket and across
    the 16-token blocks, a GRPO pair sharing a ragged prompt of 21, one
    prompt of one token, one with a small budget."""
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 140, size=21).tolist()
    return [{"prompt_ids": [(3 + i) % 140 for i in range(14)]},
            {"prompt_ids": shared, "group": "g"}, {"prompt_ids": shared, "group": "g"},
            {"prompt_ids": rng.integers(2, 140, size=70).tolist(), "max_new_tokens": 6},
            {"prompt_ids": [5]},
            {"prompt_ids": rng.integers(2, 140, size=33).tolist()}]


def _greedy(cls):
    return cls(max_new_tokens=10, do_sample=False, temperature=0.0, eos_token_id=EOS,
               max_length=256, prefix_cache=False)


def _engines(moe, record=False, pattern=("linear", "full"), n_layers=4):
    jcfg, jparams, tcfg, tree = _tiny_pair(moe, pattern=pattern, n_layers=n_layers)
    kw = dict(max_batch=2, block_size=16, record_routing=record)
    jeng = JPagedGenerator(jcfg.build(), jparams, _greedy(JGenerateConfig),
                           compute_dtype=jnp.float32, **kw)
    teng = PagedGenerator(tcfg.build(), params_from_numpy(tree, tcfg, "cpu"),
                          _greedy(GenerateConfig), compute_dtype=torch.float32, **kw)
    return jeng, teng


@pytest.mark.parametrize("moe,pattern,n_layers", [
    (False, ("linear", "full"), 4),
    (True, ("linear", "full"), 4),
    (True, ("linear", "linear", "linear", "full"), 4),  # Qwen3.5's pattern, one period
])
def test_paged_generate_hybrid_matches_jax(moe, pattern, n_layers):
    reqs = _requests()
    jeng, teng = _engines(moe, pattern=pattern, n_layers=n_layers)
    assert paged_eligible(teng.model.cfg) and teng.is_hybrid
    assert teng.cache.pool_k.shape[0] == pattern.count("full") * n_layers // len(pattern)
    want, got = jeng.generate(reqs), teng.generate(reqs)
    assert len({tuple(o["token_ids"]) for o in got}) > 3  # decoding did not collapse
    for w, g in zip(want, got):
        assert g["token_ids"] == w["token_ids"]
        assert g["finish_reason"] == w["finish_reason"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], atol=LP_TOL)
    assert got[1]["token_ids"] == got[2]["token_ids"]  # the GRPO pair, greedy
    assert not teng.cache.tables


def test_jax_hybrid_routing_lacks_the_prefill_row_and_the_port_does_not():
    """JAX's hybrid prefill returns no routing, so a request's
    `routed_experts` starts with the first decode step's row: N - 1 rows
    for N generated tokens, each one token late. The port records the
    prompt's last position first: N rows, and its rows 1.. are JAX's rows
    0... Its first row is the routing a fresh prefill gives at that
    position."""
    reqs = _requests()
    jeng, teng = _engines(True, record=True)
    want, got = jeng.generate(reqs), teng.generate(reqs)
    n_moe = 4
    for req, w, g in zip(reqs, want, got):
        n = len(g["token_ids"])
        assert g["token_ids"] == w["token_ids"]
        assert g["routed_experts"].shape == (n, n_moe, 2)
        assert w["routed_experts"].shape == (n - 1, n_moe, 2)
        np.testing.assert_array_equal(g["routed_experts"][1:], w["routed_experts"])
        if req.get("group") is None:
            model, p = teng.model, teng.params
            ids = torch.tensor([req["prompt_ids"]])
            _, _, r = model.forward_cached(
                p, ids, torch.arange(ids.shape[1])[None],
                model.init_decode_cache(1, ids.shape[1], torch.float32, "cpu"), 0,
                torch.float32, record_routing=True)
            np.testing.assert_array_equal(g["routed_experts"][0], r[0, -1].numpy())


def test_qwen35_preset_matches_jax():
    """The registry's "qwen3.5-moe-35b-a3b" builds JAX's tree: the same
    paths and shapes, 34,660,610,688 params, and the same config fields."""
    tcfg = get_model_config("qwen3.5-moe-35b-a3b")
    jcfg = jhybrid.qwen3_5_moe_35b_a3b()
    tspecs, jspecs = tcfg.build().param_specs(), jcfg.build().param_specs()
    assert count_params(tspecs) == j_count_params(jspecs) == 34_660_610_688

    def shapes(specs):
        flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: hasattr(x, "shape"))
        return {jax.tree_util.keystr(p): tuple(s.shape) for p, s in flat[0]}

    assert shapes(tspecs) == shapes(jspecs)
    for name in ("vocab_size", "num_hidden_layers", "hidden_size", "eos_token_id",
                 "rms_norm_type", "rope_theta", "n_routed_experts", "n_shared_experts",
                 "num_experts_per_tok", "moe_intermediate_size", "balancing_loss_coef",
                 "with_shared_expert_gate", "layer_types_pattern", "max_position_embeddings"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for sub in ("attention", "linear_attention"):
        tsub, jsub = getattr(tcfg, sub), getattr(jcfg, sub)
        for f in dataclasses.fields(tsub):
            assert getattr(tsub, f.name) == getattr(jsub, f.name), (sub, f.name)
    assert tcfg.attention.rope_dim == 64
    assert tcfg.rope_scaling_cfg.rope_type == "qwen3_vl"
    assert trope.text_rope_scaling(tcfg.rope_scaling_cfg) is None
