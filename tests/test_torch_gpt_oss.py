"""gpt-oss's serving path in the PyTorch port (`xtuner_tpu_torch`) against
the JAX package, on the CPU.

Every input comes from a numpy seed and reaches both packages as the same
arrays; the JAX Pallas kernels run in interpret mode, the port's kernel
wrappers their plain PyTorch versions (CPU tensors). In fp32 the two sides
differ only in summation order and exp vs exp2:

- `swiglu_clipped`: elementwise, 1e-6;
- `moe_mlp_forward` with clipped experts: 1e-5;
- the flash forward with a sliding window and sinks against JAX
  `_flash_forward` (interpret), out and lse, at head dims 16 and 64,
  windows 8, 128 and none, packed documents with padding: 1e-5;
- `fwd_tile_plan` with a window against JAX `_tile_full` and a brute-force
  mask (exact);
- the paged decode's plain version and its split work order against JAX
  `paged_decode_attn(window=, sinks=, interpret=True)` at head dim 64, C 1
  and 2, ragged lengths on both sides of block edges and an empty slot:
  1e-5;
- `mha_cached_forward` (the prefill) with sinks and a window: 1e-5;
- the whole slice on `gpt_oss_tiny` (f32, 2 and 4 layers, window 8, sinks
  0.5 + arange, nonzero biases) through `params_from_numpy`: greedy
  `PagedGenerator` with `record_routing` gives the JAX engine's tokens and
  `routed_experts`, logprobs within 1e-4 (fp32 sums through 4 layers and a
  127-way log-softmax), and its tokens are the argmax of the JAX training
  forward over the whole sequence (JAX `test_gpt_oss_window_pattern_decode_
  matches_training_forward`).

The greedy softmax router selects with `torch.topk` where JAX uses
`jax.lax.top_k`; the two break ties differently, so the router inputs here
are random f32 weights, whose probabilities do not tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.data_proto.sequence_context import SequenceContext as JSeq
from xtuner_tpu.model import gpt_oss as jgpt
from xtuner_tpu.model.generate import GenerateConfig as JGenerateConfig
from xtuner_tpu.model.paged_generate import PagedGenerator as JPagedGenerator
from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module import moe_layer as jmoe_layer
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.module.params import count_params as j_count_params
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.ops import act_fn as jact
from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.ops.attention.paged_decode import paged_decode_attn as j_paged_decode
from xtuner_tpu_torch.data_proto.sequence_context import SequenceContext as TSeq
from xtuner_tpu_torch.model import gpt_oss as tgpt
from xtuner_tpu_torch.model.generate import GenerateConfig, layer_windows
from xtuner_tpu_torch.model.paged_generate import PagedGenerator
from xtuner_tpu_torch.model.registry import get_model_config
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module import moe_layer as tmoe_layer
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.module.params import count_params, params_from_numpy
from xtuner_tpu_torch.ops import act_fn as tact
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.ops.attention import paged_decode as tpd
from xtuner_tpu_torch.ops.attention.reference import make_attention_mask

TOL = 1e-5
LP_TOL = 1e-4
EOS, VOCAB = 126, 127


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


# ------------------------------------------------------------ leaf ops
def test_swiglu_clipped_matches_jax():
    rng = np.random.default_rng(0)
    gate = (rng.standard_normal((64, 96)) * 6).astype(np.float32)  # past +-7 both ways
    up = (rng.standard_normal((64, 96)) * 6).astype(np.float32)
    want = np.asarray(jact.swiglu_clipped(jnp.asarray(gate), jnp.asarray(up)))
    got = tact.swiglu_clipped(_t(gate), _t(up)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tact.gated_act(_t(gate), _t(up), "swiglu_clipped").numpy(),
                               want, atol=1e-6, rtol=1e-6)


def test_moe_mlp_forward_clipped_experts_matches_jax():
    h, f, e, k = 64, 48, 8, 2
    rng = np.random.default_rng(11)
    # gate and up of std ~4, so both clips act; a small down projection
    # keeps the output O(1), where f32 sums agree to 1e-5
    experts = {name: (rng.standard_normal(shape) * std).astype(np.float32)
               for name, shape, std in (("gate_proj", (e, h, f), 0.5), ("up_proj", (e, h, f), 0.5),
                                        ("down_proj", (e, f, h), 0.02))}
    router = {"w": (rng.standard_normal((h, e)) * 0.3).astype(np.float32)}
    x = rng.standard_normal((2, 24, h)).astype(np.float32)
    jout, _, jload = jmoe_layer.moe_mlp_forward(
        jax.tree.map(jnp.asarray, experts), jax.tree.map(jnp.asarray, router),
        jrouter.GreedyRouterConfig(), jnp.asarray(x), num_experts=e, top_k=k,
        act="swiglu_clipped", compute_dtype=jnp.float32)
    tex = {n: _t(v) for n, v in experts.items()}
    out, _, load = tmoe_layer.moe_mlp_forward(
        tex, {"w": _t(router["w"])}, trouter.GreedyRouterConfig(), _t(x), num_experts=e,
        top_k=k, act="swiglu_clipped", compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    gate = np.einsum("lh,ehf->elf", x.reshape(-1, h), experts["gate_proj"])
    assert (gate > 7).any() and (gate < -7).any()  # the clips are exercised
    # the gate|up buffer the engine lays out: views, the same values, no copy
    tmoe_layer.fuse_gate_up(tex)
    gu = tmoe_layer.gate_up_weight(tex, torch.float32)
    assert gu.data_ptr() == tex["gate_proj"].data_ptr() and gu.is_contiguous()
    np.testing.assert_array_equal(gu.numpy(), np.concatenate(
        [experts["gate_proj"], experts["up_proj"]], axis=2))
    fused, _, _ = tmoe_layer.moe_mlp_forward(
        tex, {"w": _t(router["w"])}, trouter.GreedyRouterConfig(), _t(x), num_experts=e,
        top_k=k, act="swiglu_clipped", compute_dtype=torch.float32)
    assert torch.equal(fused, out)


# ------------------------------------------------------- flash forward
def _packed(b, l, hq, hkv, d, seed):
    """q, k, v (f32) and segment ids: 3 documents a row, then padding."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(16, l - 48), 2, replace=False))
        bounds = [0, *cuts.tolist(), l - int(rng.integers(1, 24))]
        for si in range(3):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("window", [8, 128, None])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_flash_forward_window_sinks_matches_jax(d, window, with_sinks):
    """The plain forward with the window and the sinks folded in (what the
    wrapper runs on the CPU) against JAX `_flash_forward` in interpret
    mode: out at real rows, lse everywhere (1e30 at padding), out 0 at
    padding."""
    q, k, v, seg = _packed(2, 256, 8, 2, d, seed=d + (window or 0))
    sinks = (np.random.default_rng(9).standard_normal(8) * 2).astype(np.float32) \
        if with_sinks else None
    scale = d ** -0.5
    jout, jlse = jflash._flash_forward(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)), jnp.asarray(seg),
        None if sinks is None else jnp.asarray(sinks), None, scale, True, window, 128, 128,
        True)
    jout = np.swapaxes(np.asarray(jout), 1, 2)
    out, lse = tflash.flash_attention(_t(q), _t(k), _t(v), _t(seg), window=window,
                                      sinks=None if sinks is None else _t(sinks))
    valid = seg != 0
    np.testing.assert_allclose(out.numpy()[valid], jout[valid], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out.numpy()[~valid], 0.0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL, rtol=TOL)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(np.swapaxes(lse.numpy(), 1, 2)[~valid],
                                  np.float32(tflash.BIG_LSE))


def test_flash_backward_with_window_or_sinks_raises():
    """The backward takes a window and sinks (the split kernels at 64/64
    and 192/128 and every plain version). What still raises is a window
    at (128, 128), whose one-pass kernel takes none, and only for CUDA
    tensors: on the CPU the plain version runs it, with the sinks too."""
    q, k, v, seg = _packed(1, 128, 4, 2, 128, seed=4)
    tq, ts = _t(q).requires_grad_(True), torch.zeros(4, requires_grad=True)
    out, _ = tflash.flash_attention(tq, _t(k), _t(v), _t(seg), window=8, sinks=ts)
    out.sum().backward()
    assert torch.isfinite(tq.grad).all() and ts.grad is not None
    bf = [_t(a).bfloat16() for a in (q, k, v)]
    lse = torch.zeros((1, 4, 128))
    args = (*bf, _t(seg), lse, lse, bf[0], "flash_bwd")
    tflash._check_bwd_args(*args)  # no window: the one pass takes it
    with pytest.raises(ValueError, match=r"\(128, 128\) takes no sliding window"):
        tflash._check_bwd_args(*args, window=8)
    for d in (64, 192):  # the split kernels' pairs take one
        dv = 128 if d == 192 else d
        qd, kd, vd = (torch.zeros((1, 128, h, x), dtype=torch.bfloat16)
                      for h, x in ((4, d), (2, d), (2, dv)))
        tflash._check_bwd_args(qd, kd, vd, _t(seg), lse, lse,
                               torch.zeros((1, 128, 4, dv), dtype=torch.bfloat16), "b", 8)


def _jax_tile_plan(seg_p: np.ndarray, window: int, tile: int):
    """JAX `_tile_full` with the window per (q tile, k tile)."""
    b, lp = seg_p.shape
    nt = lp // tile
    tiles = jnp.asarray(seg_p.reshape(b, nt, tile))
    ii, jj = (jnp.asarray(a.ravel()) for a in np.meshgrid(np.arange(nt), np.arange(nt),
                                                          indexing="ij"))

    def row(t):
        return jax.vmap(lambda i, j: jflash._tile_full(i, j, t[i], t[j], True, window,
                                                       tile, tile))(ii, jj)

    return np.asarray(jax.jit(jax.vmap(row))(tiles)).reshape(b, nt, nt)


@pytest.mark.parametrize("window", [8, 128, 200, 384])
def test_fwd_tile_plan_window_matches_jax_tile_full(window):
    """The windowed walk never skips a tile with a visible pair and walks
    none without one; full exactly as JAX `_tile_full` with the window
    (documents of 1-700 rows, a padded tail, L not a multiple of 128)."""
    tile = tflash.KEY_TILE
    l = 1100
    seg = np.zeros((2, l), np.int32)
    for bi, lens in enumerate(([1000], [17, 300, 90, 640, 5])):
        off = 0
        for i, n in enumerate(lens):
            seg[bi, off:off + n] = i + 1
            off += n
    walk, full = (t.numpy() for t in tflash.fwd_tile_plan(_t(seg), window))
    lp = -(-l // tile) * tile
    seg_p = np.pad(seg, ((0, 0), (0, lp - l)))
    mask = make_attention_mask(_t(seg_p), causal=True, window=window)[:, 0].numpy()
    m = mask.reshape(2, lp // tile, tile, lp // tile, tile)
    any_vis, all_vis = m.any(axis=(2, 4)), m.all(axis=(2, 4))
    np.testing.assert_array_equal(walk & any_vis, any_vis)  # no visible tile skipped
    # a walked tile without a visible pair only where the segment ranges
    # meet inside the window but the documents do not (as without a window)
    no_window_walk, _ = (t.numpy() for t in tflash.fwd_tile_plan(_t(seg)))
    assert not (walk & ~no_window_walk).any()
    q0 = tile * np.arange(lp // tile)[:, None]
    k_last = tile * np.arange(lp // tile)[None, :] + tile - 1
    assert not (walk & (k_last <= q0 - window)).any()  # nothing wholly outside the window
    assert not (full & ~all_vis).any()
    np.testing.assert_array_equal(full, _jax_tile_plan(seg_p, window, tile) & walk)


# -------------------------------------------------------- paged decode
BS, D = 16, 64


def _paged_case(c, seed=0):
    """4 slots over a 2-layer pool at head dim 64, rep 4: lengths on both
    sides of block edges (15 | 16, 47 | 48 with C 2) and one inactive slot
    (seq_len 0, an all-zero table: the trash block 0)."""
    rng = np.random.default_rng(seed)
    hq, hkv, nb, mb = 8, 2, 24, 5
    pk = rng.standard_normal((2, nb, BS, hkv, D), dtype=np.float32)
    pv = rng.standard_normal((2, nb, BS, hkv, D), dtype=np.float32)
    q = rng.standard_normal((4, c, hq, D), dtype=np.float32)
    lens = np.array([47, 0, 15, 63], np.int32)
    table = np.zeros((4, mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for bi, n in enumerate(lens):
        if n == 0:
            continue
        for t in range(-(-(int(n) + c) // BS)):
            table[bi, t] = free.pop()
    sinks = (0.5 + np.arange(hq, dtype=np.float32)) / 2
    return q, pk, pv, table, lens, sinks


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("window", [None, 8, 16, 20])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_paged_decode_window_sinks_matches_jax(c, window, with_sinks):
    """The gather plain version and the kernel's split work order (1, 2, 3
    and 64 splits over the in-window blocks) against JAX's kernel in
    interpret mode. The inactive slot's output is what the engine
    discards: it is held only where sinks make it defined (zero)."""
    q, pk, pv, table, lens, sinks = _paged_case(c, seed=c)
    sinks = sinks if with_sinks else None
    scale = D ** -0.5
    want = np.asarray(j_paged_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), 1, jnp.asarray(table),
        jnp.asarray(lens), scale=scale, window=window,
        sinks=None if sinks is None else jnp.asarray(sinks), interpret=True))
    ts = None if sinks is None else _t(sinks)
    args = (_t(q), _t(pk), _t(pv), 1, _t(table), _t(lens))
    live = lens > 0
    got = tpd.paged_decode_attn(*args, scale=scale, window=window, sinks=ts).numpy()
    np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)
    for splits in (1, 2, 3, 64):
        split = tpd.paged_decode_split_plain(*args, scale=scale, splits=splits, window=window,
                                             sinks=ts).numpy()
        np.testing.assert_allclose(split[live], want[live], atol=TOL, rtol=TOL,
                                   err_msg=f"splits={splits}")
        if with_sinks:
            np.testing.assert_allclose(split[~live], want[~live], atol=TOL)


def test_paged_decode_window_walk_and_plan():
    """The walk starts at JAX's `_start_block` and splits only the blocks
    in the window; a window of 128 over blocks of 128 leaves at most two
    blocks a slot, so the plan takes at most two splits per slot."""
    bs = 128
    for n in (0, 1, 126, 127, 128, 129, 255, 256, 1000, 4095):
        n_blk = -(-(n + 1) // bs)
        start = tpd.start_block(n, 128, bs)
        assert start == max(n + 1 - 128, 0) // bs
        assert 1 <= n_blk - start <= tpd.max_window_blocks(128, 1, bs) == 2
        runs = tpd.paged_decode_splits(n_blk, 8, start)
        assert runs[0][0] == start and runs[-1][1] == n_blk
        assert all(t1 - t0 == 1 for t0, t1 in runs)
    assert tpd.start_block(1000, None, bs) == tpd.start_block(1000, 0, bs) == 0
    assert tpd.paged_decode_splits(3, 2, 3) == [(3, 3)]  # nothing left: one empty run
    table = torch.arange(1, 33, dtype=torch.int32).reshape(4, 8)
    walk = tpd.paged_decode_walk(table, torch.tensor([5, 200, 513, 1000]), 1, bs, 64, 2,
                                 window=128)
    assert [[blk for run in w for _, blk in run] for w in walk] == \
        [[1], [9, 10], [20, 21], [31, 32]]
    assert tpd.paged_decode_split_plan(4, 8, tpd.max_window_blocks(128, 1, bs), 132) == 2


def test_paged_decode_head_dims_the_kernel_takes():
    assert tpd.HEAD_DIMS == (64, 128, 256)  # 256: Qwen3.5 (tests/test_torch_qwen35.py)
    q, pk, pv, table, lens, sinks = _paged_case(1)
    bf = {n: _t(a).bfloat16() for n, a in (("q", q), ("pk", pk), ("pv", pv))}
    tpd._check_kernel_args(bf["q"], bf["pk"], bf["pv"], 0, _t(table), _t(lens), _t(sinks))
    with pytest.raises(ValueError, match="head_dim"):
        tpd._check_kernel_args(bf["q"][..., :32].contiguous(), bf["pk"][..., :32].contiguous(),
                               bf["pv"][..., :32].contiguous(), 0, _t(table), _t(lens), None)
    with pytest.raises(ValueError, match="sinks"):
        tpd._check_kernel_args(bf["q"], bf["pk"], bf["pv"], 0, _t(table), _t(lens),
                               _t(sinks[:4]))


# ------------------------------------------------------------- prefill
@pytest.mark.parametrize("window", [None, 8])
def test_prefill_with_sinks_and_window_matches_jax(window):
    """`mha_cached_forward` at cache_len 0 on a right-padded prompt with
    gpt-oss's attention (head dim 64, qkv and o biases, sinks) against
    JAX's: out at real rows, the cache below the prompt length."""
    rng = np.random.default_rng(5)
    hidden, hq, hkv, d = 48, 4, 2, 64
    p = {
        "q_proj": {"w": rng.standard_normal((hidden, hq * d)) * 0.2,
                   "b": rng.standard_normal(hq * d) * 0.1},
        "k_proj": {"w": rng.standard_normal((hidden, hkv * d)) * 0.2,
                   "b": rng.standard_normal(hkv * d) * 0.1},
        "v_proj": {"w": rng.standard_normal((hidden, hkv * d)) * 0.2,
                   "b": rng.standard_normal(hkv * d) * 0.1},
        "o_proj": {"w": rng.standard_normal((hq * d, hidden)) * 0.2,
                   "b": rng.standard_normal(hidden) * 0.1},
        "sinks": 0.5 + np.arange(hq) / 2,
    }
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    kw = dict(num_attention_heads=hq, num_key_value_heads=hkv, head_dim=d, with_sinks=True,
              qkv_bias=True, o_bias=True)
    b, pb, p_len = 1, 64, 45
    x = rng.standard_normal((b, pb, hidden)).astype(np.float32)
    pos = np.minimum(np.arange(pb), p_len - 1)[None].astype(np.int32)
    kv_mask = (np.arange(pb) < p_len)[None]
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), d, 1.5e5)
    zeros = jnp.zeros((b, pb, hkv, d), jnp.float32)
    jo, jck, _ = jattn.mha_cached_forward(
        jax.tree.map(jnp.asarray, p), jattn.MHAConfig(**kw), jnp.asarray(x), jcos, jsin,
        zeros, zeros, jnp.int32(0), window=window, kv_mask=jnp.asarray(kv_mask))
    tcos, tsin = trope.rope_cos_sin(_t(pos), d, 1.5e5)
    ck, cv = torch.zeros((b, pb, hkv, d)), torch.zeros((b, pb, hkv, d))
    to, _, _ = tattn.mha_cached_forward(
        jax.tree.map(_t, p), tattn.MHAConfig(**kw), _t(x), tcos, tsin, ck, cv, 0,
        window=window, kv_mask=_t(kv_mask))
    np.testing.assert_allclose(to.numpy()[:, :p_len], np.asarray(jo)[:, :p_len], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ck.numpy()[:, :p_len], np.asarray(jck)[:, :p_len], atol=TOL)


# ---------------------------------------------------------- the slice
def _tiny_pair(n_layers: int, seed: int = 3):
    """gpt_oss_tiny in both packages (window 8 on even layers) with one
    weight tree: JAX's init, matrices redrawn with std 0.3 so that greedy
    decoding does not collapse to one token, sinks 0.5 + arange / 4,
    nonzero q/k/v/o biases."""
    kw = dict(num_hidden_layers=n_layers, eos_token_id=EOS, vocab_size=VOCAB)
    jcfg, tcfg = jgpt.gpt_oss_tiny(**kw), tgpt.gpt_oss_tiny(**kw)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(jcfg.build().param_specs(), jax.random.key(seed)))

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "sinks" in name or "['b']" in name:
            return a
        return (rng.standard_normal(a.shape) * 0.3).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    attn = tree["moe_layers"]["attn"]
    attn["sinks"] = (0.5 + np.arange(n_layers * 4, dtype=np.float32).reshape(n_layers, 4) / 4)
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        attn[proj]["b"] = (rng.standard_normal(attn[proj]["b"].shape) * 0.1).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, tcfg, "cpu")


def _requests():
    """5 requests on 2 slots: prompts past the window of 8 and across the
    16-token block edges, a GRPO pair sharing a ragged prompt, one short
    prompt with a small budget."""
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 120, size=21).tolist()
    return [{"prompt_ids": [(3 + i) % 120 for i in range(14)]},
            {"prompt_ids": shared, "group": "g"}, {"prompt_ids": shared, "group": "g"},
            {"prompt_ids": rng.integers(2, 120, size=33).tolist(), "max_new_tokens": 6},
            {"prompt_ids": [5, 6, 7]}]


def _greedy(cls):
    return cls(max_new_tokens=12, do_sample=False, temperature=0.0, eos_token_id=EOS,
               max_length=256, prefix_cache=False)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_paged_generate_gpt_oss_matches_jax(n_layers):
    jcfg, jparams, tcfg, tparams = _tiny_pair(n_layers)
    assert layer_windows(tcfg, "moe_layers", n_layers) == [8, 0] * (n_layers // 2)
    reqs = _requests()
    want = JPagedGenerator(jcfg.build(), jparams, _greedy(JGenerateConfig), max_batch=2,
                           block_size=16, compute_dtype=jnp.float32,
                           record_routing=True).generate(reqs)
    teng = PagedGenerator(tcfg.build(), tparams, _greedy(GenerateConfig), max_batch=2,
                          block_size=16, compute_dtype=torch.float32, record_routing=True)
    got = teng.generate(reqs)
    assert len({tuple(o["token_ids"]) for o in got}) > 2  # decoding did not collapse
    for w, g in zip(want, got):
        assert g["token_ids"] == w["token_ids"]
        assert g["finish_reason"] == w["finish_reason"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], atol=LP_TOL)
        assert g["routed_experts"].shape == (len(g["token_ids"]), n_layers, 2)
        np.testing.assert_array_equal(g["routed_experts"], w["routed_experts"])
    assert not teng.cache.tables
    # no routed_experts without record_routing
    plain = PagedGenerator(tcfg.build(), tparams, _greedy(GenerateConfig), max_batch=2,
                           block_size=16, compute_dtype=torch.float32).generate(reqs[:1])
    assert "routed_experts" not in plain[0]
    assert plain[0]["token_ids"] == got[0]["token_ids"]


def test_gpt_oss_window_pattern_decode_matches_training_forward():
    """The port's greedy tokens are the argmax of JAX's TRAINING forward
    over the whole sequence, with the context well past the window of 8:
    the windows are honoured at decode as in training."""
    jcfg, jparams, tcfg, tparams = _tiny_pair(2)
    prompt = [(3 + i) % 120 for i in range(14)]
    out = PagedGenerator(tcfg.build(), tparams, _greedy(GenerateConfig), max_batch=2,
                         block_size=16, compute_dtype=torch.float32).generate(
        [{"prompt_ids": prompt}])[0]
    seq = np.asarray(prompt + out["token_ids"], np.int32)
    jmodel = jcfg.build()
    hidden = jmodel.forward(jparams, JSeq.from_input_ids(seq[None]),
                            compute_dtype=jnp.float32, remat="none")
    logits = np.asarray(hidden @ jmodel.lm_head_weight(jparams))
    for t in range(len(prompt), len(seq)):
        assert int(np.argmax(logits[0, t - 1])) == int(seq[t]), f"drift at {t}"


def test_gpt_oss_presets_match_jax():
    """The registry's gpt-oss presets build the JAX trees: the same param
    paths and shapes (20,908,120,896 params at 20b), and the port's
    training forward takes the window pattern and the sinks (what it
    still refuses is a replay tensor for another number of MoE layers;
    tests/test_torch_gpt_oss_train.py holds the training to JAX)."""
    for name, jfn in (("gpt-oss-20b", jgpt.gpt_oss_20b), ("gpt-oss-120b", jgpt.gpt_oss_120b)):
        tspecs = get_model_config(name).build().param_specs()
        jspecs = jfn().build().param_specs()
        assert count_params(tspecs) == j_count_params(jspecs)
        jshapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       jspecs, is_leaf=lambda x: hasattr(x, "shape"))[0]}
        tshapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       tspecs, is_leaf=lambda x: hasattr(x, "shape"))[0]}
        assert tshapes == jshapes
    assert count_params(get_model_config("gpt-oss-20b").build().param_specs()) == 20_908_120_896
    _, _, tcfg, tparams = _tiny_pair(2)
    seq = TSeq.from_input_ids(np.ones((1, 16), np.int32))
    out = tcfg.build().loss(tparams, seq, torch.zeros(1, 16, dtype=torch.long),
                            torch.ones(1, 16), 16.0, compute_dtype=torch.float32)
    assert torch.isfinite(out.loss)
    seq.rollout_routed_experts = torch.zeros((1, 16, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="rollout_routed_experts"):
        tcfg.build().loss(tparams, seq, torch.zeros(1, 16, dtype=torch.long),
                          torch.ones(1, 16), 16.0, compute_dtype=torch.float32)
