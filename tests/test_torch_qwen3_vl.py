"""Qwen3-VL's training path in the PyTorch port (`xtuner_tpu_torch`) against
the JAX package, on the CPU.

Every input comes from a numpy seed and reaches both packages as the same
arrays; the JAX Pallas flash kernels run in interpret mode, the port's
kernel wrappers their plain PyTorch versions (CPU tensors), and JAX's
vision tower its reference attention (its head dims are not multiples of
128). In f32 the two sides differ only in summation order and exp vs
exp2, so 1e-5 (absolute and relative to each array's largest entry,
`TOL`) for the ops, the vision features, the loss parts and every
gradient leaf, and 1e-4 relative for the engine curves (`CURVE_RTOL`).
The host-side numpy helpers and the data plane must agree exactly.

- the plain #1-#4 with `causal=False` at head dim 64 against JAX's
  `_flash_forward` and `_flash_bwd_rule` in interpret mode, grouped and
  two-pass, group 1 and 2: several segments, a segment shorter than a
  tile, a padded tail; `fwd_tile_plan(causal=False)` against JAX's
  `_tile_full` and the dense mask, and its counts;
- `gelu` / `gelu_pytorch_tanh`, `layer_norm`, `build_mrope_positions`,
  `smart_resize`, `preprocess_image`, `vision_geometry`;
- `qwen3vl_vision_forward`'s final and deepstack features;
- `Qwen3VLModel.loss` and every gradient leaf against `jax.grad` of JAX's,
  dense and MoE text, the port at remat "none" and "full";
- `Qwen3VLTokenizeFn` and `qwen3vl_collator`, field by field, and the
  packed data plane of `DataloaderConfig.build` (no sample split);
- a 3-step `TrainEngine` curve against JAX's engine, and a
  `freeze_vision` run whose vision leaves do not move;
- the reference fault: JAX's toy tokenizer breaks `Qwen3VLTokenizeFn`,
  the port's Trainer-built one does not;
- the recipe `recipes/sft_qwen3_vl_4b.py`: 4,437,815,808 params.
"""

import dataclasses
import functools
import json
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
from xtuner_tpu.datasets import qwen_vl as jqv
from xtuner_tpu.engine.train_engine import TrainEngine as JEngine
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import dense as jdense
from xtuner_tpu.model import moe as jmoe
from xtuner_tpu.model import qwen3_vl as jvl
from xtuner_tpu.model.vision import layer_norm as j_layer_norm
from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.module import router as jrouter
from xtuner_tpu.module.params import count_params as j_count_params
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.ops import act_fn as jact
from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.parallel.mesh import MeshConfig, build_mesh
from xtuner_tpu.train.toy_tokenizer import UTF8ByteTokenizer as JTok
from xtuner_tpu_torch.config import optim as toptim
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets import qwen_vl as tqv
from xtuner_tpu_torch.datasets.config import DataloaderConfig, DatasetConfig
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.engine.train_engine import _leaf_views
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model import dense as tdense
from xtuner_tpu_torch.model import moe as tmoe
from xtuner_tpu_torch.model import qwen3_vl as tvl
from xtuner_tpu_torch.model.vision import layer_norm as t_layer_norm
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.module import router as trouter
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.ops import act_fn as tact
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.ops.attention.reference import make_attention_mask
from xtuner_tpu_torch.parallel.mesh import MeshConfig as TMesh
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer as TTok
from xtuner_tpu_torch.train.trainer import Trainer

TOL = 1e-5
CURVE_RTOL = 1e-4
BLOCK = 64
TILE = tflash.KEY_TILE
VL_SPECIALS = ["<|vision_start|>", "<|image_pad|>", "<|vision_end|>"]
VOCAB = 280
PATCH_ROWS = 512  # max_patches of the tiny batches
GRID_SIDE = 4  # the tiny tower's 16 position embeddings
RECIPE_PARAMS = 4_437_815_808


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
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


def _packed_seg(l, lens):
    """(1, l) segment ids: documents of `lens` from position 0, then padding."""
    seg = np.zeros((1, l), np.int32)
    bounds = np.cumsum([0, *lens])
    for i in range(len(lens)):
        seg[0, bounds[i]:bounds[i + 1]] = i + 1
    return seg


# ------------------------------------------------------- non-causal flash
@pytest.mark.parametrize("variant", ["grouped", "two_pass"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_noncausal_flash_matches_jax(monkeypatch, variant, hq, hkv):
    """The plain forward (out, lse) and `flash_bwd` (then the group sum for
    two-pass) with `causal=False` at head dim 64 against JAX's
    `_flash_forward` and `_flash_bwd_rule` with `causal=False` and the
    same `ATTN_BWD`: segments of 5, 60 and 100 rows (one shorter than a
    tile, one across tiles), a padded tail of 27; padding rows exactly
    zero."""
    monkeypatch.setattr(jflash, "ATTN_BWD", variant)
    d, l = 64, 192
    rng = np.random.default_rng(40 + hq)
    q, g = (rng.standard_normal((1, l, hq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, l, hkv, d), dtype=np.float32) for _ in range(2))
    seg = _packed_seg(l, [5, 60, 100])
    scale = d ** -0.5
    heads_first = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    jq, jk, jv, jg = (heads_first(a) for a in (q, k, v, g))
    out, lse = jflash._flash_forward(jq, jk, jv, jnp.asarray(seg), None, None, scale, False,
                                     None, BLOCK, BLOCK, True)
    want = jflash._flash_bwd_rule(scale, False, None, BLOCK, BLOCK, True, 0,
                                  (jq, jk, jv, jnp.asarray(seg), None, out, lse), jg)[:3]
    valid = seg != 0
    tout, tlse = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(seg), scale,
                                              causal=False)
    _close(tout.numpy()[valid], np.asarray(out).transpose(0, 2, 1, 3)[valid], "out")
    _close(tlse.numpy().transpose(0, 2, 1)[valid],
           np.asarray(lse).transpose(0, 2, 1)[valid], "lse")
    do = _t(g)
    delta = (do * _t(out).transpose(1, 2)).sum(-1).transpose(1, 2).contiguous()
    got = tflash.flash_bwd(_t(q), _t(k), _t(v), _t(seg), _t(lse), delta, do, scale,
                           variant == "two_pass", causal=False)
    if variant == "two_pass":
        assert got[1].shape == q.shape and got[2].shape == q.shape
        got = tuple((got[0], *(tflash.group_sum(t, hkv, t.dtype) for t in got[1:])))
    for t, w, name in zip(got, want, "qkv"):
        _close(t.numpy(), np.asarray(w).transpose(0, 2, 1, 3), f"d{name}")
        assert (t.numpy()[seg == 0] == 0).all(), name
    # a causal call differs: the keys above the diagonal count here
    cout, _ = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(seg), scale)
    assert not np.allclose(cout.numpy()[valid], tout.numpy()[valid])


def _jax_full_noncausal(seg_p):
    """JAX's `_tile_full` with causal=False per (q tile, k tile), (B, nt, nt)."""
    b, lp = seg_p.shape
    nt = lp // TILE
    tiles = jnp.asarray(seg_p.reshape(b, nt, TILE))
    ii, jj = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")

    def row(t):
        return jax.vmap(lambda i, j: jflash._tile_full(i, j, t[i], t[j], False, None, TILE,
                                                        TILE))(jnp.asarray(ii.ravel()),
                                                               jnp.asarray(jj.ravel()))

    return np.asarray(jax.jit(jax.vmap(row))(tiles)).reshape(b, nt, nt)


@pytest.mark.parametrize("l,lens", [
    (1000, [17, 3, 90, 64, 1, 200, 33]),  # documents below a tile, a padded tail
    (1500, [1500]),                       # one long document: every tile full
    (768, [256, 384, 128]),               # boundaries on tile edges
    (4198, [1, 100, 4097]),               # the vision phase's odd row
    (65, [30, 20]),                       # L < 128
])
def test_noncausal_tile_plan_matches_jax_and_the_mask(l, lens):
    """Walked: exactly the tiles that hold a visible pair (the ids of a
    packed row rise); full: exactly JAX's `_tile_full(causal=False)`, and
    every pair of a full tile is visible."""
    seg = _packed_seg(l, lens)
    walk, full = (t.numpy() for t in tflash.fwd_tile_plan(_t(seg), causal=False))
    lp = -(-l // TILE) * TILE
    seg_p = np.pad(seg, ((0, 0), (0, lp - l)))
    nt = lp // TILE
    mask = make_attention_mask(_t(seg_p), causal=False)[:, 0].numpy().reshape(1, nt, TILE,
                                                                               nt, TILE)
    np.testing.assert_array_equal(walk, mask.any(axis=(2, 4)))
    np.testing.assert_array_equal(full, _jax_full_noncausal(seg_p))
    assert not (full & ~mask.all(axis=(2, 4))).any()


def test_noncausal_tile_plan_counts():
    """Two documents of two tiles each and a padding tile: each document's
    q tiles walk both of its k tiles, all full; the padding tile none."""
    seg = torch.tensor([[1] * 256 + [2] * 256 + [0] * 128], dtype=torch.int32)
    walk, full = tflash.fwd_tile_plan(seg, causal=False)
    want = np.zeros((5, 5), bool)
    want[:2, :2] = want[2:4, 2:4] = True
    np.testing.assert_array_equal(walk[0].numpy(), want)
    np.testing.assert_array_equal(full[0].numpy(), want)
    cwalk, cfull = tflash.fwd_tile_plan(seg)
    assert int(cwalk.sum()) == 6 and int(cfull.sum()) == 2  # causal: half of it


# ------------------------------------------------------------- leaf ops
def test_gelus_and_layer_norm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 33)).astype(np.float32) * 3
    for name in ("gelu", "gelu_pytorch_tanh", "silu"):
        _close(tact.get_act_fn(name)(_t(x)).numpy(), jact.get_act_fn(name)(jnp.asarray(x)),
               name)
    _close(tact.gelu_exact(_t(x)).numpy(), jax.nn.gelu(jnp.asarray(x), approximate=False))
    for name in ("relu", "quick_gelu"):
        with pytest.raises(NotImplementedError, match=r"\[leaf-ops\]"):
            tact.get_act_fn(name)
    w, b = rng.standard_normal(33).astype(np.float32), rng.standard_normal(33).astype(np.float32)
    for eps in (1e-6, 1e-5):
        _close(t_layer_norm(_t(x), _t(w), _t(b), eps).numpy(),
               j_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps))
    got = t_layer_norm(_t(x).bfloat16(), _t(w), _t(b))
    assert got.dtype == torch.bfloat16


def test_host_helpers_match_jax():
    """`smart_resize`, `preprocess_image`, `vision_geometry` and
    `build_mrope_positions`: the same numpy code, so the same values."""
    for hw in ((512, 512), (768, 1024), (100, 37), (3000, 40), (17, 19)):
        assert tvl.smart_resize(*hw) == jvl.smart_resize(*hw)
        assert tvl.smart_resize(*hw, 28, 3136, 12845056) == jvl.smart_resize(
            *hw, 28, 3136, 12845056)
    rng = np.random.default_rng(6)
    grids = []
    for hw in ((40, 40), (30, 70)):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        kw = dict(patch_size=4, merge_size=2, min_pixels=32 * 32, max_pixels=64 * 64)
        tp, tg = tvl.preprocess_image(img, **kw)
        jp, jg = jvl.preprocess_image(img, **kw)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tg, jg)
        grids.append(tg)
    grids.append(np.array([2, 4, 6]))  # two frames
    for total in (None, 400):
        tgeo = tvl.vision_geometry(grids, GRID_SIDE, 2, total)
        jgeo = jvl.vision_geometry(grids, GRID_SIDE, 2, total)
        assert sorted(tgeo) == sorted(jgeo)
        for key in tgeo:
            np.testing.assert_array_equal(tgeo[key], jgeo[key], key)
    ids = rng.integers(0, 200, 60)
    mask = np.zeros(60, bool)
    mask[5:5 + 25] = True  # 10 x 10 patches merged -> 25 tokens
    mask[40:40 + 12] = True  # 2 frames of 4 x 6 merged -> 12
    g = np.array([[1, 10, 10], [2, 4, 6]])
    np.testing.assert_array_equal(trope.build_mrope_positions(ids, mask, g),
                                  jrope.build_mrope_positions(ids, mask, g))


# -------------------------------------------------------------- the model
VISION = dict(depth=3, hidden_size=16, intermediate_size=32, num_attention_heads=2,
              patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
              num_position_embeddings=16, deepstack_visual_indexes=[0, 1])
ATTN = dict(num_attention_heads=4, num_key_value_heads=2, head_dim=8)


def _cfgs(moe: bool):
    """A tower of 3 blocks (deepstack after 0 and 1, 2 heads of 8) over 3
    text layers (dense or MoE), interleaved MRoPE [2, 1, 1], the toy
    tokenizer's vision ids; the JAX and the port configs."""
    tok = TTok(VL_SPECIALS)
    ids = dict(image_token_id=tok.special_ids["<|image_pad|>"],
               video_token_id=tok.special_ids["<|image_pad|>"],
               vision_start_token_id=tok.special_ids["<|vision_start|>"],
               vision_end_token_id=tok.special_ids["<|vision_end|>"])
    kw = dict(vocab_size=VOCAB, num_hidden_layers=3, hidden_size=32, intermediate_size=64)
    jkw = dict(kw, attention=jattn.MHAConfig(**ATTN), lm_loss_cfg=JCE(chunk_size=64),
               rope_scaling_cfg=jrope.RopeScalingConfig(rope_type="qwen3_vl",
                                                        mrope_section=[2, 1, 1]))
    tkw = dict(kw, attention=tattn.MHAConfig(**ATTN), lm_loss_cfg=tce.CELossConfig(chunk_size=64),
               rope_scaling_cfg=trope.RopeScalingConfig(rope_type="qwen3_vl",
                                                        mrope_section=[2, 1, 1]))
    if moe:
        extra = dict(moe_intermediate_size=16, n_routed_experts=4, num_experts_per_tok=2,
                     balancing_loss_coef=0.01, z_loss_coef=1e-3)
        jtext = jmoe.MoEConfig(router=jrouter.GreedyRouterConfig(), **extra, **jkw)
        ttext = tmoe.MoEConfig(router=trouter.GreedyRouterConfig(), **extra, **tkw)
    else:
        jtext, ttext = jdense.DenseConfig(**jkw), tdense.DenseConfig(**tkw)
    return (jvl.Qwen3VLConfig(vision_cfg=jvl.Qwen3VLVisionConfig(**VISION), text_cfg=jtext,
                              **ids),
            tvl.Qwen3VLConfig(vision_cfg=tvl.Qwen3VLVisionConfig(**VISION), text_cfg=ttext,
                              **ids))


def _tree(jcfg, seed: int):
    """JAX's param tree with every leaf redrawn (std 0.3, norms 0.2), so no
    gradient is zero by symmetry."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_params(jcfg.build().param_specs(), jax.random.key(seed)))

    def redraw(path, a):
        std = 0.2 if "norm" in jax.tree_util.keystr(path) else 0.3
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _items(rng, n: int):
    """Chats with one image of 40 x 40 or 30 x 70 before or after the text
    (and a text-only one every third)."""
    items = []
    for i in range(n):
        text = {"type": "text", "text": f"what is in picture {i}? " * (1 + i % 2)}
        if i % 3 == 2:
            user = {"role": "user", "content": f"no picture here, item {i}"}
        else:
            img = rng.integers(0, 256, ((40, 40), (30, 70))[i % 2] + (3,), dtype=np.uint8)
            parts = [{"type": "image", "image": img}, text]
            user = {"role": "user", "content": parts if i % 2 == 0 else parts[::-1]}
        items.append({"messages": [user, {"role": "assistant", "content": f"answer {i} " * 3}]})
    return items


def _fn(pkg):
    if pkg == "jax":
        return jqv.Qwen3VLTokenizeFn(JTok(VL_SPECIALS), "qwen", patch_size=4, merge_size=2,
                                     min_pixels=32 * 32, max_pixels=64 * 64)
    return tqv.Qwen3VLTokenizeFn(TTok(VL_SPECIALS), "qwen", patch_size=4, merge_size=2,
                                 min_pixels=32 * 32, max_pixels=64 * 64)


def _batch(seed: int, rows: int, per_row: int, l: int = 512):
    """A collated batch of `rows` packs of `per_row` samples (port's fn and
    collator; held to JAX's in `test_tokenize_and_collate_match_jax`)."""
    rng = np.random.default_rng(seed)
    fn = _fn("torch")
    samples = [fn(it) for it in _items(rng, rows * per_row)]
    packs = [samples[r * per_row:(r + 1) * per_row] for r in range(rows)]
    return tqv.qwen3vl_collator(packs, l, max_patches=PATCH_ROWS, num_grid_per_side=GRID_SIDE)


def _jseq(batch):
    keys = ("pixel_values", "image_token_mask", "mrope_positions", "vision_segment_ids",
            "vision_rot_pos", "vision_pos_interp_idx", "vision_pos_interp_w")
    return JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]),
                **{k: jnp.asarray(batch[k]) for k in keys})


def _tseq(batch):
    keys = ("pixel_values", "image_token_mask", "mrope_positions", "vision_segment_ids",
            "vision_rot_pos", "vision_pos_interp_idx", "vision_pos_interp_w")
    return TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]),
                **{k: _t(batch[k]) for k in keys})


def test_vision_forward_matches_jax():
    """The final features and both deepstack features of the tower, over
    the images of two packed rows and padded patch rows."""
    jcfg, tcfg = _cfgs(False)
    tree = _tree(jcfg, seed=3)
    batch = _batch(7, rows=2, per_row=2)
    assert batch["vision_segment_ids"].max() >= 2 and (batch["vision_segment_ids"] == 0).any()
    jfinal, jds = jax.jit(lambda p, seq: jvl.qwen3vl_vision_forward(
        p, jcfg.vision_cfg, seq, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, tree["vision"]), _jseq(batch))
    tparams = params_from_numpy(tree, tcfg, "cpu")
    with torch.no_grad():
        tfinal, tds = tvl.qwen3vl_vision_forward(tparams["vision"], tcfg.vision_cfg,
                                                 _tseq(batch), torch.float32)
    assert len(tds) == len(jds) == 2
    for got, want, name in ((tfinal, jfinal, "final"), *((a, b, f"ds{i}") for i, (a, b) in
                                                          enumerate(zip(tds, jds)))):
        _close(got.numpy(), want, name)


# Qwen3-VL-8B's tower at a tiny width: 2 heads of 72 (hidden 144), the
# head dim whose non-causal kernels are #1-#4 at (72, 72) on the card
VISION_72 = dict(VISION, hidden_size=144, intermediate_size=64)


def test_vision_forward_at_head_dim_72_matches_jax():
    """The tower with heads of 72 (its rotary over 18 frequencies per
    axis): the final and both deepstack features against JAX's."""
    jcfg, tcfg = _cfgs(False)
    jcfg = jcfg.model_copy(update={"vision_cfg": jvl.Qwen3VLVisionConfig(**VISION_72)})
    tcfg = dataclasses.replace(tcfg, vision_cfg=tvl.Qwen3VLVisionConfig(**VISION_72))
    assert tcfg.vision_cfg.head_dim == jcfg.vision_cfg.head_dim == 72
    tree = _tree(jcfg, seed=21)
    batch = _batch(22, rows=2, per_row=2)
    jfinal, jds = jax.jit(lambda p, seq: jvl.qwen3vl_vision_forward(
        p, jcfg.vision_cfg, seq, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, tree["vision"]), _jseq(batch))
    tparams = params_from_numpy(tree, tcfg, "cpu")
    with torch.no_grad():
        tfinal, tds = tvl.qwen3vl_vision_forward(tparams["vision"], tcfg.vision_cfg,
                                                 _tseq(batch), torch.float32)
    for got, want, name in ((tfinal, jfinal, "final"), *((a, b, f"ds{i}") for i, (a, b) in
                                                          enumerate(zip(tds, jds)))):
        _close(got.numpy(), want, name)


@pytest.mark.parametrize("variant", ["grouped", "two_pass"])
def test_noncausal_flash_at_72_matches_jax(monkeypatch, variant):
    """The plain #1-#4 with `causal=False` at head dim 72 (what the wrapper
    runs on a CPU tensor; the card's kernels are held to it) against JAX's
    `_flash_forward` and `_flash_bwd_rule` in interpret mode, scale
    72^-0.5, 4 q over 2 kv heads, segments of 3, 70 and 40 rows and a
    padded tail."""
    monkeypatch.setattr(jflash, "ATTN_BWD", variant)
    d, l, hq, hkv = 72, 128, 4, 2
    rng = np.random.default_rng(70)
    q, g = (rng.standard_normal((1, l, hq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, l, hkv, d), dtype=np.float32) for _ in range(2))
    seg = _packed_seg(l, [3, 70, 40])
    scale = d ** -0.5
    heads_first = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    jq, jk, jv, jg = (heads_first(a) for a in (q, k, v, g))
    out, lse = jflash._flash_forward(jq, jk, jv, jnp.asarray(seg), None, None, scale, False,
                                     None, BLOCK, BLOCK, True)
    want = jflash._flash_bwd_rule(scale, False, None, BLOCK, BLOCK, True, 0,
                                  (jq, jk, jv, jnp.asarray(seg), None, out, lse), jg)[:3]
    valid = seg != 0
    tout, tlse = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(seg), scale,
                                              causal=False)
    _close(tout.numpy()[valid], np.asarray(out).transpose(0, 2, 1, 3)[valid], "out")
    _close(tlse.numpy().transpose(0, 2, 1)[valid],
           np.asarray(lse).transpose(0, 2, 1)[valid], "lse")
    do = _t(g)
    delta = (do * _t(out).transpose(1, 2)).sum(-1).transpose(1, 2).contiguous()
    got = tflash.flash_bwd(_t(q), _t(k), _t(v), _t(seg), _t(lse), delta, do, scale,
                           variant == "two_pass", causal=False)
    if variant == "two_pass":
        got = tuple((got[0], *(tflash.group_sum(t, hkv, t.dtype) for t in got[1:])))
    for t, w, name in zip(got, want, "qkv"):
        _close(t.numpy(), np.asarray(w).transpose(0, 2, 1, 3), f"d{name}")
        assert (t.numpy()[seg == 0] == 0).all(), name


def test_qwen3_vl_8b_preset_matches_jax():
    """`qwen3_vl_8b()` against JAX's Qwen3VLDense8BConfig field by field:
    the tower (27 blocks, hidden 1152, 16 heads of 72, MLP 4304, deepstack
    after 8, 16 and 24), the untied text model, the vision ids; the same
    8,767,123,696 params in both packages."""
    t, j = tvl.qwen3_vl_8b(), jvl.Qwen3VLDense8BConfig()
    assert dataclasses.asdict(t.vision_cfg) == j.vision_cfg.model_dump()
    v = t.vision_cfg
    assert (v.depth, v.hidden_size, v.num_attention_heads, v.head_dim, v.intermediate_size,
            v.deepstack_visual_indexes) == (27, 1152, 16, 72, 4304, [8, 16, 24])
    for f in ("image_token_id", "video_token_id", "vision_start_token_id",
              "vision_end_token_id", "freeze_vision", "freeze_projector", "freeze_language"):
        assert getattr(t, f) == getattr(j, f), f
    tt, jt = t.text_cfg, j.text_cfg
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "max_position_embeddings", "rope_theta", "tie_word_embeddings", "eos_token_id",
              "rms_norm_eps"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert not tt.tie_word_embeddings
    assert tt.rope_scaling_cfg.mrope_section == jt.rope_scaling_cfg.mrope_section == [24, 20, 20]
    a = dataclasses.asdict(tt.attention)
    assert a == {k_: v_ for k_, v_ in jt.attention.model_dump().items() if k_ in a}
    n = count_params(t.build().param_specs())
    assert n == j_count_params(j.build().param_specs()) == 8_767_123_696


@pytest.mark.parametrize("model_type", ["qwen3_vl", "qwen3_vl_moe"])
def test_qwen3_vl_from_hf_and_its_conv3d_key_still_raise(tmp_path, model_type):
    """Still to port ([vlm], [serve-rest]): Qwen3-VL from an HF directory,
    its HF key map and the Conv3d patch embedding's key transform."""
    from xtuner_tpu_torch.checkpoint import hf as thf
    from xtuner_tpu_torch.checkpoint.spec import HFKey
    from xtuner_tpu_torch.model.registry import get_model_config

    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    with pytest.raises(NotImplementedError, match=r"\[vlm\]"):
        get_model_config(str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"\[serve-rest\]"):
        tvl.qwen3_vl_8b().build().hf_key_map()
    with pytest.raises(NotImplementedError, match="Conv3d"):
        thf._check_key(HFKey("model.visual.patch_embed.proj.weight", "conv3d:3,2,16,16"))


NAMES = ("loss", "sum_ce", "balancing_loss", "z_loss")


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(moe: bool):
    """JAX's `loss` under remat "full" in f32 on one batch of 2 packed rows:
    (tree, batch, total, parts, gradient leaves by path)."""
    jcfg, _ = _cfgs(moe)
    tree = _tree(jcfg, seed=11 + moe)
    batch = _batch(13, rows=2, per_row=3)
    jmodel = jcfg.build()
    denom = float(batch["loss_weights"].sum())
    jseq = _jseq(batch)

    def j_fn(p):
        out = jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                          jnp.asarray(batch["loss_weights"]), denom,
                          compute_dtype=jnp.float32, remat="full")
        return out.total_loss(), {n: getattr(out, n) for n in NAMES
                                  if getattr(out, n, None) is not None}

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return (tree, batch, float(jl), {k: float(v) for k, v in jparts.items()},
            dict(tree_paths(jax.tree.map(np.asarray, jgrads))))


@pytest.mark.parametrize("moe,remat", [(False, "none"), (False, "full"), (True, "none"),
                                       (True, "full")])
def test_model_loss_and_every_grad_leaf_match_jax(moe, remat):
    """The loss parts and every gradient leaf (vision blocks, pos_embed,
    patch embed, the merger and deepstack mergers, the text layers and the
    tied embedding) against `jax.grad` of JAX's `loss`."""
    tree, batch, jl, jparts, jgrads = _jax_loss_and_grads(moe)
    _, tcfg = _cfgs(moe)
    tparams = params_from_numpy(tree, tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    out = tcfg.build().loss(tparams, _tseq(batch), _t(batch["shifted_labels"]),
                            _t(batch["loss_weights"]), float(batch["loss_weights"].sum()),
                            compute_dtype=torch.float32, remat=remat)
    total = out.total_loss()
    total.backward()
    _close(total.item(), jl, "total")
    for name, want in jparts.items():
        _close(getattr(out, name).item(), want, name)
    assert sorted(jgrads) == sorted(leaves)
    for path, v in leaves.items():
        assert np.isfinite(v.grad.numpy()).all(), path
        _close(v.grad.numpy(), jgrads[path], ".".join(path))
    for path in (("vision", "pos_embed"), ("vision", "blocks", "attn", "qkv", "w"),
                 ("projector", "deepstack_mergers", "fc2", "w"), ("projector", "merger", "fc1", "w")):
        assert np.abs(leaves[path].grad.numpy()).max() > 0, path


def test_deepstack_is_added_after_the_first_layers():
    """The text model adds deepstack row i after layer i < n_ds: with
    `deepstack_embeds` zero the forward is that without them, with a row
    moved the output changes; a hybrid refuses them."""
    _, tcfg = _cfgs(False)
    tree = _tree(_cfgs(False)[0], seed=4)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    batch = _batch(9, rows=1, per_row=2)
    lang = tcfg.build().language
    seq = _tseq(batch)
    emb = torch.randn((*batch["input_ids"].shape, 32), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = lang.forward(tparams["language"], seq.replace(inputs_embeds=emb), torch.float32)
        zero = lang.forward(tparams["language"], seq.replace(
            inputs_embeds=emb, deepstack_embeds=torch.zeros((2, *emb.shape))), torch.float32)
        ds = torch.zeros((2, *emb.shape))
        ds[1, :, 3] = 1.0
        moved = lang.forward(tparams["language"], seq.replace(inputs_embeds=emb,
                                                              deepstack_embeds=ds),
                             torch.float32)
    torch.testing.assert_close(zero, plain, rtol=0, atol=0)
    assert not torch.allclose(moved, plain)


# --------------------------------------------------------- the data plane
def test_tokenize_and_collate_match_jax(tmp_path):
    """Tokenized samples (images as arrays, as `.npy` paths and through the
    `<image>` string form; a text-only sample) and collated packs, field by
    field, against JAX's, with each side's toy tokenizer with the vision
    specials; a truncation through the image tokens raises in both."""
    rng = np.random.default_rng(21)
    items = _items(rng, 5)
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    np.save(tmp_path / "im.npy", img)
    items.append({"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": str(tmp_path / "im.npy")},
        {"type": "text", "text": "from a file"}]}, {"role": "assistant", "content": "ok"}]})
    items.append({"image": img, "messages": [{"role": "user", "content": "<image>describe"},
                                             {"role": "assistant", "content": "a grid"}]})
    jfn, tfn = _fn("jax"), _fn("torch")
    jsamples, tsamples = [jfn(it) for it in items], [tfn(it) for it in items]
    for js, ts in zip(jsamples, tsamples):
        assert sorted(js) == sorted(ts)
        for key in js:
            np.testing.assert_array_equal(np.asarray(ts[key]), np.asarray(js[key]), key)
    assert tfn.hash() == tfn.hash() and len(tfn.hash()) == 16
    packs = [tsamples[:3], tsamples[3:5], tsamples[5:]]
    for max_patches in (0, 1024):
        jb = jqv.qwen3vl_collator([list(p) for p in packs], 1024, max_patches=max_patches,
                                  num_grid_per_side=GRID_SIDE)
        tb = tqv.qwen3vl_collator([list(p) for p in packs], 1024, max_patches=max_patches,
                                  num_grid_per_side=GRID_SIDE)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key], key)
    # text-only packs: no vision keys, positions on all three axes
    tb = tqv.qwen3vl_collator([[tsamples[2]]], 64, max_patches=64)
    assert "pixel_values" not in tb and tb["mrope_positions"].shape == (1, 3, 64)
    with pytest.raises(ValueError, match="max_patches"):
        tqv.qwen3vl_collator([list(p) for p in packs], 1024, max_patches=64)
    cut = tqv.Qwen3VLTokenizeFn(TTok(VL_SPECIALS), "qwen", patch_size=4, merge_size=2,
                                min_pixels=32 * 32, max_pixels=64 * 64, max_length=8)
    with pytest.raises(ValueError, match="truncation"):
        cut(items[0])


def _write_demo(root: Path, n: int, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        path = root / f"im{i}.npy"
        np.save(path, rng.integers(0, 256, ((40, 40), (30, 70), (64, 64))[i % 3] + (3,),
                                   dtype=np.uint8))
        lines.append(json.dumps({"messages": [
            {"role": "user", "content": [{"type": "image", "image": str(path)},
                                         {"type": "text", "text": f"item {i} " * (i % 4 + 1)}]},
            {"role": "assistant", "content": f"reply {i} " * (i % 5 + 2)}]}))
    (root / "demo.jsonl").write_text("\n".join(lines) + "\n")
    return root / "demo.jsonl"


def test_packed_data_plane_keeps_samples_whole(tmp_path):
    """`DataloaderConfig.build` with a "qwen3_vl" dataset: soft packs of
    whole samples (never split inside the image tokens), each batch's image
    tokens equal to its patches / merge^2, every VLM key with a leading A;
    with InternVL's `max_tiles` set too, the patch collator still takes the
    batch (`max_patches` first, as JAX's `Dataloader`)."""
    path = _write_demo(tmp_path, 12, seed=2)
    cfg = DataloaderConfig(datasets=[DatasetConfig(anno_path=str(path), class_name="qwen3_vl")],
                           pack_max_length=256, tokenize_num_proc=1, max_patches=1024,
                           vision_patch_size=4, image_min_pixels=32 * 32,
                           image_max_pixels=64 * 64, vision_num_grid_per_side=GRID_SIDE)
    loader = cfg.build(TTok(VL_SPECIALS), global_batch_rows=2, micro_batch_rows=1)
    it = iter(loader)
    for _ in range(3):
        batch = next(it)
        assert batch["input_ids"].shape == (2, 1, 256)
        assert batch["pixel_values"].shape == (2, 1024, 96)
        assert batch["mrope_positions"].shape == (2, 1, 3, 256)
        for a in range(2):
            p = int((batch["vision_segment_ids"][a] != 0).sum())
            assert int(batch["image_token_mask"][a].sum()) * 4 == p > 0
    loader.close()
    both = dataclasses.replace(cfg, max_tiles=4).build(TTok(VL_SPECIALS), 1, 1)
    assert next(iter(both))["pixel_values"].shape == (1, 1024, 96)
    both.close()


def test_jax_toy_tokenizer_breaks_qwen3_vl_and_the_port_does_not():
    """A reference fault (ROADMAP.md, known faults): JAX's Trainer builds
    `UTF8ByteTokenizer()` without the vision specials when no
    tokenizer_path is given, so `Qwen3VLTokenizeFn` takes "<" as the image
    pad and raises on a 256 x 256 image. The port's Trainer builds the toy
    tokenizer with them for a qwen3_vl dataset: the ids of JAX's
    `UTF8ByteTokenizer(VL_SPECIALS)`, and the sample tokenizes."""
    img = np.random.default_rng(3).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    item = {"messages": [{"role": "user", "content": [{"type": "image", "image": img},
                                                      {"type": "text", "text": "what?"}]},
                         {"role": "assistant", "content": "noise"}]}
    with pytest.raises(ValueError, match="image token count mismatch"):
        jqv.Qwen3VLTokenizeFn(JTok())(item)
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(
        tokenizer_path=None, dataloader_cfg=DataloaderConfig(
            datasets=[DatasetConfig(anno_path="x.jsonl", class_name="qwen3_vl")])))
    tok = Trainer._build_tokenizer(fake)
    text = "<|vision_start|><|image_pad|><|image_pad|><|vision_end|>hi <|im_start|>"
    assert tok.encode(text) == JTok(VL_SPECIALS).encode(text)
    out = tqv.Qwen3VLTokenizeFn(tok)(item)
    want = jqv.Qwen3VLTokenizeFn(JTok(VL_SPECIALS))(item)
    np.testing.assert_array_equal(out["input_ids"], want["input_ids"])
    assert int(out["image_token_mask"].sum()) == 64
    fake.cfg.dataloader_cfg.datasets[0].class_name = "openai_sft"
    assert Trainer._build_tokenizer(fake).vocab_size == 259  # text: JAX's toy, unchanged


# ------------------------------------------------------------- the engine
def _engine_batches(step: int):
    micro = [_batch(40 * step + a, rows=1, per_row=2) for a in range(2)]
    return {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def test_train_engine_curve_matches_jax():
    """3 optimizer steps of the tiny dense Qwen3-VL, A = 2 micro-batches of
    1 packed row (each with its own patch rows): total loss, CE, tokens,
    grad norm and lr each step, and the pos-embed after the last."""
    ocfg = dict(lr=2e-3, max_grad_norm=1.0, weight_decay=0.01)
    lcfg = dict(lr_type="cosine", warmup_steps=1, lr_min=1e-4)
    jcfg, tcfg = _cfgs(False)
    tree = _tree(jcfg, seed=8)
    mesh_cfg = MeshConfig(fsdp_size=1, param_dtype="float32")
    jeng = JEngine(jcfg, joptim.AdamWConfig(**ocfg), joptim.LRConfig(**lcfg), mesh_cfg, 3,
                   mesh=build_mesh(mesh_cfg, jax.devices()[:1]))
    jeng.params = jax.tree.map(jnp.asarray, tree)
    jeng.opt_state = jeng.tx.init(jeng.params)
    teng = TEngine(tcfg, toptim.AdamWConfig(**ocfg), toptim.LRConfig(**lcfg),
                   TMesh(param_dtype="float32", remat_policy="full"), 3, device="cpu")
    teng.load_params(params_from_numpy(tree, tcfg, "cpu"))
    for path in (("vision", "blocks"), ("projector", "deepstack_mergers"), ("language", "layers")):
        sub = teng._train_tree[path[0]][path[1]]
        assert isinstance(sub, list) and len(sub) in (2, 3)
    keys = ("total_loss", "reduced_llm_loss", "consumed_tokens", "grad_norm", "lr", "skipped")
    curves = {"jax": [], "torch": []}
    for step in range(1, 4):
        batch = _engine_batches(step)
        jm, tm = jeng.train_step(batch, step), teng.train_step(batch, step)
        curves["jax"].append([float(jm[k]) for k in keys])
        curves["torch"].append([float(tm[k]) for k in keys])
    np.testing.assert_allclose(np.asarray(curves["torch"]), np.asarray(curves["jax"]),
                               rtol=CURVE_RTOL, atol=1e-7)
    assert not any(np.asarray(curves["torch"])[:, keys.index("skipped")])
    np.testing.assert_allclose(teng.params["vision"]["pos_embed"].numpy(),
                               np.asarray(jeng.params["vision"]["pos_embed"]),
                               rtol=CURVE_RTOL, atol=1e-6)


def test_freeze_vision_leaves_do_not_move():
    """`freeze_vision`: the vision leaves are no optimizer params and stay
    bit for bit; the projector and the language model train; the labels
    are JAX's."""
    jcfg, tcfg = _cfgs(False)
    tcfg = dataclasses.replace(tcfg, freeze_vision=True)
    labels = tcfg.build().param_labels(tcfg.build().param_specs())
    jlabels = jcfg.model_copy(update=dict(freeze_vision=True)).build().param_labels(
        jcfg.build().param_specs())
    assert dict(tree_paths(labels)) == dict(tree_paths(jax.tree.map(str, jlabels)))
    tree = _tree(jcfg, seed=9)
    teng = TEngine(tcfg, toptim.AdamWConfig(lr=2e-3), toptim.LRConfig(warmup_steps=0), TMesh(
        param_dtype="float32", remat_policy="full"), 2, device="cpu")
    teng.load_params(params_from_numpy(tree, tcfg, "cpu"))
    # per-layer views: patch_embed w and b, pos_embed, 12 leaves a block
    n_vision = 3 + 12 * VISION["depth"]
    _, all_pairs = _leaf_views(teng.params)
    assert len(teng.optimizer.params) == len(all_pairs) - n_vision
    assert not any(t.requires_grad for t in teng._train_tree["vision"]["blocks"][0]["attn"]
                   ["qkv"].values())
    before = {p: t.clone() for p, t in tree_paths(teng.params)}
    for step in range(1, 3):
        m = teng.train_step(_engine_batches(step), step)
        assert not m["skipped"] and np.isfinite(m["grad_norm"])
    after = dict(tree_paths(teng.params))
    for path, t in before.items():
        moved = not torch.equal(after[path], t)
        assert moved == (path[0] != "vision"), path


# -------------------------------------------------------------- the recipe
def test_qwen3_vl_4b_recipe(tmp_path, monkeypatch):
    """The recipe's model is the registry's qwen3-vl-4b at full width and
    depth with the toy tokenizer's vision ids, 4,437,815,808 params in
    both packages; its demo set (written under the working directory) has
    48 conversations whose images give 256, 768 and 1024 image tokens."""
    monkeypatch.chdir(tmp_path)
    rdir = Path(tmoe.__file__).resolve().parents[1] / "recipes"
    ns = runpy.run_path(str(rdir / "sft_qwen3_vl_4b.py"))
    trainer = ns["trainer"]
    cfg = trainer.model_cfg
    tok = TTok(VL_SPECIALS)
    assert cfg == dataclasses.replace(
        tvl.qwen3_vl_4b(), image_token_id=tok.special_ids["<|image_pad|>"],
        video_token_id=tok.special_ids["<|image_pad|>"],
        vision_start_token_id=tok.special_ids["<|vision_start|>"],
        vision_end_token_id=tok.special_ids["<|vision_end|>"])
    v = cfg.vision_cfg
    assert (v.depth, v.hidden_size, v.head_dim, v.deepstack_visual_indexes) == (24, 1024, 64,
                                                                                 [5, 11, 17])
    assert count_params(cfg.build().param_specs()) == RECIPE_PARAMS
    assert j_count_params(jvl.Qwen3VLDense4BConfig().build().param_specs()) == RECIPE_PARAMS
    assert trainer.mesh_cfg.remat_policy == "full" and cfg.lm_loss_cfg.mode == "chunk"
    dl = trainer.dataloader_cfg
    assert (dl.pack_max_length, dl.max_patches, dl.vision_num_grid_per_side) == (8192, 32768, 48)
    assert dl.datasets[0].class_name == "qwen3_vl"
    rows = Path(dl.datasets[0].anno_path).read_text().splitlines()
    assert len(rows) == 48
    assert Path(dl.datasets[0].anno_path).resolve().is_relative_to(tmp_path.resolve())
    shapes = [np.load(json.loads(r)["messages"][0]["content"][0]["image"], mmap_mode="r").shape
              for r in rows[:3]]
    assert shapes == [(512, 512, 3), (768, 1024, 3), (1024, 1024, 3)]
    for (h, w, _), tokens in zip(shapes, (256, 768, 1024)):
        assert tvl.smart_resize(h, w) == (h, w) and h * w // 16 ** 2 // 4 == tokens
