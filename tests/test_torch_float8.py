"""The port's tile-wise float8 training path against the JAX package.

On the CPU the port's fp8 wrappers run their plain versions (f32
dequantise, then f32 products); the JAX kernels run as the JAX package's
own tests run them: `fp8_gemm_tilewise(..., interpret=True)` (#11) and the
grouped kernels #12 and #13 in interpret mode. Inputs are numpy arrays from
seeds. Tolerances, and why:

- the quantisers: fp8 codes (as uint8) and scales identical, bit for bit;
- the kernels' plain versions against JAX's kernels, f32 out: 2e-5 (the
  same per-tile products, summed in another order). At K = 768, which the
  JAX kernels cannot run (#12 asserts K % 512 == 0 above 512; #13 leaves
  rows 512-767 of every dW unwritten), against an independent float64
  oracle of the per-tile formula, 2e-5;
- `fp8_matmul` and `fp8_grouped_linear`: values and both gradients within
  1e-5 relative, plus 1 bf16 step (2^-8) of the largest entry where the
  result is rounded to bf16 (the grouped forward and dgrad);
- the 2-layer fp8 models: loss within 1e-4 relative, every gradient leaf
  within 5e-2 in mean relative difference and 1.5e-1 of its largest entry
  at most. Summation-order differences upstream flip single fp8 roundings
  (1 ulp of e4m3 is 6-12%), and each flip moves later layers' inputs
  enough to flip more: scaling the parameters by (1 + 1e-7), one f32 ulp,
  moves the port's own fp8 loss by 1.6e-5 (MoE) and 6.7e-5 (dense) and its
  gradient leaves by up to 7.7e-2 of their largest entry. Port and JAX
  differ by less (loss 7e-6 and 1.7e-5, leaves at most 1.6e-2), so these
  bounds are that noise floor with a margin, not the 1e-3 a
  non-chaotic path would give; the ops above hold the arithmetic exactly;
- a 3-step `Trainer.fit` curve with `Float8Config`: 2e-3 relative (the
  bf16 curve's 1e-4 does not hold for the same reason: by step 3 the grad
  norms of the two packages moved 2.2e-4 apart, and the port's own step-1
  loss differed by 5e-6 between two runs of this test, torch's CPU kernels
  summing in a thread-dependent order); maxvio within 2e-2 (a routing flip
  of one token moves it by 4e-3).
"""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops import float8 as jf8
from xtuner_tpu.ops import fp8_gemm as jgemm
from xtuner_tpu.ops import fp8_grouped as jgrp
from xtuner_tpu_torch.ops import float8 as tf8
from xtuner_tpu_torch.ops import fp8_gemm as tgemm
from xtuner_tpu_torch.ops import fp8_grouped as tgrp

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "xtuner_tpu_torch" / "recipes" / "sft_moe_heavy_fp8.py"
KERNEL_TOL = 2e-5
TOL = 1e-5
BF16_STEP = 2.0 ** -8
MODEL_LOSS_RTOL = 1e-4
LEAF_MEAN_RTOL = 5e-2
LEAF_MAX_RTOL = 1.5e-1
CURVE_RTOL = 2e-3

_DT = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(q):
    """fp8 codes as uint8, from either package."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _data(shape, seed, outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if outliers:  # a few large entries, so that tiles get different scales
        x *= 1 + 10 * (rng.random(shape) > 0.99)
    return x


def _gs_sizes(sizes):
    return jnp.asarray(sizes, jnp.int32), torch.tensor(sizes, dtype=torch.int32)


# ------------------------------------------------------------ quantisers
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["e4m3", "e5m2"])
@pytest.mark.parametrize("which", ["tilewise", "blockwise", "blockwise_stack", "rowtile"])
def test_quantisers_give_jax_codes_and_scales(which, dtype, src):
    """From f32, and from bf16 (the model's activations: JAX casts to f32
    first, the port divides the bf16 values in f32)."""
    jdt, tdt = _DT[dtype]
    fns = {"tilewise": (jgemm.quantize_tilewise, tgemm.quantize_tilewise, (3, 40, 384)),
           "blockwise": (jgemm.quantize_blockwise, tgemm.quantize_blockwise, (384, 256)),
           "blockwise_stack": (jgrp.quantize_blockwise_stack, tgrp.quantize_blockwise_stack,
                               (3, 256, 384)),
           "rowtile": (jgrp.quantize_rowtile, tgrp.quantize_rowtile, (384, 200))}
    jfn, tfn, shape = fns[which]
    x = _data(shape, seed=len(which))
    x.flat[7] = 0.0  # an all-zero tile takes the eps scale
    if which == "rowtile":
        x[128:256] = 0.0
    jq, js = jfn(jnp.asarray(x, getattr(jnp, src)), 128, jdt)
    tq, ts = tfn(_t(x).to(getattr(torch, src)), 128, tdt)
    assert tq.dtype == tdt
    np.testing.assert_array_equal(_codes(tq), _codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("gran", ["tilewise", "tensorwise"])
def test_quantize_e4m3_and_dequantize_match_jax(gran):
    x = _data((2, 16, 256), seed=5)
    jq, js = jf8.quantize_e4m3(jnp.asarray(x), gran)
    tq, ts = tf8.quantize_e4m3(_t(x), gran)
    np.testing.assert_array_equal(_codes(tq), _codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf8.dequantize(tq, ts, gran).numpy(),
                                  np.asarray(jf8.dequantize(jq, js, gran)))


def test_float8_config_fields_match_jax():
    want = jf8.Float8Config()
    got = tf8.Float8Config()
    assert {f: getattr(got, f) for f in type(want).model_fields} == want.model_dump()
    with pytest.raises(ValueError):
        tf8.Float8Config(scaling_granularity="rowwise")


# ------------------------------------------------- #11: the tile-wise GEMM
def _tile_oracle(xq, sx, wq, sw):
    """float64 sum over K tiles of (x_t . w_t) * sx[:, t] * sw[t, n / 128]."""
    xf, wf = xq.float().double().numpy(), wq.float().double().numpy()
    sxf, swf = sx.double().numpy(), np.repeat(sw.double().numpy(), 128, axis=1)
    y = np.zeros((xf.shape[0], wf.shape[1]))
    for t in range(xf.shape[1] // 128):
        ks = slice(128 * t, 128 * (t + 1))
        y += (xf[:, ks] @ wf[ks]) * sxf[:, t:t + 1] * swf[t][None, :]
    return y


@pytest.mark.parametrize("a_dtype,b_dtype", [("e4m3", "e4m3"), ("e5m2", "e4m3"),
                                             ("e4m3", "e5m2")])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_fp8_gemm_plain_matches_jax_kernel(k, a_dtype, b_dtype):
    m, n = 96, 384  # M and N not block multiples: the JAX kernel's pads engage
    x, w = _data((m, k), seed=k), _data((k, n), seed=k + 1) * 0.05
    jxq, jsx = jgemm.quantize_tilewise(jnp.asarray(x), 128, _DT[a_dtype][0])
    jwq, jsw = jgemm.quantize_blockwise(jnp.asarray(w), 128, _DT[b_dtype][0])
    want = jgemm.fp8_gemm_tilewise(jxq, jsx, jwq, jsw, out_dtype=jnp.float32, interpret=True)
    xq, sx = tgemm.quantize_tilewise(_t(x), 128, _DT[a_dtype][1])
    wq, sw = tgemm.quantize_blockwise(_t(w), 128, _DT[b_dtype][1])
    got = tgemm.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert tgemm.fp8_gemm_tilewise(xq, sx, wq, sw).dtype == torch.bfloat16


def test_fp8_gemm_plain_at_k768_matches_the_tile_oracle():
    """K = 768 and an M that is not a 128 multiple."""
    m, k, n = 200, 768, 256
    xq, sx = tgemm.quantize_tilewise(_t(_data((m, k), seed=7)))
    wq, sw = tgemm.quantize_blockwise(_t(_data((k, n), seed=8)) * 0.05)
    got = tgemm.fp8_gemm_tilewise(xq, sx, wq, sw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _tile_oracle(xq, sx, wq, sw), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


# ---------------------------------------------- #12 and #13: grouped GEMMs
GROUPS = [[300, 0, 500, 224], [256, 256, 256, 256], [1024, 0, 0, 0], [0, 10, 1000, 14]]


@pytest.mark.parametrize("k", [256, 512, 1024])
@pytest.mark.parametrize("sizes", GROUPS)
def test_fp8_grouped_gemm_plain_matches_jax_kernel(sizes, k):
    m, n, e = 1024, 128, 4
    x, w = _data((m, k), seed=1), _data((e, k, n), seed=2) * 0.1
    jgs, tgs = _gs_sizes(sizes)
    jxq, jsx = jgemm.quantize_tilewise(jnp.asarray(x), 128)
    jwq, jsw = jgrp.quantize_blockwise_stack(jnp.asarray(w), 128)
    want = jgrp.fp8_grouped_gemm(jxq, jsx, jwq, jsw, jgs, interpret=True,
                                 out_dtype=jnp.float32)
    xq, sx = tgemm.quantize_tilewise(_t(x))
    wq, sw = tgrp.quantize_blockwise_stack(_t(w))
    got = tgrp.fp8_grouped_gemm(xq, sx, wq, sw, tgs, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _grouped_oracle(xq, sx, wq, sw, sizes):
    out = np.zeros((xq.shape[0], wq.shape[2]))
    start = 0
    for e, g in enumerate(sizes):
        if g:
            out[start:start + g] = _tile_oracle(xq[start:start + g], sx[start:start + g],
                                                wq[e], sw[e])
        start += g
    return out


def _rowtile_oracle(xq, sx, yq, sy, sizes, num_experts):
    """float64 sum over 128-row tiles r of (x_r^T y_r) sx[r] sy[r], each
    expert's rows only."""
    xf, yf = xq.float().double().numpy(), yq.float().double().numpy()
    sxf, syf = sx.double().numpy()[:, 0], sy.double().numpy()[:, 0]
    dw = np.zeros((num_experts, xf.shape[1], yf.shape[1]))
    start = 0
    for e, g in enumerate(sizes):
        for r in range(start // 128, (start + g + 127) // 128 if g else start // 128):
            lo, hi = max(start, 128 * r), min(start + g, 128 * (r + 1))
            dw[e] += (xf[lo:hi].T @ yf[lo:hi]) * sxf[r] * syf[r]
        start += g
    return dw


def test_fp8_grouped_gemm_plain_at_k768_matches_the_tile_oracle():
    """K = 768, M not a 128 multiple, a 1-row expert, an empty expert and
    rows past the last group."""
    sizes = [300, 1, 0, 333]
    m, k, n = 700, 768, 256
    xq, sx = tgemm.quantize_tilewise(_t(_data((m, k), seed=3)))
    wq, sw = tgrp.quantize_blockwise_stack(_t(_data((4, k, n), seed=4)) * 0.05)
    got = tgrp.fp8_grouped_gemm(xq, sx, wq, sw, _gs_sizes(sizes)[1], out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _grouped_oracle(xq, sx, wq, sw, sizes),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert not got[sum(sizes):].any()


@pytest.mark.parametrize("y_dtype", ["e4m3", "e5m2"])
@pytest.mark.parametrize("k", [256, 512, 1024])
def test_fp8_grouped_dw_plain_matches_jax_kernel(k, y_dtype):
    m, n, e = 1024, 128, 4
    x, dy = _data((m, k), seed=5), _data((m, n), seed=6)
    sizes = [300, 0, 500, 224]
    jgs, tgs = _gs_sizes(sizes)
    jdt, tdt = _DT[y_dtype]
    jxq, jsx = jgrp.quantize_rowtile(jnp.asarray(x), 128)
    jyq, jsy = jgrp.quantize_rowtile(jnp.asarray(dy), 128, jdt)
    want = jgrp.fp8_grouped_gemm_dw(jxq, jsx, jyq, jsy, jgs, e, interpret=True)
    xq, sx = tgrp.quantize_rowtile(_t(x))
    yq, sy = tgrp.quantize_rowtile(_t(dy), 128, tdt)
    got = tgrp.fp8_grouped_gemm_dw(xq, sx, yq, sy, tgs, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(np.asarray(want)).max())


def test_fp8_grouped_dw_plain_at_k768_matches_the_rowtile_oracle():
    """K = 768 (JAX's kernel leaves rows 512-767 of every dW unwritten),
    tiles that straddle experts, a 1-row expert, an empty expert."""
    sizes = [300, 1, 0, 339]
    m, k, n = 640, 768, 256
    xq, sx = tgrp.quantize_rowtile(_t(_data((m, k), seed=9)))
    yq, sy = tgrp.quantize_rowtile(_t(_data((m, n), seed=10)), 128, torch.float8_e5m2)
    got = tgrp.fp8_grouped_gemm_dw(xq, sx, yq, sy, _gs_sizes(sizes)[1], 4)
    want = _rowtile_oracle(xq, sx, yq, sy, sizes, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL * np.abs(want).max())
    assert not got[2].any()


# ------------------------------------------------ the differentiable ops
def _close(got, want, bf16=False, msg=""):
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    atol = TOL * max(1.0, scale) + (BF16_STEP * scale if bf16 else 0.0)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=TOL, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("gran,e5m2", [("tilewise", False), ("tilewise", True),
                                       ("tensorwise", False), ("tensorwise", True)])
def test_fp8_matmul_value_and_grads_match_jax(gran, e5m2):
    x = _data((2, 24, 256), seed=11)
    w = _data((256, 200), seed=12, outliers=False) * 0.05  # N = 200: _tile_dot pads it
    cot = _data((2, 24, 200), seed=13, outliers=False)

    def jfn(x_, w_):
        y = jf8.fp8_matmul(x_, w_, gran, 128, e5m2)
        return jnp.sum(y * cot), y

    (_, jy), (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    ty = tf8.fp8_matmul(tx, tw, gran, 128, e5m2)
    (ty * _t(cot)).sum().backward()
    _close(ty.detach(), jy, msg="y")
    _close(tx.grad, jgx, msg="dx")
    _close(tw.grad, jgw, msg="dw")


@pytest.mark.parametrize("e5m2", [False, True])
def test_fp8_grouped_linear_value_and_grads_match_jax(e5m2):
    sizes = [128, 160, 0, 212]  # 500 rows: not a 128 multiple
    x = _data((500, 256), seed=14) * 0.5
    w = _data((4, 256, 128), seed=15, outliers=False) * 0.05
    cot = _data((500, 128), seed=16, outliers=False)
    jgs, tgs = _gs_sizes(sizes)

    def jfn(x_, w_):
        y = jgrp.fp8_grouped_linear(x_, w_, jgs, e5m2, True)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    ty = tgrp.fp8_grouped_linear(tx, tw, tgs, e5m2)
    assert ty.dtype == torch.bfloat16 and tx.grad is None
    (ty.float() * _t(cot)).sum().backward()
    _close(ty.detach().float(), np.asarray(jy, dtype=np.float32), bf16=True, msg="y")
    _close(tx.grad, jgx, bf16=True, msg="dx")
    _close(tw.grad, jgw, msg="dw")
    assert not tw.grad[2].any()  # the empty expert


def test_fp8_kernels_need_tile_128_on_the_card():
    """The wrappers check what the kernels take before anything launches;
    a tile other than 128 raises there (on the CPU the plain version runs
    any tile)."""
    xq, sx = tgemm.quantize_tilewise(torch.ones(4, 64), 64)
    wq, sw = tgemm.quantize_blockwise(torch.ones(64, 64), 64)
    assert tgemm.fp8_gemm_tilewise(xq, sx, wq, sw, tile=64).shape == (4, 64)
    with pytest.raises(ValueError, match="tile 64"):
        tgemm.check_fp8_operands("fp8_gemm_tilewise", 64, (xq, sx), (wq, sw))


# ------------------------------------------------------- the fp8 models
def _model_cfgs(dense: bool):
    from xtuner_tpu.model import dense as jdense
    from xtuner_tpu.model import moe as jmoe
    from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
    from xtuner_tpu.module.attention import MHAConfig as JMHA
    from xtuner_tpu.module.router import GreedyRouterConfig as JRouter
    from xtuner_tpu_torch.loss.ce_loss import CELossConfig as TCE
    from xtuner_tpu_torch.model import dense as tdense
    from xtuner_tpu_torch.model import moe as tmoe
    from xtuner_tpu_torch.module.attention import MHAConfig as TMHA
    from xtuner_tpu_torch.module.router import GreedyRouterConfig as TRouter

    # test_moe_model_level_fp8_parity's model (tests/ops/test_fp8_grouped.py),
    # with head_dim 128 so that the port runs its flash path
    common = dict(vocab_size=257, num_hidden_layers=2, hidden_size=128,
                  intermediate_size=128)
    attn = dict(num_attention_heads=4, num_key_value_heads=2, head_dim=128)
    if dense:
        j = jdense.DenseConfig(**common, attention=JMHA(**attn),
                               lm_loss_cfg=JCE(chunk_size=256), float8_cfg=jf8.Float8Config())
        t = tdense.DenseConfig(**common, attention=TMHA(**attn),
                               lm_loss_cfg=TCE(chunk_size=256), float8_cfg=tf8.Float8Config())
        return j, t
    moe = dict(moe_intermediate_size=128, n_routed_experts=4, num_experts_per_tok=2)
    j = jmoe.MoEConfig(**common, **moe, router=JRouter(), attention=JMHA(**attn),
                       lm_loss_cfg=JCE(chunk_size=256), float8_cfg=jf8.Float8Config())
    t = tmoe.MoEConfig(**common, **moe, router=TRouter(), attention=TMHA(**attn),
                       lm_loss_cfg=TCE(chunk_size=256), float8_cfg=tf8.Float8Config())
    return j, t


@pytest.mark.parametrize("dense", [False, True])
def test_fp8_model_loss_and_every_grad_leaf_match_jax(dense):
    from xtuner_tpu.data_proto import SequenceContext as JSeq
    from xtuner_tpu.module.params import init_params as j_init_params
    from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
    from xtuner_tpu_torch.module.params import params_from_numpy, tree_paths

    jcfg, tcfg = _model_cfgs(dense)
    jmodel, tmodel = jcfg.build(), tcfg.build()
    jparams = j_init_params(jmodel.param_specs(), jax.random.key(0))
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 257, (1, 256)).astype(np.int32)
    seg = np.ones((1, 256), np.int32)
    pos = np.arange(256, dtype=np.int32)[None]
    labels = rng.integers(1, 257, (1, 256)).astype(np.int32)
    weights = np.ones((1, 256), np.float32)

    def j_fn(p):
        out = jmodel.loss(p, JSeq(input_ids=jnp.asarray(ids), segment_ids=jnp.asarray(seg),
                                  position_ids=jnp.asarray(pos)),
                          jnp.asarray(labels), jnp.asarray(weights), jnp.float32(256.0),
                          compute_dtype=jnp.float32)
        return out.total_loss()

    jl, jgrads = jax.value_and_grad(j_fn)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu", torch.float32)
    leaves = dict(tree_paths(tparams))
    for v in leaves.values():
        v.requires_grad_(True)
    tl = tmodel.loss(tparams, TSeq(_t(ids), _t(seg), _t(pos)), _t(labels), _t(weights), 256.0,
                     compute_dtype=torch.float32).total_loss()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=MODEL_LOSS_RTOL)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jleaves) == sorted(leaves)
    for path, v in leaves.items():
        want, diff = jleaves[path], np.abs(v.grad.numpy() - jleaves[path])
        assert diff.mean() <= LEAF_MEAN_RTOL * np.abs(want).mean(), ".".join(path)
        assert diff.max() <= LEAF_MAX_RTOL * np.abs(want).max(), ".".join(path)


def test_fp8_trainer_curve_matches_jax(tmp_path, monkeypatch):
    """3 steps of `Trainer.fit` with `Float8Config` on the moe_heavy
    structure at a tiny size (hidden 128, 2 q / 1 kv heads of 128, 4
    experts top-2 of width 128), fused CE, remat "save_attn_residuals"."""
    from xtuner_tpu.config import optim as joptim
    from xtuner_tpu.datasets import config as jdata
    from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
    from xtuner_tpu.model.moe import MoEConfig as JMoE
    from xtuner_tpu.module.attention import MHAConfig as JMHA
    from xtuner_tpu.parallel import mesh as jmesh
    from xtuner_tpu.train import trainer as jtrainer
    from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
    from xtuner_tpu_torch.datasets import config as tdata
    from xtuner_tpu_torch.model.moe import MoEConfig
    from xtuner_tpu_torch.module.attention import MHAConfig
    from xtuner_tpu_torch.module.params import params_from_numpy
    from xtuner_tpu_torch.train import trainer as ttrainer

    demo = REPO / "examples" / "demo_data" / "alpaca_demo.jsonl"
    model_kw = dict(vocab_size=300, num_hidden_layers=2, hidden_size=128,
                    intermediate_size=256, moe_intermediate_size=128, n_routed_experts=4,
                    num_experts_per_tok=2, tie_word_embeddings=True, rope_theta=1e6,
                    balancing_loss_coef=0.001)
    attn = dict(num_attention_heads=2, num_key_value_heads=1, head_dim=128, qk_norm=True)
    run = dict(global_batch_rows=2, micro_batch_rows=2, total_steps=3, exp_name="t")
    real_build_mesh = jmesh.build_mesh
    jeng_mod = importlib.import_module("xtuner_tpu.engine.train_engine")
    monkeypatch.setattr(jeng_mod, "build_mesh",
                        lambda cfg, devices=None: real_build_mesh(cfg, jax.devices()[:1]))
    jt = jtrainer.Trainer(jtrainer.TrainerConfig(
        model_cfg=JMoE(**model_kw, attention=JMHA(**attn),
                       lm_loss_cfg=JCE(chunk_size=128, mode="fused"),
                       float8_cfg=jf8.Float8Config()),
        dataloader_cfg=jdata.DataloaderConfig(
            datasets=[jdata.DatasetConfig(anno_path=str(demo))], pack_max_length=256,
            tokenize_num_proc=1),
        optim_cfg=joptim.AdamWConfig(lr=2e-3), lr_cfg=joptim.LRConfig(warmup_steps=1),
        mesh_cfg=jmesh.MeshConfig(fsdp_size=1, param_dtype="float32",
                                  remat_policy="save_attn_residuals"),
        work_dir=str(tmp_path / "jax"), **run))
    init = jax.tree.map(np.asarray, jt.engine.params)
    jt.fit()

    tt = ttrainer.Trainer(ttrainer.TrainerConfig(
        model_cfg=MoEConfig(**model_kw, attention=MHAConfig(**attn),
                            lm_loss_cfg=CELossConfig(chunk_size=128, mode="fused"),
                            float8_cfg=tf8.Float8Config()),
        dataloader_cfg=tdata.DataloaderConfig(
            datasets=[tdata.DatasetConfig(anno_path=str(demo))], pack_max_length=256,
            tokenize_num_proc=1),
        optim_cfg=AdamWConfig(lr=2e-3), lr_cfg=LRConfig(warmup_steps=1),
        mesh_cfg=MeshConfig(param_dtype="float32", remat_policy="save_attn_residuals"),
        work_dir=str(tmp_path / "torch"), **run), device="cpu")
    tt.engine.load_params(params_from_numpy(init, tt.cfg.model_cfg, "cpu"))
    tt.fit()
    keys = ("reduced_llm_loss", "grad_norm", "total_loss", "lr", "consumed_tokens", "maxvio")
    vio = keys.index("maxvio")

    def curve(trainer):
        recs = [json.loads(x) for x in
                (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]
        return np.array([[r[k] for k in keys] for r in recs])

    got, want = curve(tt), curve(jt)
    assert got.shape == (3, len(keys))
    np.testing.assert_allclose(np.delete(got, vio, 1), np.delete(want, vio, 1),
                               rtol=CURVE_RTOL, atol=1e-7)
    np.testing.assert_allclose(got[:, vio], want[:, vio], rtol=0, atol=2e-2)
    assert got[-1, 0] < got[0, 0]


def test_fp8_recipe_is_bench_fp8_row(monkeypatch):
    """The recipe equals bench.py's fp8 row (`_build_cfg` at the moe_heavy
    shape under BENCH_FP8=e4m3) in every field the port's config has; the
    JAX-only fields (`grouped_gemm_impl`, `attn_impl`, HF and MTP options)
    choose TPU kernels or unported features."""
    import dataclasses

    from xtuner_tpu_torch.train.cli import sft as tsft
    from xtuner_tpu_torch.train.trainer import TrainerConfig
    from xtuner_tpu_torch.utils.config import Config

    monkeypatch.setenv("BENCH_FP8", "e4m3")
    monkeypatch.delenv("BENCH_CE", raising=False)
    bench = importlib.import_module("bench")
    want = dict(bench._build_cfg(layers=10, moe_inter=768, experts=16, topk=8))
    cfg = tsft.config_from_args(tsft.build_parser().parse_args(["--config", str(RECIPE)]))
    assert isinstance(cfg, TrainerConfig)
    got = cfg.model_cfg
    for f in dataclasses.fields(got):
        mine, value = getattr(got, f.name), want[f.name]
        if dataclasses.is_dataclass(mine):  # nested configs: the port's fields
            mine, value = vars(mine), {k: getattr(value, k) for k in vars(mine)}
        assert mine == value, f.name
    assert got.float8_cfg == tf8.Float8Config()  # e4m3, tile-wise, bf16 backward
    assert cfg.mesh_cfg.remat_policy == "save_attn_residuals"
    assert (cfg.global_batch_rows, cfg.micro_batch_rows, cfg.total_steps,
            cfg.dataloader_cfg.pack_max_length) == (2, 2, 6, 8192)
    assert Config.fromfile(RECIPE)["trainer"].exp_name == "sft_moe_heavy_fp8"
