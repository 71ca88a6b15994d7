"""Attention of the PyTorch port (`xtuner_tpu_torch`) against the JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX Pallas kernels run in interpret mode, as the JAX package's own tests run
them. Inputs are numpy arrays from a seed, in fp32: the two sides differ
only in summation order and in exp vs exp2, so the tolerance is 2e-5
(the JAX flash tests' own tolerance against their reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module import kv_cache as jkv
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.ops.attention.flash import _flash_forward
from xtuner_tpu.ops.attention.paged_decode import paged_decode_attn as j_paged_decode
from xtuner_tpu.ops.attention.reference import reference_attention as j_reference
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module import kv_cache as tkv
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.ops.attention.flash import BIG_LSE, flash_attention
from xtuner_tpu_torch.ops.attention.paged_decode import paged_decode_attn
from xtuner_tpu_torch.ops.attention.reference import reference_attention

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(b=2, l=256, hq=4, hkv=2, d=128, docs=3, seed=0):
    """q, k, v and segment ids: `docs` documents per row plus tail padding."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(16, l - 32), docs - 1, replace=False))
        bounds = [0, *cuts.tolist(), l - int(rng.integers(1, 24))]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


def test_reference_attention_matches_jax():
    q, k, v, seg = _packed(l=64, d=32)
    want = j_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    got = reference_attention(_t(q), _t(k), _t(v), _t(seg))
    valid = seg != 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=TOL, rtol=TOL)


def test_flash_matches_jax_kernel():
    """Port flash (plain version on the CPU) vs the Pallas forward kernel in
    interpret mode: out and lse, 3 documents plus padding, GQA rep 2."""
    q, k, v, seg = _packed()
    scale = 128 ** -0.5
    jout, jlse = _flash_forward(
        jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(v), 1, 2), jnp.asarray(seg), None, None, scale,
        True, None, 128, 128, True)
    jout = np.swapaxes(np.asarray(jout), 1, 2)
    out, lse = flash_attention(_t(q), _t(k), _t(v), _t(seg))
    assert out.shape == q.shape and lse.shape == (2, 4, 256)
    assert flash_attention.launches == 0  # CPU tensors never launch the kernel
    valid = seg != 0
    np.testing.assert_allclose(out.numpy()[valid], jout[valid], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out.numpy()[~valid], 0.0)
    lse_v = np.swapaxes(lse.numpy(), 1, 2)  # (B, L, Hq)
    jlse_v = np.swapaxes(np.asarray(jlse), 1, 2)
    np.testing.assert_allclose(lse_v[valid], jlse_v[valid], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(lse_v[~valid], np.float32(BIG_LSE))
    np.testing.assert_array_equal(jlse_v[~valid], np.float32(BIG_LSE))


def test_flash_bf16_matches_fp32_oracle():
    """bf16 inputs go through the same plain path; output rounds to bf16."""
    q, k, v, seg = _packed(b=1, l=128, seed=1)
    out32, _ = flash_attention(_t(q), _t(k), _t(v), _t(seg))
    out16, lse16 = flash_attention(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), _t(seg))
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    # bf16 inputs (2^-9 relative) through softmax and a weighted mean
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(), atol=3e-2)


@pytest.mark.parametrize("kw", [{"window": 8}, {"sinks": torch.zeros(4)}, {"causal": False}])
def test_flash_unported_options_raise(kw):
    """The window, the sinks and non-causal attention now train
    (tests/test_torch_gpt_oss_train.py and tests/test_torch_qwen3_vl.py hold
    them to JAX): their backward runs here, and what still raises is a
    window at the one-pass kernel's (128, 128), sinks that are not one per
    q head, and non-causal attention at any pair but (64, 64) (on a CUDA
    tensor; the check reads only the shapes)."""
    q, k, v, seg = _packed(b=1, l=64, d=16)
    if "causal" in kw:
        tq = _t(q).requires_grad_(True)
        out, _ = flash_attention(tq, _t(k), _t(v), _t(seg), **kw)
        out.sum().backward()
        assert torch.isfinite(tq.grad).all() and tq.grad.abs().sum() > 0
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tflash._check_causal(_t(q), _t(v), None, False, "flash_attention")
        return
    tq = _t(q).requires_grad_(True)
    out, _ = flash_attention(tq, _t(k), _t(v), _t(seg), **kw)
    out.sum().backward()
    assert torch.isfinite(tq.grad).all() and tq.grad.abs().sum() > 0
    if "window" in kw:
        b16 = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
        lse = torch.zeros((1, 4, 64))
        with pytest.raises(ValueError, match="takes no sliding window"):
            tflash._check_bwd_args(b16(1, 64, 4, 128), b16(1, 64, 2, 128), b16(1, 64, 2, 128),
                                   torch.ones((1, 64), dtype=torch.int32), lse, lse,
                                   b16(1, 64, 4, 128), "flash_bwd", **kw)
    else:
        with pytest.raises(ValueError, match="one per q head"):
            flash_attention(_t(q), _t(k), _t(v), _t(seg), sinks=torch.zeros(3))


def _mha_case(seed=0):
    rng = np.random.default_rng(seed)
    hidden, hq, hkv, d = 64, 4, 2, 128
    p = {
        "q_proj": {"w": rng.standard_normal((hidden, hq * d), dtype=np.float32) * 0.1},
        "k_proj": {"w": rng.standard_normal((hidden, hkv * d), dtype=np.float32) * 0.1},
        "v_proj": {"w": rng.standard_normal((hidden, hkv * d), dtype=np.float32) * 0.1},
        "o_proj": {"w": rng.standard_normal((hq * d, hidden), dtype=np.float32) * 0.1},
        "q_norm": 1 + 0.1 * rng.standard_normal((d,), dtype=np.float32),
        "k_norm": 1 + 0.1 * rng.standard_normal((d,), dtype=np.float32),
    }
    kw = dict(num_attention_heads=hq, num_key_value_heads=hkv, head_dim=d, qk_norm=True)
    return p, kw, hidden


def test_prefill_matches_mha_cached_forward():
    """Port prefill (flash with segment_ids = kv_mask) vs the JAX
    `mha_cached_forward` at cache_len 0 on a right-padded prompt: equal at
    real rows and in the cache slots below the prompt length."""
    p, kw, hidden = _mha_case()
    b, pb, p_len = 1, 64, 45
    x = np.random.default_rng(5).standard_normal((b, pb, hidden), dtype=np.float32)
    pos = np.minimum(np.arange(pb), p_len - 1)[None].astype(np.int32)
    kv_mask = (np.arange(pb) < p_len)[None]
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    zeros = jnp.zeros((b, pb, 2, 128), jnp.float32)
    jo, jck, jcv = jattn.mha_cached_forward(
        jax.tree.map(jnp.asarray, p), jattn.MHAConfig(**kw), jnp.asarray(x), jcos, jsin,
        zeros, zeros, jnp.int32(0), kv_mask=jnp.asarray(kv_mask))
    tcos, tsin = trope.rope_cos_sin(_t(pos), 128, 1e6)
    ck = torch.zeros((b, pb, 2, 128))
    cv = torch.zeros((b, pb, 2, 128))
    to, tck, tcv = tattn.mha_cached_forward(
        {k_: ({kk: _t(vv) for kk, vv in v_.items()} if isinstance(v_, dict) else _t(v_))
         for k_, v_ in p.items()},
        tattn.MHAConfig(**kw), _t(x), tcos, tsin, ck, cv, 0, kv_mask=_t(kv_mask))
    assert tck is ck and tcv is cv  # written in place
    np.testing.assert_allclose(to.numpy()[:, :p_len], np.asarray(jo)[:, :p_len],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ck.numpy()[:, :p_len], np.asarray(jck)[:, :p_len], atol=TOL)
    np.testing.assert_allclose(cv.numpy()[:, :p_len], np.asarray(jcv)[:, :p_len], atol=TOL)


def test_cached_forward_unported_options_raise():
    p, kw, hidden = _mha_case()
    tp = {k_: ({kk: _t(vv) for kk, vv in v_.items()} if isinstance(v_, dict) else _t(v_))
          for k_, v_ in p.items()}
    x = torch.zeros((1, 4, hidden))
    cos, sin = trope.rope_cos_sin(torch.zeros((1, 4), dtype=torch.int32), 128, 1e6)
    ck, cv = torch.zeros((1, 8, 2, 128)), torch.zeros((1, 8, 2, 128))
    # a non-empty cache is ported now (the dense decode; tests/test_torch_rl.py
    # holds it to JAX): the chunk lands at slots [4, 8)
    out, _, _ = tattn.mha_cached_forward(tp, tattn.MHAConfig(**kw), x, cos, sin, ck, cv, 4)
    assert out.shape == (1, 4, hidden) and torch.all(ck[:, :4] == 0)
    # sinks and windows are ported at cache_len 0 (tests/test_torch_gpt_oss.py),
    # and so is gated attention (tests/test_torch_qwen35.py), in the training
    # forward too: `mha_qkv` returns the gate (tests/test_torch_qwen35_train.py
    # holds it to JAX); LoRA projections still raise
    with pytest.raises(NotImplementedError, match=r"\[lora\]"):
        tattn.mha_qkv(tp, tattn.MHAConfig(**kw), x, cos, sin, lora_scaling=0.5)


BS, D = 16, 128


def _paged_case(seed=0, c=1):
    """4 slots over a 2-layer pool: ragged lengths straddling block edges,
    plus one inactive slot (seq_len 0, all-zero table -> trash block 0)."""
    rng = np.random.default_rng(seed)
    hq, hkv, nb, mb = 8, 2, 24, 5  # GQA rep 4
    pk = rng.standard_normal((2, nb, BS, hkv, D), dtype=np.float32)
    pv = rng.standard_normal((2, nb, BS, hkv, D), dtype=np.float32)
    q = rng.standard_normal((4, c, hq, D), dtype=np.float32)
    lens = np.array([37, 0, 15, 63], np.int32)
    table = np.zeros((4, mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for bi, n in enumerate(lens):
        if n == 0:
            continue
        for t in range(-(-(int(n) + c) // BS)):
            table[bi, t] = free.pop()
    return q, pk, pv, table, lens


@pytest.mark.parametrize("c", [1, 2])
def test_paged_decode_matches_jax_kernel(c):
    q, pk, pv, table, lens = _paged_case(c=c)
    scale = D ** -0.5
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), 1,
                          jnp.asarray(table), jnp.asarray(lens), scale=scale,
                          interpret=True)
    got = paged_decode_attn(_t(q), _t(pk), _t(pv), 1, _t(table), _t(lens), scale=scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert paged_decode_attn.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_paged_decode_unported_options_raise():
    """Once a refusal: a window and sinks are ported. Held to JAX's kernel
    at head dim 128 with window 4 (slots at 63 see one block's tail) and
    sinks, at the active slots."""
    q, pk, pv, table, lens = _paged_case()
    sinks = np.linspace(-1.0, 2.0, 8).astype(np.float32)
    want = j_paged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), 0,
                          jnp.asarray(table), jnp.asarray(lens), scale=D ** -0.5, window=4,
                          sinks=jnp.asarray(sinks), interpret=True)
    got = paged_decode_attn(_t(q), _t(pk), _t(pv), 0, _t(table), _t(lens), scale=D ** -0.5,
                            window=4, sinks=_t(sinks))
    np.testing.assert_allclose(got.numpy()[lens > 0], np.asarray(want)[lens > 0], atol=TOL,
                               rtol=TOL)


def test_paged_write_matches_jax():
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((2, 6, 4, 2, 8), dtype=np.float32)
    table = np.array([[3, 1], [5, 2]], np.int32)
    pos = np.array([5, 2], np.int32)
    vals = rng.standard_normal((2, 2, 8), dtype=np.float32)
    want = jkv.paged_write(jnp.asarray(pool), 1, jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(vals))
    tpool = _t(pool)
    got = tkv.paged_write(tpool, 1, _t(table), _t(pos), _t(vals))
    assert got is tpool  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_cache_bookkeeping_matches_jax():
    """Same allocator / table / share / release sequence on both caches."""
    caches = [jkv.PagedKVCache(1, 12, 4, 1, 8, dtype=jnp.float32),
              tkv.PagedKVCache(1, 12, 4, 1, 8, dtype=torch.float32, device="cpu")]
    for c in caches:
        c.allocator.refcount[0] = 1
        c.add_sequence(0, 10)
        c.extend(0, 3)
        c.share_prefix(0, 1)
        c.extend(1, 2)
        c.add_sequence(2, 0)
        c.extend(2, 5)
        c.release(0)
    j, t = caches
    assert j.tables == t.tables and j.seq_lens == t.seq_lens
    np.testing.assert_array_equal(j.allocator.refcount, t.allocator.refcount)
    np.testing.assert_array_equal(j.block_table([1, 2], 4), t.block_table([1, 2], 4))
    assert t.pool_k.shape == (1, 12, 4, 1, 8)
    with pytest.raises(MemoryError):
        t.add_sequence(3, 1000)
