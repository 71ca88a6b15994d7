"""Flash attention of the PyTorch port, forward with the max-logit bound and
backward, against the JAX package's Pallas kernels, at head dim 128 and at
v head dims other than q and k's (MLA's 192 / 128, and 24 / 16).

On the CPU the port's kernel wrappers run their plain PyTorch versions (the
forward in both variants; the backward's dq with the grouped or the
per-q-head dk/dv formulas); the JAX kernels run in interpret mode with
64-row blocks, as the JAX package's own flash tests run them. Inputs are
numpy arrays from a seed, in fp32, L = 256 (four blocks), with packed
documents and a padded tail. The two sides differ only in summation order
and exp vs exp2: tolerance 1e-5, absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.ops.attention import flash as jflash
from xtuner_tpu.ops.attention.flash import flash_attention as j_flash
from xtuner_tpu_torch.ops.attention import flash as tflash

TOL = 1e-5
BLOCK = 64


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


def _packed(b, l, hq, hkv, docs, seed, d=128, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, dv or d), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        cuts = np.sort(rng.choice(np.arange(16, l - 40), docs - 1, replace=False))
        bounds = [0, *cuts.tolist(), l - int(rng.integers(1, 30))]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


@pytest.mark.parametrize("bound", [11.3, 45.0, 60.0])  # max-free, at the edge, running max
def test_forward_with_max_logit_matches_jax(bound):
    q, k, v, seg = _packed(2, 256, 4, 2, 3, seed=0)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
                   max_logit=jnp.float32(bound), block_q=BLOCK, block_k=BLOCK,
                   interpret=True)
    got, lse = tflash.flash_attention(_t(q), _t(k), _t(v), _t(seg),
                                      max_logit=torch.tensor(bound))
    valid = seg != 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=TOL, rtol=TOL)
    assert (got.numpy()[~valid] == 0).all()
    assert (lse.transpose(1, 2).numpy()[~valid] == tflash.BIG_LSE).all()


def test_max_free_plain_equals_running_max_plain():
    q, k, v, seg = _packed(1, 128, 4, 1, 2, seed=1)
    a = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(seg), 128 ** -0.5)
    b = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(seg), 128 ** -0.5, max_free=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,hq,hkv,docs,max_logit", [
    (1, 4, 2, 3, 11.3),   # GQA ratio 2, max-free forward
    (1, 8, 2, 2, None),   # GQA ratio 4, running-max forward
    (2, 4, 4, 1, 11.3),   # no GQA, one document per row, two rows
])
def test_grads_match_jax(b, hq, hkv, docs, max_logit):
    q, k, v, seg = _packed(b, 256, hq, hkv, docs, seed=2 + hq)
    co = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)
    jseg, jco = jnp.asarray(seg), jnp.asarray(co)
    ml = None if max_logit is None else jnp.float32(max_logit)

    def j_loss(q_, k_, v_):
        out = j_flash(q_, k_, v_, jseg, max_logit=ml, block_q=BLOCK, block_k=BLOCK,
                      interpret=True)
        return jnp.sum(out * jco)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    tml = None if max_logit is None else torch.tensor(max_logit)
    out, _ = tflash.flash_attention(*leaves, _t(seg), max_logit=tml)
    (out * _t(co)).sum().backward()
    for got, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")
    # padding rows get exactly zero gradient
    assert (leaves[0].grad.numpy()[seg == 0] == 0).all()


def test_backward_launches_dq_and_dkv_wrappers_once(monkeypatch):
    """Each flash call's backward calls the one backward wrapper once, with
    the variant `XTUNER_ATTN_BWD` selects; CPU tensors count no launch."""
    q, k, v, seg = _packed(1, 128, 4, 2, 2, seed=5)
    calls = []
    orig = tflash.flash_bwd
    monkeypatch.setattr(tflash, "flash_bwd",
                        lambda *a, **kw: calls.append(a[8]) or orig(*a, **kw))
    for switch, two_pass in (("grouped", False), ("two_pass", True)):
        monkeypatch.setenv("XTUNER_ATTN_BWD", switch)
        tflash.reset_launches()
        calls.clear()
        for _ in range(2):  # two flash calls, one backward launch each
            leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
            out, _ = tflash.flash_attention(*leaves, _t(seg))
            out.sum().backward()
            assert all(t.grad is not None for t in leaves)
        assert calls == [two_pass, two_pass]
        # CPU tensors run the plain versions: no kernel launch is counted
        assert tflash.flash_attention.launches == 0
        assert tflash.flash_bwd.launches == {"grouped": 0, "two_pass": 0}


def _docs_with_a_short_one(b, l, hq, hkv, seed, d=128, dv=None):
    """Packed rows whose first document is shorter than one 64-row block,
    with a padded tail."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, l, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, l, hkv, dv or d), dtype=np.float32)
    seg = np.zeros((b, l), np.int32)
    for bi in range(b):
        bounds = [0, int(rng.integers(20, 60)), int(rng.integers(100, 160)), l - 27]
        for si in range(len(bounds) - 1):
            seg[bi, bounds[si]:bounds[si + 1]] = si + 1
    return q, k, v, seg


# q/k head dim D and v head dim Dv: JAX's own and MLA's (DeepSeek-V3: 192 and
# 128, the flash kernels' second pair), and a small pair with D != Dv
DIMS = [(128, 128), (192, 128), (24, 16)]


@pytest.mark.parametrize("variant", ["grouped", "two_pass"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (8, 2)])  # GQA ratios 1, 2, 4
def test_flash_bwd_matches_jax_bwd_rule(monkeypatch, variant, hq, hkv):
    """`flash_bwd` (then the group sum for two-pass) against JAX's
    `_flash_bwd_rule` with the same `ATTN_BWD`, both from JAX's forward
    residuals."""
    _check_bwd_against_jax_rule(monkeypatch, variant, hq, hkv, 128, 128)


@pytest.mark.parametrize("variant", ["grouped", "two_pass"])
@pytest.mark.parametrize("hq,hkv,d,dv", [(2, 2, 192, 128), (4, 2, 192, 128), (2, 2, 24, 16)])
def test_flash_bwd_at_v_head_dims_other_than_d_matches_jax_bwd_rule(monkeypatch, variant, hq,
                                                                    hkv, d, dv):
    """As above at MLA's (192, 128) and a small (24, 16)."""
    _check_bwd_against_jax_rule(monkeypatch, variant, hq, hkv, d, dv)


def _check_bwd_against_jax_rule(monkeypatch, variant, hq, hkv, d, dv):
    monkeypatch.setattr(jflash, "ATTN_BWD", variant)
    q, k, v, seg = _docs_with_a_short_one(1, 256, hq, hkv, seed=30 + hq, d=d, dv=dv)
    g = np.random.default_rng(31).standard_normal((*q.shape[:3], dv), dtype=np.float32)
    scale = d ** -0.5
    heads_first = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    jq, jk, jv, jg, jseg = (heads_first(q), heads_first(k), heads_first(v), heads_first(g),
                            jnp.asarray(seg))
    out, lse = jflash._flash_forward(jq, jk, jv, jseg, None, None, scale, True, None,
                                     BLOCK, BLOCK, True)
    want = jflash._flash_bwd_rule(scale, True, None, BLOCK, BLOCK, True, 0,
                                  (jq, jk, jv, jseg, None, out, lse), jg)[:3]
    do = _t(g)
    delta = (do * _t(out).transpose(1, 2)).sum(-1).transpose(1, 2).contiguous()
    got = tflash.flash_bwd(_t(q), _t(k), _t(v), _t(seg), _t(lse), delta, do, scale,
                           variant == "two_pass")
    if variant == "two_pass":
        assert got[1].shape == q.shape and got[2].shape == (*q.shape[:3], dv)
        got = (got[0], *(tflash.group_sum(t, hkv, t.dtype) for t in got[1:]))
    for t, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(w).transpose(0, 2, 1, 3),
                                   atol=TOL, rtol=TOL, err_msg=f"d{name}")
    # padding rows get exactly zero gradient
    for t in got:
        assert (t.numpy()[seg == 0] == 0).all()


@pytest.mark.parametrize("d,dv", [(192, 128), (24, 16)])
def test_grads_at_v_head_dims_other_than_d_match_jax(d, dv):
    """Autograd through `flash_attention` (the plain forward and
    `flash_bwd_plain`) against jax.grad through JAX's Pallas kernels in
    interpret mode, D != Dv, two documents and a padded tail."""
    q, k, v, seg = _packed(1, 256, 2, 2, 2, seed=40 + d, d=d, dv=dv)
    co = np.random.default_rng(41).standard_normal((1, 256, 2, dv), dtype=np.float32)
    jseg, jco = jnp.asarray(seg), jnp.asarray(co)

    def j_loss(q_, k_, v_):
        out = j_flash(q_, k_, v_, jseg, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(out * jco)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out, _ = tflash.flash_attention(*leaves, _t(seg))
    assert out.shape == (1, 256, 2, dv)
    (out * _t(co)).sum().backward()
    for got, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d,dv", DIMS)
def test_group_sum_and_outputs_take_the_v_head_dim(d, dv):
    """`group_sum` sums dk_h (D) and dv_h (Dv) per group; the kernels'
    output allocations (`fwd_outputs`, `bwd_outputs`) give out, dv and
    dv_h the v head dim."""
    q = torch.zeros((2, 130, 8, d))
    k = torch.zeros((2, 130, 2, d))
    v = torch.zeros((2, 130, 2, dv))
    dv_h = torch.arange(2 * 130 * 8 * dv, dtype=torch.float32).reshape(2, 130, 8, dv)
    summed = tflash.group_sum(dv_h, 2, torch.float32)
    assert torch.equal(summed, dv_h.reshape(2, 130, 2, 4, dv).sum(3))
    out, lse, tiles = tflash.fwd_outputs(q, v)
    assert out.shape == (2, 130, 8, dv) and lse.shape == (2, 8, 130)
    assert tiles.shape == (2, 4, 4) and tiles.dtype == torch.int32  # 130 -> Lp 256, 64-row tiles
    assert [t.shape for t in tflash.bwd_outputs(q, k, v, False)] == [k.shape, v.shape]
    assert [t.shape for t in tflash.bwd_outputs(q, k, v, True)] == [q.shape, (2, 130, 8, dv)]


def test_kernel_checks_take_the_kernels_head_dims():
    """The wrappers' checks (run before any launch) take (D, Dv) in
    KERNEL_DIMS, v's head dim apart from k's, and do of v's head dim."""
    def tensors(d, dv, hq=4, hkv=4):
        q = torch.zeros((1, 64, hq, d), dtype=torch.bfloat16)
        k = torch.zeros((1, 64, hkv, d), dtype=torch.bfloat16)
        v = torch.zeros((1, 64, hkv, dv), dtype=torch.bfloat16)
        return q, k, v, torch.ones((1, 64), dtype=torch.int32)

    assert tflash.KERNEL_DIMS == ((128, 128), (192, 128), (64, 64), (256, 256), (72, 72))
    assert tflash.BWD_KERNEL_DIMS == ((128, 128), (192, 128), (64, 64), (256, 256), (72, 72))
    for d, dv in tflash.KERNEL_DIMS:
        tflash._check_kernel_args(*tensors(d, dv))
    q, k, v, seg = tensors(64, 64)  # gpt-oss's pair: the backward takes it, with a window
    tflash._check_bwd_args(q, k, v, seg, torch.zeros((1, 4, 64)), torch.zeros((1, 4, 64)),
                           q, "b", window=128)
    for d in (128, 256):  # the one pass and Qwen3.5's pair take no window
        q, k, v, seg = tensors(d, d)
        with pytest.raises(ValueError, match="no sliding window"):
            tflash._check_bwd_args(q, k, v, seg, torch.zeros((1, 4, 64)),
                                   torch.zeros((1, 4, 64)), q, "b", window=128)
    for d, dv in tflash.BWD_KERNEL_DIMS:
        q, k, v, seg = tensors(d, dv)
        tflash._check_kernel_args(q, k, v, seg)
        lse = torch.zeros((1, 4, 64))
        tflash._check_bwd_args(q, k, v, seg, lse, lse, torch.zeros((1, 64, 4, dv),
                                                                   dtype=torch.bfloat16), "b")
        with pytest.raises(ValueError, match="do must be"):
            tflash._check_bwd_args(q, k, v, seg, lse, lse, q if d != dv else q[..., :32], "b")
    for d, dv in ((192, 192), (128, 64), (24, 16), (256, 128)):
        with pytest.raises(ValueError, match="head_dim"):
            tflash._check_kernel_args(*tensors(d, dv))
    q, k, v, seg = tensors(192, 128)
    with pytest.raises(ValueError, match="v "):
        tflash._check_kernel_args(q, k, v[:, :32], seg)


def test_unported_options_raise():
    q, k, v, seg = _packed(1, 64, 2, 2, 1, seed=6)
    # non-causal attention runs in the kernels at (64, 64) only: a CUDA call
    # at (128, 128), or with a window, raises (tests/test_torch_kernels.py);
    # the check itself reads only the shapes
    with pytest.raises(NotImplementedError, match="train-slice"):
        tflash._check_causal(_t(q), _t(v), None, False, "flash_attention")
    for d, dv in ((192, 128), (256, 256)):  # the other pairs Queue 2 A1 keeps
        with pytest.raises(NotImplementedError, match="non-causal flash_bwd"):
            tflash._check_causal(torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2, dv), None, False,
                                 "flash_bwd")
    with pytest.raises(NotImplementedError, match="window"):
        tflash._check_causal(_t(q)[..., :64], _t(v)[..., :64], 16, False, "flash_attention")
    # (72, 72) is built non-causal only: a causal call there raises, a
    # non-causal one passes the check
    with pytest.raises(NotImplementedError, match="causal flash_attention at"):
        tflash._check_causal(_t(q)[..., :72], _t(v)[..., :72], None, True, "flash_attention")
    tflash._check_causal(_t(q)[..., :72], _t(v)[..., :72], None, False, "flash_attention")
    # the backward takes a window (tests/test_torch_gpt_oss_train.py holds
    # it to JAX); a window that is not positive raises
    tq = _t(q).requires_grad_(True)
    out, _ = tflash.flash_attention(tq, _t(k), _t(v), _t(seg), window=16)
    out.sum().backward()
    assert torch.isfinite(tq.grad).all()
    with pytest.raises(ValueError, match="must be positive"):
        tflash.flash_bwd(*(_t(a) for a in (q, k, v, seg)), torch.zeros((1, 2, 64)),
                         torch.zeros((1, 2, 64)), _t(q), 1.0, window=0)
