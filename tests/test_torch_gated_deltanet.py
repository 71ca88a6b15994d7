"""The gated delta rule and the GatedDeltaNet module of the PyTorch port
(`xtuner_tpu_torch`) against the JAX package, on the CPU.

Every input comes from a numpy seed and reaches both packages as the same
arrays. Neither side has a kernel here: JAX computes the recurrence in
plain jnp, the port in plain torch, both in f32, so they differ only in
summation order: 1e-5 (absolute and relative; the outputs are O(1-5)).

- the sequential scan (the oracle), with and without packed segment
  resets, an initial state and the final state;
- one decode step, and a chain of steps against the scan;
- the chunked WY form against JAX's chunked form, and the port's chunked
  form with an initial and a final state (which JAX's lacks; the serving
  prefill runs it) against the scan;
- `gdn_forward` over packed rows;
- `gdn_cached_forward`: a prompt chunk with left padding (`valid`), a
  right-padded prompt (`n_valid`), and decode steps; a prompt padded from
  13 to 16 tokens leaves the state and conv buffer of the unpadded prompt,
  bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.module import gated_deltanet as jgdn
from xtuner_tpu.ops import gated_deltanet as jops
from xtuner_tpu_torch.module import gated_deltanet as tgdn
from xtuner_tpu_torch.ops import gated_deltanet as tops

TOL = 1e-5


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


def _rule_inputs(b=2, l=50, h=3, dk=8, dv=6, seed=0):
    """q, k (l2-normed, as the module feeds them), v, alpha in [0.5, 1),
    beta in [0, 1), packed segment ids (a reset mid-row, a padded tail)
    and an initial state."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, l, h, dk)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, l, h, dv)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (b, l, h)).astype(np.float32)
    be = rng.uniform(0.0, 1.0, (b, l, h)).astype(np.float32)
    seg = np.ones((b, l), np.int32)
    seg[0, 20:] = 2
    seg[1, l - 5:] = 0
    s0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    return q, k, v, a, be, seg, s0


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_scan_matches_jax(with_seg, with_init):
    q, k, v, a, be, seg, s0 = _rule_inputs()
    seg = seg if with_seg else None
    s0 = s0 if with_init else None
    jo, js = jops.gated_delta_rule_scan(
        *map(jnp.asarray, (q, k, v, a, be)), None if seg is None else jnp.asarray(seg),
        initial_state=None if s0 is None else jnp.asarray(s0), return_state=True)
    to, ts = tops.gated_delta_rule_scan(
        *map(_t, (q, k, v, a, be)), None if seg is None else _t(seg),
        initial_state=None if s0 is None else _t(s0), return_state=True)
    assert to.dtype == ts.dtype == torch.float32
    _close(to, jo)
    _close(ts, js)
    assert torch.equal(tops.gated_delta_rule_scan(
        *map(_t, (q, k, v, a, be)), None if seg is None else _t(seg),
        initial_state=None if s0 is None else _t(s0)), to)


def test_doc_start_mask_matches_jax():
    seg = np.array([[1, 1, 2, 2, 0, 0], [0, 3, 3, 4, 4, 4]], np.int32)
    np.testing.assert_array_equal(tops._doc_start_mask(_t(seg)).numpy(),
                                  np.asarray(jops._doc_start_mask(jnp.asarray(seg))))


def test_step_matches_jax_and_chains_to_the_scan():
    q, k, v, a, be, _, s0 = _rule_inputs(l=12, seed=1)
    js, jo = jops.gated_delta_rule_step(*map(jnp.asarray, (s0, q[:, 0], k[:, 0], v[:, 0],
                                                           a[:, 0], be[:, 0])))
    ts, to = tops.gated_delta_rule_step(*map(_t, (s0, q[:, 0], k[:, 0], v[:, 0], a[:, 0],
                                                  be[:, 0])))
    _close(ts, js)
    _close(to, jo)
    state, outs = _t(s0), []
    for t in range(q.shape[1]):
        state, o = tops.gated_delta_rule_step(state, *(_t(x[:, t]) for x in (q, k, v, a, be)))
        outs.append(o)
    so, ss = tops.gated_delta_rule_scan(*map(_t, (q, k, v, a, be)), initial_state=_t(s0),
                                        return_state=True)
    _close(torch.stack(outs, 1), so, 1e-6)
    _close(state, ss, 1e-6)


@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("l,chunk", [(50, 16), (64, 64), (130, 64)])
def test_chunked_matches_jax(with_seg, l, chunk):
    q, k, v, a, be, seg, _ = _rule_inputs(l=l, seed=l)
    seg = jnp.asarray(seg) if with_seg else None
    want = jops.gated_delta_rule_chunked(*map(jnp.asarray, (q, k, v, a, be)), seg, chunk)
    got = tops.gated_delta_rule_chunked(*map(_t, (q, k, v, a, be)),
                                        None if seg is None else _t(seg), chunk)
    _close(got, want)
    _close(got, jops.gated_delta_rule_scan(*map(jnp.asarray, (q, k, v, a, be)), seg))


@pytest.mark.parametrize("l,chunk", [(50, 16), (13, 64), (130, 64)])
def test_chunked_with_state_matches_the_jax_scan(l, chunk):
    """The port's extension: an initial state in, the final state out (a
    tail padded to the chunk passes the state through), against JAX's
    scan with the same initial state."""
    q, k, v, a, be, _, s0 = _rule_inputs(l=l, seed=7 + l)
    jo, js = jops.gated_delta_rule_scan(*map(jnp.asarray, (q, k, v, a, be)),
                                        initial_state=jnp.asarray(s0), return_state=True)
    to, ts = tops.gated_delta_rule_chunked(*map(_t, (q, k, v, a, be)), None, chunk,
                                           initial_state=_t(s0), return_state=True)
    _close(to, jo)
    _close(ts, js)


def _gdn_cfgs(**kw):
    fields = dict(num_v_heads=4, num_k_heads=2, head_k_dim=8, head_v_dim=8,
                  conv_kernel_size=4, chunk_size=16, **kw)
    return jgdn.GatedDeltaNetConfig(**fields), tgdn.GatedDeltaNetConfig(**fields)


def _gdn_params(cfg, hidden, seed):
    """The module's weights at O(1) scale (JAX's init is 0.02), with
    nonzero a_log and dt_bias and a norm weight away from 1."""
    rng = np.random.default_rng(seed)
    shapes = {"in_proj_qkvz": (hidden, 2 * cfg.qk_dim + 2 * cfg.v_dim),
              "in_proj_ba": (hidden, 2 * cfg.num_v_heads), "out_proj": (cfg.v_dim, hidden)}
    p = {n: {"w": (rng.standard_normal(s) * 0.3).astype(np.float32)}
         for n, s in shapes.items()}
    p["conv_w"] = (rng.standard_normal((cfg.conv_kernel_size, cfg.conv_channels)) * 0.5
                   ).astype(np.float32)
    p["a_log"] = (rng.standard_normal(cfg.num_v_heads) * 0.5).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(cfg.num_v_heads) * 0.5).astype(np.float32)
    p["norm"] = (1.0 + rng.standard_normal(cfg.head_v_dim) * 0.2).astype(np.float32)
    return p


def test_param_specs_match_jax():
    jcfg, tcfg = _gdn_cfgs()
    jspecs = jgdn.gdn_param_specs(jcfg, 32)
    tspecs = tgdn.gdn_param_specs(tcfg, 32)
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: hasattr(x, "shape"))
    want = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in flat[0]}
    got = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in jax.tree_util.
           tree_flatten_with_path(tspecs, is_leaf=lambda x: hasattr(x, "shape"))[0]}
    assert got == want
    assert tcfg.conv_channels == jcfg.conv_channels


def test_gdn_forward_matches_jax():
    jcfg, tcfg = _gdn_cfgs()
    hidden = 32
    p = _gdn_params(jcfg, hidden, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, hidden)).astype(np.float32)
    seg = np.ones((2, 40), np.int32)
    seg[0, 17:] = 2
    seg[1, 33:] = 0
    want = jgdn.gdn_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), jnp.asarray(seg))
    got = tgdn.gdn_forward(jax.tree.map(_t, p), tcfg, _t(x), _t(seg))
    _close(got, want)
    # no segments: one document a row
    _close(tgdn.gdn_forward(jax.tree.map(_t, p), tcfg, _t(x)),
           jgdn.gdn_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x)))


def _cached_case(seed=5, b=2, c=13, hidden=32):
    jcfg, tcfg = _gdn_cfgs()
    p = _gdn_params(jcfg, hidden, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, c, hidden)).astype(np.float32)
    s0 = rng.standard_normal((b, 4, 8, 8)).astype(np.float32) * 0.5
    conv0 = rng.standard_normal((b, 3, jcfg.conv_channels)).astype(np.float32)
    return jcfg, tcfg, p, x, s0, conv0


def test_cached_forward_left_pad_and_decode_match_jax():
    """A prompt chunk with left padding (`valid`), then three decode steps
    continued from the returned state and conv buffer."""
    jcfg, tcfg, p, x, s0, conv0 = _cached_case()
    valid = np.ones(x.shape[:2], bool)
    valid[1, :4] = False
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    jo, js, jc = jgdn.gdn_cached_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(s0),
                                         jnp.asarray(conv0), jnp.asarray(valid))
    to, ts, tc = tgdn.gdn_cached_forward(tp, tcfg, _t(x), _t(s0), _t(conv0), _t(valid))
    _close(to, jo)
    _close(ts, js)
    _close(tc, jc)
    rng = np.random.default_rng(9)
    for _ in range(3):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jo, js, jc = jgdn.gdn_cached_forward(jp, jcfg, jnp.asarray(xt), js, jc)
        to, ts, tc = tgdn.gdn_cached_forward(tp, tcfg, _t(xt), ts, tc)
        _close(to, jo)
        _close(ts, js)
        _close(tc, jc)


def test_cached_forward_right_pad_matches_jax_and_the_unpadded_prompt():
    """The paged engine's prefill: prompts right-padded to 16 with `valid`
    and `n_valid` (13 and 9 real tokens) against JAX, and the 13-token
    prompt padded to 16 against the same prompt unpadded: the state and the
    conv buffer are the unpadded ones, bit for bit, and so are the real
    rows' outputs."""
    jcfg, tcfg, p, x13, s0, conv0 = _cached_case(seed=11, c=13)
    x = np.zeros((2, 16, 32), np.float32)
    x[:, :13] = x13
    x[:, 13:] = 7.0  # pad rows that must not matter
    n_valid = np.array([13, 9], np.int32)
    valid = np.arange(16)[None] < n_valid[:, None]
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    jo, js, jc = jgdn.gdn_cached_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(s0),
                                         jnp.asarray(conv0), jnp.asarray(valid),
                                         n_valid=jnp.asarray(n_valid))
    to, ts, tc = tgdn.gdn_cached_forward(tp, tcfg, _t(x), _t(s0), _t(conv0), _t(valid),
                                         n_valid=_t(n_valid))
    _close(to.numpy()[valid], np.asarray(jo)[valid])
    _close(ts, js)
    _close(tc, jc)
    uo, us, uc = tgdn.gdn_cached_forward(tp, tcfg, _t(x13[:1]), _t(s0[:1]), _t(conv0[:1]))
    assert torch.equal(ts[:1], us) and torch.equal(tc[:1], uc)
    assert torch.equal(to[:1, :13], uo)
