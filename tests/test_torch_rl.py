"""The port's GRPO RL path (`xtuner_tpu_torch/rl/`, the dense `generate`,
the cached attention, `per_token_logprobs` and the engine's loss hook)
against the JAX package on the CPU.

Inputs are numpy arrays from a seed; weights go through the weight bridge
(`params_from_numpy`). Tolerances, f32 throughout unless a test says
otherwise:
- per-token logprobs and their gradients: 1e-5 (both modes; the fused one
  through the plain versions of #8-#10 here, JAX's Pallas kernels in
  interpret mode);
- the cached attention, generate's logprobs and the losses: 1e-5 / 1e-4
  (summation order through a layer stack and a log-softmax);
- greedy tokens, recorded routing, the packed arrays and the host-side
  pieces (advantages, judgers, replay buffer, trace, evaluator, the
  tokenize function): equal;
- two replayed `RLColocateTrainer` steps: every logged metric within 1e-4
  relative and every updated parameter within 1e-5 absolute.

Sampling cannot match `jax.random` bit for bit: sampled rollouts are held
to their own teacher-forced recompute instead.
"""

import copy
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.config.optim import AdamWConfig as JAdamW
from xtuner_tpu.config.optim import LRConfig as JLR
from xtuner_tpu.datasets.rl_tokenize import RLTextTokenizeFn as JRLTok
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model.dense import DenseConfig as JDense
from xtuner_tpu.model.generate import GenerateConfig as JGen
from xtuner_tpu.model.generate import generate as jgenerate
from xtuner_tpu.model.moe import MoEConfig as JMoE
from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module import rope as jrope
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel.mesh import MeshConfig as JMesh
from xtuner_tpu.rl import advantage as jadv
from xtuner_tpu.rl import evaluator as jeval
from xtuner_tpu.rl import judger as jjudge
from xtuner_tpu.rl import replay_buffer as jrb
from xtuner_tpu.rl import rollout_is as jris
from xtuner_tpu.rl import trainer as jtrainer
from xtuner_tpu.train.toy_tokenizer import UTF8ByteTokenizer as JTok
from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.data_proto import SequenceContext
from xtuner_tpu_torch.datasets.rl_tokenize import RLTextTokenizeFn
from xtuner_tpu_torch.engine.train_engine import TrainEngine
from xtuner_tpu_torch.loss import ce_loss as tce
from xtuner_tpu_torch.model.dense import DenseConfig
from xtuner_tpu_torch.model.generate import GenerateConfig, compute_copy, generate
from xtuner_tpu_torch.model.moe import MoEConfig
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module import rope as trope
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.rl import advantage as tadv
from xtuner_tpu_torch.rl import evaluator as teval
from xtuner_tpu_torch.rl import judger as tjudge
from xtuner_tpu_torch.rl import replay_buffer as trb
from xtuner_tpu_torch.rl import rollout_is as tris
from xtuner_tpu_torch.rl import trainer as ttrainer
from xtuner_tpu_torch.rl.trace import RolloutTraceStore
from xtuner_tpu_torch.train.cli import rl as trl_cli
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer

# the module (the JAX package's `loss/__init__.py` exports the function
# under the module's name)
jce = importlib.import_module("xtuner_tpu.loss.ce_loss")
# the modules (both `rl/__init__.py` export the function under its module's name)
jgrpo = importlib.import_module("xtuner_tpu.rl.grpo_loss")
tgrpo = importlib.import_module("xtuner_tpu_torch.rl.grpo_loss")
REPO = Path(__file__).resolve().parents[1]
LP_TOL = 1e-5
GEN_TOL = 1e-4
CURVE_RTOL = 1e-4
PARAM_ATOL = 1e-5
# the replayed trainers' AdamW lr: each step moves a weight by up to ~lr,
# and a gradient entry near Adam's eps moves by lr times its relative error
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops: many threads
    gain nothing at these sizes and stall badly when several test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------- logprobs
@pytest.mark.parametrize("mode", ["chunk", "fused"])
def test_per_token_logprobs_matches_jax(mode):
    """Values and both gradients, with ignored labels and a ragged last
    chunk (N = 2 x 40 over chunks of 32)."""
    rng = np.random.default_rng(1)
    b, l, h, v = 2, 40, 128, 700
    hid = rng.standard_normal((b, l, h), dtype=np.float32)
    w = (rng.standard_normal((h, v)) * 0.1).astype(np.float32)
    lab = rng.integers(0, v, (b, l)).astype(np.int32)
    lab[0, :5] = -100
    lab[1, -3:] = -100
    cot = rng.standard_normal((b, l)).astype(np.float32)

    def jf(hh, ww):
        return jnp.sum(jce.per_token_logprobs(hh, ww, jnp.asarray(lab), 32, mode=mode) * cot)

    want = jce.per_token_logprobs(jnp.asarray(hid), jnp.asarray(w), jnp.asarray(lab), 32,
                                  mode=mode)
    jdh, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(w))
    th, tw = _t(hid).requires_grad_(True), _t(w).requires_grad_(True)
    got = tce.per_token_logprobs(th, tw, _t(lab), 32, mode=mode)
    (got * _t(cot)).sum().backward()
    _close(got, want, LP_TOL)
    assert float(got[0, :5].detach().abs().max()) == 0.0  # ignored labels give 0
    _close(th.grad, jdh, LP_TOL)
    _close(tw.grad, jdw, LP_TOL)


def test_per_token_logprobs_fused_equals_chunk():
    """The two modes of the port agree with each other too (the card test
    holds #8-#10 to the chunk mode the same way)."""
    rng = np.random.default_rng(2)
    hid = _t(rng.standard_normal((1, 50, 128), dtype=np.float32))
    w = _t((rng.standard_normal((128, 300)) * 0.1).astype(np.float32))
    lab = _t(rng.integers(0, 300, (1, 50)).astype(np.int32))
    _close(tce.per_token_logprobs(hid, w, lab, 16, mode="fused"),
           tce.per_token_logprobs(hid, w, lab, 16).numpy(), LP_TOL)


# ------------------------------------------------------- cached attention
def _attn_params(rng, hidden, hq, hkv, d, gate, sinks):
    q_out = hq * d * (2 if gate else 1)
    p = {"q_proj": {"w": rng.standard_normal((hidden, q_out), dtype=np.float32) * 0.2},
         "k_proj": {"w": rng.standard_normal((hidden, hkv * d), dtype=np.float32) * 0.2},
         "v_proj": {"w": rng.standard_normal((hidden, hkv * d), dtype=np.float32) * 0.2},
         "o_proj": {"w": rng.standard_normal((hq * d, hidden), dtype=np.float32) * 0.2},
         "q_norm": 1 + 0.1 * rng.standard_normal((d,), dtype=np.float32),
         "k_norm": 1 + 0.1 * rng.standard_normal((d,), dtype=np.float32)}
    if sinks:
        p["sinks"] = rng.standard_normal((hq,), dtype=np.float32)
    return p


@pytest.mark.parametrize("window,gate,sinks,c", [
    (None, False, False, 1),
    (6, True, True, 1),
    (5, False, True, 3),  # a chunk of 3 rows over the cache
])
def test_cached_attention_matches_jax(window, gate, sinks, c):
    """`mha_cached_forward` at cache_len 13 over a cache of 24 whose first
    4 slots are left pads (kv_mask False), GQA 4 / 2 heads, qk-norm."""
    rng = np.random.default_rng(7)
    hidden, hq, hkv, d, b, s, clen = 32, 4, 2, 16, 2, 24, 13
    p = _attn_params(rng, hidden, hq, hkv, d, gate, sinks)
    kw = dict(num_attention_heads=hq, num_key_value_heads=hkv, head_dim=d, qk_norm=True,
              with_gate=gate, with_sinks=sinks)
    x = rng.standard_normal((b, c, hidden), dtype=np.float32)
    ck = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    cv = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    kv_mask = np.ones((b, s), bool)
    kv_mask[0, :4] = False
    pos = (np.arange(c) + clen)[None].repeat(b, 0).astype(np.int32)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), d, 1e6)
    jo, jck, jcv = jattn.mha_cached_forward(
        jax.tree.map(jnp.asarray, p), jattn.MHAConfig(**kw), jnp.asarray(x), jcos, jsin,
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(clen), window=window,
        kv_mask=jnp.asarray(kv_mask))
    tcos, tsin = trope.rope_cos_sin(_t(pos), d, 1e6)
    tck, tcv = _t(ck), _t(cv)
    tp = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict) else _t(v))
          for k, v in p.items()}
    to, ock, ocv = tattn.mha_cached_forward(tp, tattn.MHAConfig(**kw), _t(x), tcos, tsin,
                                            tck, tcv, clen, window=window, kv_mask=_t(kv_mask))
    assert ock is tck and ocv is tcv  # written in place
    _close(to, jo, GEN_TOL)
    _close(tck, jck, 1e-6)
    _close(tcv, jcv, 1e-6)


# ---------------------------------------------------------------- generate
def _dense_kw():
    return dict(vocab_size=300, num_hidden_layers=2, hidden_size=64, intermediate_size=128,
                eos_token_id=258, rope_theta=1e6)


def _attn_kw():
    return dict(num_attention_heads=4, num_key_value_heads=2, head_dim=16, qk_norm=True)


def _moe_kw():
    return dict(_dense_kw(), moe_intermediate_size=32, n_routed_experts=4,
                num_experts_per_tok=2, balancing_loss_coef=0.0)


def _models(moe=False, chunk=64):
    jc = (JMoE if moe else JDense)(**(_moe_kw() if moe else _dense_kw()),
                                   attention=jattn.MHAConfig(**_attn_kw()),
                                   lm_loss_cfg=JCE(chunk_size=chunk))
    tc = (MoEConfig if moe else DenseConfig)(**(_moe_kw() if moe else _dense_kw()),
                                            attention=tattn.MHAConfig(**_attn_kw()),
                                            lm_loss_cfg=CELossConfig(chunk_size=chunk))
    return jc, tc


@pytest.fixture(scope="module")
def dense_pair():
    jc, tc = _models()
    jp = j_init_params(jc.build().param_specs(), jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, jp)
    return jc, jp, tc, params_from_numpy(np_tree, tc, "cpu", torch.float32), np_tree


@pytest.fixture(scope="module")
def moe_pair():
    jc, tc = _models(moe=True)
    jp = j_init_params(jc.build().param_specs(), jax.random.key(1))
    np_tree = jax.tree.map(np.asarray, jp)
    return jc, jp, tc, params_from_numpy(np_tree, tc, "cpu", torch.float32), np_tree


def _prompts(g, n_unique=2, p=12, pad=256, seed=3):
    """n_unique prompts of ragged length, each repeated g times, left-padded."""
    rng = np.random.default_rng(seed)
    arr = np.full((n_unique * g, p), pad, np.int32)
    for i in range(n_unique):
        n = p - 2 - 3 * i
        arr[i * g:(i + 1) * g, -n:] = rng.integers(0, 256, n)
    return arr


@pytest.mark.parametrize("g", [1, 4])
def test_generate_greedy_matches_jax(dense_pair, g):
    jc, jp, tc, tp, _ = dense_pair
    prompt = _prompts(g)
    jg = JGen(max_new_tokens=7, do_sample=False, temperature=0.0, eos_token_id=258)
    tg = GenerateConfig(max_new_tokens=7, do_sample=False, temperature=0.0, eos_token_id=258)
    want = jgenerate(jc.build(), jp, prompt, jg, compute_dtype=jnp.float32, pad_token_id=256,
                     return_logprobs=True, prompt_group_size=g)
    got = generate(tc.build(), tp, prompt, tg, compute_dtype=torch.float32, pad_token_id=256,
                   return_logprobs=True, prompt_group_size=g)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_array_equal(got["generated"], want["generated"])
    _close(got["logprobs"], want["logprobs"], GEN_TOL)


def test_generate_stop_ids_match_jax(dense_pair):
    """A stop id taken from the greedy run itself (its first token): after
    it the row emits eos, as JAX's does."""
    jc, jp, tc, tp, _ = dense_pair
    prompt = _prompts(1)
    base = generate(tc.build(), tp, prompt, GenerateConfig(
        max_new_tokens=7, do_sample=False, eos_token_id=258))["generated"]
    stop = int(base[0, 0])
    want = jgenerate(jc.build(), jp, prompt, JGen(max_new_tokens=7, do_sample=False,
                     eos_token_id=258, stop_token_ids=[stop]), compute_dtype=jnp.float32,
                     pad_token_id=256)
    got = generate(tc.build(), tp, prompt, GenerateConfig(
        max_new_tokens=7, do_sample=False, eos_token_id=258, stop_token_ids=[stop]),
        compute_dtype=torch.float32, pad_token_id=256)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert (got["generated"][0, 1:] == 258).all()


def _teacher_forced(model, params, prompt_row, resp, pad):
    ids = [t for t in prompt_row.tolist() if t != pad] + resp.tolist()
    n = len(ids)
    seq_ctx = SequenceContext(torch.tensor([ids]), torch.ones((1, n), dtype=torch.int32),
                              torch.arange(n)[None])
    hidden = model.forward(params, seq_ctx, compute_dtype=torch.float32)
    labels = torch.tensor([ids[1:] + [-100]])
    lps = tce.per_token_logprobs(hidden, model.lm_head_weight(params), labels, 16)
    return lps[0, n - len(resp) - 1:n - 1]


def test_sampled_logprobs_match_teacher_forced(dense_pair):
    """Sampled rollouts (temperature 0.7, top-k 50, groups of 4): the
    decode's logprob of each sampled token is the raw log-softmax that a
    teacher-forced forward over prompt + response gives."""
    _, _, tc, tp, _ = dense_pair
    model = tc.build()
    prompt = _prompts(4)
    gcfg = GenerateConfig(max_new_tokens=9, temperature=0.7, top_k=50, eos_token_id=258)
    out = generate(model, tp, prompt, gcfg, generator=torch.Generator().manual_seed(5),
                   compute_dtype=torch.float32, pad_token_id=256, return_logprobs=True,
                   prompt_group_size=4)
    assert len({tuple(r) for r in out["generated"][:4]}) > 1  # the group's rows differ
    for row in range(prompt.shape[0]):
        resp = out["generated"][row]
        assert 258 not in resp.tolist()  # no stop: every logprob is the sampled token's
        _close(_teacher_forced(model, tp, prompt[row], resp, 256), out["logprobs"][row],
               GEN_TOL)


def test_record_routing_matches_jax(moe_pair):
    """Greedy decode of a tiny MoE with `record_routing`: (B, N, nL, K)
    expert ids equal to JAX's, tokens and logprobs too."""
    jc, jp, tc, tp, _ = moe_pair
    prompt = _prompts(2)
    jg = JGen(max_new_tokens=6, do_sample=False, eos_token_id=258)
    tg = GenerateConfig(max_new_tokens=6, do_sample=False, eos_token_id=258)
    want = jgenerate(jc.build(), jp, prompt, jg, compute_dtype=jnp.float32, pad_token_id=256,
                     return_logprobs=True, record_routing=True, prompt_group_size=2)
    got = generate(tc.build(), tp, prompt, tg, compute_dtype=torch.float32, pad_token_id=256,
                   return_logprobs=True, record_routing=True, prompt_group_size=2)
    assert got["routed_experts"].shape == (4, 6, 2, 2)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    np.testing.assert_array_equal(got["routed_experts"], want["routed_experts"])
    _close(got["logprobs"], want["logprobs"], GEN_TOL)


def test_generate_unported_options_raise(dense_pair):
    _, _, tc, tp, _ = dense_pair
    for kw in ({"repetition_penalty": 1.2}, {"min_tokens": 2}, {"logit_bias": {3: 1.0}},
               {"top_logprobs": 2}):
        with pytest.raises(NotImplementedError, match=r"\[serve-rest\]"):
            generate(tc.build(), tp, _prompts(1), GenerateConfig(max_new_tokens=2, **kw))


def test_compute_copy_gives_the_same_logprobs(dense_pair):
    """The frozen reference in the compute dtype (bf16 layer stacks and
    embedding, the final norm in f32) gives the bf16 forward's logprobs of
    the f32 masters bit for bit, and is a snapshot: moving the masters
    leaves it as it was."""
    _, _, tc, tp, _ = dense_pair
    model = tc.build()
    masters = params_from_numpy(dense_pair[4], tc, "cpu")
    ref = compute_copy(masters, torch.bfloat16)
    assert ref["layers"]["attn"]["q_proj"]["w"].dtype == torch.bfloat16
    assert ref["final_norm"].dtype == torch.float32
    ids = torch.tensor(_prompts(1, p=20, pad=7))
    seq_ctx = SequenceContext(ids, torch.ones_like(ids, dtype=torch.int32),
                              torch.arange(20)[None].repeat(2, 1))
    labels = torch.roll(ids, -1, dims=1)

    def lps(params):
        hid = model.forward(params, seq_ctx, compute_dtype=torch.bfloat16)
        return tce.per_token_logprobs(hid, model.lm_head_weight(params).to(torch.bfloat16),
                                      labels, 16)

    want = lps(masters)
    assert torch.equal(lps(ref), want)
    masters["final_norm"].add_(1.0)
    masters["layers"]["mlp"]["up_proj"]["w"].mul_(2.0)
    assert torch.equal(lps(ref), want)


# ------------------------------------------------------ host-side pieces
def test_advantages_match_jax():
    rng = np.random.default_rng(4)
    for rewards in (rng.random(8), (rng.random(8) > 0.5).astype(float), np.zeros(4),
                    np.asarray([1.0])):
        for est in ("grpo", "dr_grpo", "rloo", "opo", "passk"):
            np.testing.assert_array_equal(tadv.compute_advantage(rewards, est),
                                          jadv.compute_advantage(rewards, est))
        lens = rng.integers(1, 20, len(rewards)).astype(np.float32)
        np.testing.assert_array_equal(tadv.opo_advantage(rewards, lens),
                                      jadv.opo_advantage(rewards, lens))
    with pytest.raises(KeyError):
        tadv.compute_advantage(np.ones(2), "nope")


def test_judgers_match_jax():
    cases = [("so it is 12", "#### 12"), ("\\boxed{3/4} then 7", "3/4"),
             ("1,234 apples", "#### 1234"), ("no number", "#### 5"), ("-3.5.", "#### -3.5"),
             ("the answer is \\boxed{x+1}", "#### x+1"), ("", "#### 0")]
    for text, label in cases:
        assert tjudge.extract_last_number(text) == jjudge.extract_last_number(text)
        assert tjudge.extract_boxed(text) == jjudge.extract_boxed(text)
        for name in ("gsm8k", "math_boxed"):
            assert tjudge.JUDGER_MAP[name]().judge(text, label) == \
                jjudge.JUDGER_MAP[name]().judge(text, label)
    tc = tjudge.ComposedJudger({"a": tjudge.GSM8KJudger(), "b": tjudge.MathBoxedJudger()},
                               {"a": 0.5})
    jc = jjudge.ComposedJudger({"a": jjudge.GSM8KJudger(), "b": jjudge.MathBoxedJudger()},
                               {"a": 0.5})
    for src in ("a", "b", "zzz"):
        assert tc.judge("\\boxed{4}", "4", src) == jc.judge("\\boxed{4}", "4", src)
    with pytest.raises(NotImplementedError, match=r"\[rl-rest\]"):
        tjudge.HTTPJudger(["http://localhost:1"])


def _groups(cls, n=5):
    return [cls(prompt_id=i, samples=[{"x": i}], policy_version=i % 3,
                meta={"mean_reward": i / 10}) for i in range(n)]


def test_replay_buffer_matches_jax():
    tb, jb = trb.ReplayBuffer(max_staleness=1), jrb.ReplayBuffer(max_staleness=1)
    for tg, jg in zip(_groups(trb.SampleGroup), _groups(jrb.SampleGroup)):
        tb.put(tg)
        jb.put(jg)
    q = {"$or": [{"policy_version": {"$in": [0, 2]}}, {"mean_reward": {"$between": [0.3, 0.35]}}]}
    assert [g.prompt_id for g in tb.query(q)] == [g.prompt_id for g in jb.query(q)]
    assert [g.prompt_id for g in tb.query({"prompt_id": {"$gte": 2}}, pop=True, limit=2)] == \
        [g.prompt_id for g in jb.query({"prompt_id": {"$gte": 2}}, pop=True, limit=2)]
    assert tb.maybe_expire(2) == jb.maybe_expire(2)
    assert [g.prompt_id for g in tb.get(2)] == [g.prompt_id for g in jb.get(2)]
    assert len(tb) == len(jb) and tb.num_samples() == jb.num_samples()
    tb.put(_groups(trb.SampleGroup, 1)[0])
    with pytest.raises(KeyError):
        tb.query({"nope": 1})


def test_trace_store_round_trip(tmp_path):
    """The port's shards are JAX's: written by one, read by the other."""
    from xtuner_tpu.rl.trace import RolloutTraceStore as JStore

    groups = [trb.SampleGroup(prompt_id=3, policy_version=1, samples=[
        {"prompt_ids": [1, 2], "response_ids": [5, 258], "logprobs": [-0.5, -1.0],
         "reward": 1.0, "advantage": 0.5}], meta={})]
    RolloutTraceStore(tmp_path).record(1, groups, tokenizer=UTF8ByteTokenizer())
    jg = JStore(tmp_path).load_groups(1)
    tg = RolloutTraceStore(tmp_path).load_groups(1)
    assert [(g.prompt_id, g.samples, g.meta) for g in tg] == \
        [(g.prompt_id, g.samples, g.meta) for g in jg]
    assert RolloutTraceStore(tmp_path).steps() == [1]


def test_jax_trace_drops_routing_and_the_port_does_not(tmp_path):
    """A capture of R3 samples: JAX's shards drop `routed_experts`, so its
    replay trains without the recorded routing; the port's shards keep it
    and its replay packs it (JAX reads the port's shards as before)."""
    from xtuner_tpu.rl.trace import RolloutTraceStore as JStore

    routed = np.arange(12, dtype=np.int32).reshape(3, 2, 2)
    sample = {"prompt_ids": [1, 2], "response_ids": [5, 6, 258], "logprobs": [-1.0] * 3,
              "reward": 0.0, "advantage": 1.0, "routed_experts": routed}
    JStore(tmp_path / "j").record(1, [jrb.SampleGroup(prompt_id=0, samples=[sample])])
    RolloutTraceStore(tmp_path / "t").record(1, [trb.SampleGroup(prompt_id=0,
                                                                 samples=[sample])])
    assert "routed_experts" not in JStore(tmp_path / "j").load_groups(1)[0].samples[0]
    got = RolloutTraceStore(tmp_path / "t").load_groups(1)[0].samples[0]
    np.testing.assert_array_equal(got["routed_experts"], routed)
    assert JStore(tmp_path / "t").load_groups(1)[0].samples[0]["response_ids"] == [5, 6, 258]


def test_evaluator_matches_jax(tmp_path):
    path = tmp_path / "eval.jsonl"
    path.write_text("".join(json.dumps({"prompt": f"q{i}", "label": f"#### {i}",
                                        "source": "s" if i % 2 else "default"}) + "\n"
                            for i in range(4)))
    responses = [[f"{i}", "x", f"{i}", "7"] for i in range(4)]

    def gen(items, n):
        return responses[:len(items)]

    tm = teval.Evaluator(teval.EvaluatorConfig(eval_path=str(path), samples_per_prompt=4,
                                               pass_k=[1, 2]), tjudge.GSM8KJudger(), gen).run()
    jm = jeval.Evaluator(jeval.EvaluatorConfig(eval_path=str(path), samples_per_prompt=4,
                                               pass_k=[1, 2]), jjudge.GSM8KJudger(), gen).run()
    assert tm == jm
    for n, c, k in ((5, 2, 1), (5, 2, 3), (4, 0, 2), (3, 3, 2)):
        assert teval.pass_at_k(n, c, k) == jeval.pass_at_k(n, c, k)


def test_rl_tokenize_matches_jax():
    items = [{"prompt": [{"role": "user", "content": "2+2?"}], "data_source": "gsm",
              "reward_model": {"ground_truth": "4"}, "extra_info": {"i": 1}},
             {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "hi"},
                           {"role": "assistant", "content": "yo"},
                           {"role": "user", "content": "3*3?"}], "label": "#### 9"},
             {"prompt": "x" * 90, "label": "1"}]
    kw = dict(max_length=64, system_prompt="S")
    tf, jf = RLTextTokenizeFn(UTF8ByteTokenizer(), **kw), JRLTok(JTok(), **kw)
    for item in items:
        assert tf(copy.deepcopy(item)) == jf(copy.deepcopy(item))
    assert tf.hash() == jf.hash()


# ------------------------------------------------------- rollout-IS, losses
def _rl_arrays(seed=5, b=4, l=12):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, l)) > 0.3
    mask[-1] = False  # a row without response tokens
    lp = -rng.random((b, l)).astype(np.float32) * 3
    old = (lp + 0.3 * rng.standard_normal((b, l))).astype(np.float32)
    roll = (old + 0.5 * rng.standard_normal((b, l))).astype(np.float32)
    ref = (lp + 0.2 * rng.standard_normal((b, l))).astype(np.float32)
    adv = np.repeat(rng.standard_normal((b, 1)), l, 1).astype(np.float32)
    return lp, old, roll, ref, adv, mask


def _metrics_close(got: dict, want: dict, tol=LP_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("level", ["token", "sequence", "geometric"])
@pytest.mark.parametrize("mode,veto", [("truncate", None), ("mask", (0.3, 3.0)),
                                       ("both", (0.5, 2.0))])
def test_rollout_is_matches_jax(level, mode, veto):
    _, old, roll, _, _, mask = _rl_arrays()
    kw = dict(level=level, mode=mode, threshold_upper=1.5, veto_threshold=veto)
    jw, jm, jmet = jris.compute_rollout_is(jnp.asarray(old), jnp.asarray(roll),
                                           jnp.asarray(mask), jris.RolloutISConfig(**kw))
    tw, tm, tmet = tris.compute_rollout_is(_t(old), _t(roll), _t(mask),
                                           tris.RolloutISConfig(**kw))
    _close(tw, jw, LP_TOL)
    _close(tm, jm, 0)
    _metrics_close(tmet, jmet)
    _metrics_close(tris.mismatch_metrics(_t(old), _t(roll), _t(mask)),
                   jris.mismatch_metrics(jnp.asarray(old), jnp.asarray(roll), jnp.asarray(mask)))
    with pytest.raises(ValueError):
        tris.RolloutISConfig(threshold_upper=0.5)


def test_rollout_is_reference_choices():
    """The three ADVICE r5 points, each kept as JAX has it (not as the
    upstream trainer): (1) no `valid` flag, so an all-padding batch
    merges as a valid one and its sequence max/min stay -inf/+inf;
    (2) `rollout_is_seq_std` is the population std (n, not n - 1);
    (3) the merge takes the first batch's keys and raises KeyError on a
    batch that lacks one."""
    _, old, roll, _, _, mask = _rl_arrays()
    cfg = tris.RolloutISConfig()
    # (1)
    _, _, empty = tris.compute_rollout_is(_t(old), _t(roll), _t(np.zeros_like(mask)), cfg)
    assert "valid" not in empty and float(empty["rollout_is_seq_max"]) == -np.inf
    _, _, full = tris.compute_rollout_is(_t(old), _t(roll), _t(mask), cfg)
    merged = tris.merge_rollout_is_metrics([full, empty])
    assert merged == jris.merge_rollout_is_metrics([
        {k: float(v) for k, v in full.items()}, {k: float(v) for k, v in empty.items()}])
    assert merged["rollout_is_mean"] == pytest.approx(float(full["rollout_is_mean"]) / 2)
    # (2)
    w = np.exp(np.clip((old - roll) * mask, -20, 20)) * mask
    seq_mean = (w * mask).sum(-1)[:3] / mask.sum(-1)[:3]
    assert float(full["rollout_is_seq_std"]) == pytest.approx(seq_mean.std(ddof=0), rel=1e-5)
    # (3)
    with pytest.raises(KeyError):
        tris.merge_rollout_is_metrics([{"a": 1.0, "b": 2.0}, {"a": 1.0}])
    with pytest.raises(KeyError):
        jris.merge_rollout_is_metrics([{"a": 1.0, "b": 2.0}, {"a": 1.0}])


@pytest.mark.parametrize("kind", ["k1", "abs", "k2", "k3", "low_var_kl", "mse", "kl"])
def test_kl_penalty_matches_jax(kind):
    lp, _, _, ref, _, _ = _rl_arrays()
    _close(tgrpo.kl_penalty(_t(lp), _t(ref), kind),
           jgrpo.kl_penalty(jnp.asarray(lp), jnp.asarray(ref), kind), LP_TOL)


@pytest.mark.parametrize("kw,with_roll", [
    (dict(), False),
    (dict(kl_coef=0.1, kl_type="k2", is_clip=1.3), False),
    (dict(kl_coef=0.05, cliprange_high=0.28), True),
    (dict(rollout_is=dict(level="sequence", mode="both", veto_threshold=(0.2, 5.0))), True),
])
def test_grpo_loss_matches_jax(kw, with_roll):
    """Loss, metrics and d loss / d logprobs."""
    lp, old, roll, ref, adv, mask = _rl_arrays()
    denom = float(mask.sum()) + 3.0  # a global denominator over more micro-batches
    j_kw = dict(kw)
    t_kw = dict(kw)
    if "rollout_is" in kw:
        j_kw["rollout_is"] = jris.RolloutISConfig(**kw["rollout_is"])
        t_kw["rollout_is"] = tris.RolloutISConfig(**kw["rollout_is"])
    roll_j = jnp.asarray(roll) if with_roll else None
    roll_t = _t(roll) if with_roll else None

    def jf(x):
        return jgrpo.grpo_loss(x, jnp.asarray(old), jnp.asarray(adv), jnp.asarray(mask),
                               jgrpo.GRPOLossConfig(**j_kw), ref_logprobs=jnp.asarray(ref),
                               global_denom=jnp.float32(denom), rollout_logprobs=roll_j)

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(lp))
    x = _t(lp).requires_grad_(True)
    tl, tm = tgrpo.grpo_loss(x, _t(old), _t(adv), _t(mask), tgrpo.GRPOLossConfig(**t_kw),
                             ref_logprobs=_t(ref), global_denom=torch.tensor(denom),
                             rollout_logprobs=roll_t)
    tl.backward()
    _close(tl, jl, LP_TOL)
    _metrics_close(tm, jm)
    _close(x.grad, jg, LP_TOL)


@pytest.mark.parametrize("global_counts", [False, True])
def test_oreal_loss_matches_jax(global_counts):
    lp, old, _, ref, adv, mask = _rl_arrays(seed=8)
    kw = dict(kl_coef=0.02, positive_loss_factor=0.7, pos_sft_loss_weight=0.5,
              negative_loss_factor=1.3)
    counts = (np.float32(40.0), np.float32(9.0)) if global_counts else (None, None)

    def jf(x):
        return jgrpo.oreal_loss(x, jnp.asarray(old), jnp.asarray(adv), jnp.asarray(mask),
                                jgrpo.OREALLossConfig(**kw), ref_logprobs=jnp.asarray(ref),
                                global_pos=None if counts[0] is None else jnp.asarray(counts[0]),
                                global_neg=None if counts[1] is None else jnp.asarray(counts[1]))

    (jl, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(lp))
    x = _t(lp).requires_grad_(True)
    tl, tm = tgrpo.oreal_loss(x, _t(old), _t(adv), _t(mask), tgrpo.OREALLossConfig(**kw),
                              ref_logprobs=_t(ref),
                              global_pos=None if counts[0] is None else torch.tensor(counts[0]),
                              global_neg=None if counts[1] is None else torch.tensor(counts[1]))
    tl.backward()
    _close(tl, jl, LP_TOL)
    _metrics_close(tm, jm)
    _close(x.grad, jg, LP_TOL)


# ------------------------------------------------------------- the trainer
def _prompt_file(tmp_path):
    path = tmp_path / "prompts.jsonl"
    path.write_text("".join(json.dumps({"prompt": f"What is {i} plus {i}?",
                                        "label": f"#### {2 * i}"}) + "\n" for i in range(8)))
    return path


def _recorded_groups(seed, steps=2, n_prompts=2, g=4, moe=False):
    """Recorded rollouts per step: prompts of the toy tokenizer's bytes,
    responses of 3-9 tokens, logprobs near the tiny model's, advantages
    +-1 per group (the policy gradient is not zero), and with `moe` the
    (n, 2 layers, top-2) routing of each response token."""
    rng = np.random.default_rng(seed)
    out = {}
    for step in range(1, steps + 1):
        groups = []
        for pi in range(n_prompts):
            prompt = rng.integers(0, 256, int(rng.integers(10, 30))).tolist()
            samples = []
            for gi in range(g):
                n = int(rng.integers(3, 10))
                s = {"prompt_ids": prompt, "response_ids": rng.integers(0, 300, n).tolist(),
                     "logprobs": (-5.7 + 0.15 * rng.standard_normal(n)).tolist(),
                     "reward": float(gi % 2), "advantage": 1.0 if gi % 2 else -1.0}
                if moe:
                    s["routed_experts"] = np.stack([rng.permutation(4)[:2]
                                                    for _ in range(2 * n)]).reshape(n, 2, 2)
                samples.append(s)
            groups.append((pi, samples))
        out[step] = groups
    return out


def _trainer_pair(tmp_path, moe, kl, replay_dir=None, **kw):
    jc, tc = _models(moe=moe, chunk=128)
    common = dict(prompts_path=str(_prompt_file(tmp_path)), group_size=4, prompts_per_step=2,
                  total_steps=2, max_prompt_length=40, rollout_routing_replay=moe,
                  debug_rollout_replay_from=replay_dir, exp_name="rl", **kw)
    jt = jtrainer.RLColocateTrainer(jtrainer.RLTrainerConfig(
        model_cfg=jc, optim_cfg=JAdamW(lr=LR), lr_cfg=JLR(lr_type="constant", warmup_ratio=0.0),
        mesh_cfg=JMesh(param_dtype="float32"), loss_cfg=jgrpo.GRPOLossConfig(kl_coef=kl),
        gen_cfg=JGen(max_new_tokens=10, eos_token_id=258), work_dir=str(tmp_path / "jax"),
        **common))
    tt = ttrainer.RLColocateTrainer(ttrainer.RLTrainerConfig(
        model_cfg=tc, optim_cfg=AdamWConfig(lr=LR),
        lr_cfg=LRConfig(lr_type="constant", warmup_ratio=0.0),
        mesh_cfg=MeshConfig(param_dtype="float32"), loss_cfg=tgrpo.GRPOLossConfig(kl_coef=kl),
        gen_cfg=GenerateConfig(max_new_tokens=10, eos_token_id=258),
        work_dir=str(tmp_path / "torch"), **common), device="cpu")
    init = jax.tree.map(np.asarray, jt.engine.params)
    tt.engine.load_params(params_from_numpy(init, tc, "cpu"))
    if kl:
        tt.ref_params = compute_copy(tt.engine.params, tt.engine.compute_dtype)
    return jt, tt


def _tracker(trainer):
    return [json.loads(x) for x in (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]


def _check_same_run(jt, tt, keys, init):
    jrecs, trecs = _tracker(jt), _tracker(tt)
    assert len(trecs) == len(jrecs) == 2
    for jr, tr in zip(jrecs, trecs):
        for k in keys:
            np.testing.assert_allclose(tr[k], jr[k], rtol=CURVE_RTOL, atol=1e-7, err_msg=k)
    assert trecs[0]["grad_norm"] > 0 and trecs[0]["skipped"] == 0
    want = dict(tree_paths(jax.tree.map(np.asarray, jt.engine.params)))
    got = dict(tree_paths(tt.engine.params))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, atol=PARAM_ATOL, err_msg=str(path))
    moved = max(float(np.abs(got[p].numpy() - init[p]).max()) for p in want)
    assert moved > 10 * PARAM_ATOL  # the parameters moved well beyond the tolerance
    return trecs


def test_trainer_replay_matches_jax_dense(tmp_path):
    """Two steps replayed from the same recorded shards, KL on (k3 against
    the frozen reference): every logged metric and every updated parameter
    agree with JAX's trainer."""
    store = RolloutTraceStore(tmp_path / "rec")
    for step, groups in _recorded_groups(11).items():
        store.record(step, [trb.SampleGroup(prompt_id=pi, samples=s, policy_version=step)
                            for pi, s in groups])
    jt, tt = _trainer_pair(tmp_path, moe=False, kl=0.1, replay_dir=str(tmp_path / "rec"))
    init = dict(tree_paths(jax.tree.map(np.asarray, jt.engine.params)))
    jt.fit()
    tt.fit()
    trecs = _check_same_run(jt, tt, ("pg_loss", "ratio_mean", "clip_frac", "kl", "total_loss",
                                     "grad_norm", "mean_reward", "lr", "skipped"), init)
    assert trecs[1]["kl"] > 0 and 0 < trecs[0]["clip_frac"] < 1


def test_trainer_r3_matches_jax_moe(tmp_path):
    """A tiny MoE with `rollout_routing_replay`: the same recorded groups,
    with each response token's routing, go through both trainers (their
    `produce_batch` returns them; the trace shards carry no routing). The
    packed arrays, R3's -1-filled replay tensor included, are equal; the
    metrics and the updated parameters agree."""
    rec = _recorded_groups(12, moe=True)
    jt, tt = _trainer_pair(tmp_path, moe=True, kl=0.0)

    def feed(trainer, cls):
        trainer.produce_batch = lambda policy_version: [
            cls(prompt_id=pi, samples=copy.deepcopy(s), policy_version=policy_version,
                meta={"mean_reward": 0.5}) for pi, s in rec[policy_version]]

    feed(jt, jrb.SampleGroup)
    feed(tt, trb.SampleGroup)
    jb = jt._pack(jt.produce_batch(1))
    tb = tt._pack(tt.produce_batch(1))
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    rre = tb["rollout_routed_experts"]
    assert rre.shape == (1, 8, 128, 2, 2) and (rre >= 0).sum() == 2 * 2 * sum(
        len(s["response_ids"]) for _, ss in rec[1] for s in ss)
    init = dict(tree_paths(jax.tree.map(np.asarray, jt.engine.params)))
    jt.fit()
    tt.fit()
    _check_same_run(jt, tt, ("pg_loss", "ratio_mean", "clip_frac", "total_loss", "grad_norm",
                             "lr", "skipped"), init)


def test_pack_without_routing_matches_jax(tmp_path):
    jt, tt = _trainer_pair(tmp_path, moe=False, kl=0.0)
    rec = _recorded_groups(13)[1]
    jb = jt._pack([jrb.SampleGroup(prompt_id=pi, samples=s) for pi, s in rec])
    tb = tt._pack([trb.SampleGroup(prompt_id=pi, samples=s) for pi, s in rec])
    assert set(tb) == set(jb) and "rollout_routed_experts" not in tb
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tt._encode_prompt({"messages": [{"role": "system", "content": "s"},
                                           {"role": "assistant", "content": "a"},
                                           {"role": "user", "content": "u"}]}) == \
        jt._encode_prompt({"messages": [{"role": "system", "content": "s"},
                                        {"role": "assistant", "content": "a"},
                                        {"role": "user", "content": "u"}]})


def test_trainer_rollout_loop_runs(tmp_path):
    """The generating loop (no replay) on the CPU: a capture of 2 steps
    whose shards replay into a second run with the same first step."""
    _, tc = _models(chunk=128)
    cfg = ttrainer.RLTrainerConfig(
        model_cfg=tc, prompts_path=str(_prompt_file(tmp_path)), optim_cfg=AdamWConfig(lr=1e-3),
        mesh_cfg=MeshConfig(param_dtype="float32"), loss_cfg=tgrpo.GRPOLossConfig(kl_coef=0.1),
        gen_cfg=GenerateConfig(max_new_tokens=6, eos_token_id=258), group_size=4,
        prompts_per_step=2, total_steps=2, max_prompt_length=40, debug_rollout_capture=True,
        work_dir=str(tmp_path / "cap"), exp_name="rl")
    cap = cfg.build(device="cpu")
    cap.fit()
    recs = _tracker(cap)
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["ratio_mean"] == pytest.approx(1.0, abs=1e-5)
    assert recs[0]["kl"] == pytest.approx(0.0, abs=1e-6)
    assert 0 < recs[0]["rollout_tokens"] <= 8 * 6  # a row may stop at eos
    assert RolloutTraceStore(cap.work_dir).steps() == [1, 2]
    rep = ttrainer.RLColocateTrainer(ttrainer.RLTrainerConfig(
        **{**cfg.__dict__, "debug_rollout_capture": False, "total_steps": 3,
           "debug_rollout_replay_from": str(cap.work_dir), "work_dir": str(tmp_path / "rep")}),
        device="cpu")
    rep.fit()  # stops after the 2 captured steps
    rrecs = _tracker(rep)
    assert len(rrecs) == 2
    assert rrecs[0]["pg_loss"] == pytest.approx(recs[0]["pg_loss"], abs=1e-6)


def test_trainer_eval_and_sft_interleave_run(tmp_path):
    """The evaluator (every step, 2 samples a prompt, pass@1 and @2) and
    the SFT interleave (one alpaca-demo SFT step on the same engine every
    RL step) in the generating loop: their metrics reach the tracker, the
    SFT step moves the parameters, and the CE falls from the first
    interleaved step to the second."""
    from xtuner_tpu_torch.datasets import config as tdata

    eval_path = tmp_path / "eval.jsonl"
    eval_path.write_text("".join(json.dumps({"prompt": f"{i}+1?", "label": f"#### {i + 1}"})
                                 + "\n" for i in range(3)))
    _, tc = _models(chunk=128)
    cfg = ttrainer.RLTrainerConfig(
        model_cfg=tc, prompts_path=str(_prompt_file(tmp_path)), optim_cfg=AdamWConfig(lr=1e-2),
        mesh_cfg=MeshConfig(param_dtype="float32"),
        gen_cfg=GenerateConfig(max_new_tokens=4, eos_token_id=258), group_size=2,
        prompts_per_step=2, total_steps=2, max_prompt_length=40,
        eval_cfg=teval.EvaluatorConfig(eval_path=str(eval_path), samples_per_prompt=2,
                                       pass_k=[1, 2], eval_interval=1),
        sft_dataloader_cfg=tdata.DataloaderConfig(
            datasets=[tdata.DatasetConfig(anno_path=str(
                REPO / "examples" / "demo_data" / "alpaca_demo.jsonl"))],
            pack_max_length=256, tokenize_num_proc=1),
        sft_interval=1, work_dir=str(tmp_path / "w"), exp_name="rl")
    tr = cfg.build(device="cpu")
    tr.fit()
    recs = _tracker(tr)
    rl = [r for r in recs if "pg_loss" in r]
    sft = [r for r in recs if "sft/reduced_llm_loss" in r]
    evals = [r for r in recs if "eval_pass@2" in r]
    assert len(rl) == 2 and len(sft) == 2 and len(evals) == 3  # 2 intervals + the final
    assert all(0.0 <= r["eval_pass@1"] <= r["eval_pass@2"] <= 1.0 for r in evals)
    assert sft[1]["sft/reduced_llm_loss"] < sft[0]["sft/reduced_llm_loss"]
    assert all(r["sft/skipped"] == 0 for r in sft)


def test_engine_loss_fn_hook_matches_default():
    """`train_step(loss_fn=...)` with a loss equal to the default CE gives
    the same metrics and parameters as `train_step` without it."""
    _, tc = _models(chunk=128)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 300, (2, 2, 64)).astype(np.int32)
    labels = np.where(rng.random((2, 2, 64)) > 0.2, np.roll(ids, -1, -1), -100).astype(np.int32)
    batch = {"input_ids": ids, "segment_ids": np.ones_like(ids),
             "position_ids": np.broadcast_to(np.arange(64, dtype=np.int32), ids.shape).copy(),
             "shifted_labels": labels, "loss_weights": (labels != -100).astype(np.float32)}

    def engine():
        e = TrainEngine(tc, AdamWConfig(lr=1e-2), LRConfig(warmup_steps=1),
                        MeshConfig(param_dtype="float32"), 3, device="cpu")
        e.init_random(0)
        return e

    a, b = engine(), engine()

    def ce(params, mb, denom):
        out = b.model.loss(params, b.seq_ctx(mb), mb["shifted_labels"], mb["loss_weights"],
                           denom, compute_dtype=b.compute_dtype, remat=b.remat)
        return out.total_loss(), {"sum_ce": out.sum_ce, "num_tokens": out.num_tokens}

    for step in (1, 2):
        ma, mb_ = a.train_step(batch, step), b.train_step(batch, step, loss_fn=ce)
        assert ma == mb_
    for (pa, va), (pb, vb) in zip(tree_paths(a.params), tree_paths(b.params)):
        assert pa == pb and torch.equal(va, vb)
    # a loss without sum_ce: no reduced_llm_loss / consumed_tokens, its own metrics summed
    m = b.train_step(batch, 3, loss_fn=lambda p, mb, d: (
        b.model.loss(p, b.seq_ctx(mb), mb["shifted_labels"], mb["loss_weights"], d,
                     compute_dtype=b.compute_dtype).loss, {"rows": torch.tensor(2.0)}))
    assert set(m) == {"total_loss", "rows", "grad_norm", "lr", "skipped"} and m["rows"] == 4.0


# ------------------------------------------------------------- CLI, recipes
def test_cli_loads_configs(tmp_path, monkeypatch):
    """The CLI's config loading: both recipes (their prompt set written
    under work_dirs/ of the working directory), a wrong config type, and a
    tiny config run end to end on the CPU; without a card the default
    device raises before anything is built."""
    monkeypatch.chdir(tmp_path)
    grpo = trl_cli.load_config(str(REPO / "xtuner_tpu_torch/recipes/rl_qwen3_4b_grpo.py"))
    assert count_params(grpo.model_cfg.build().param_specs()) == 4_022_468_096
    assert (grpo.group_size, grpo.prompts_per_step, grpo.max_prompt_length,
            grpo.gen_cfg.max_new_tokens, grpo.loss_cfg.kl_coef) == (8, 4, 128, 384, 0.001)
    assert grpo.mesh_cfg.remat_policy == "full" and grpo.model_cfg.lm_loss_cfg.mode == "chunk"
    prompts = [json.loads(x) for x in Path(grpo.prompts_path).read_text().splitlines()]
    tok = UTF8ByteTokenizer()
    tmpl = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
    assert max(len(tok.encode(tmpl.format(p["prompt"]))) for p in prompts) <= 128
    assert all(p["label"].startswith("#### ") for p in prompts)
    r3 = trl_cli.load_config(str(REPO / "xtuner_tpu_torch/recipes/rl_qwen3_moe_head_r3.py"))
    assert r3.rollout_routing_replay and r3.model_cfg.num_hidden_layers == 4
    assert 3.0e9 < count_params(r3.model_cfg.build().param_specs()) < 3.2e9
    bad = tmp_path / "bad.py"
    bad.write_text("trainer = 3\n")
    with pytest.raises(TypeError):
        trl_cli.main(["--config", str(bad), "--device", "cpu"])
    tiny = tmp_path / "tiny.py"
    tiny.write_text(
        "from xtuner_tpu_torch.config import MeshConfig\n"
        "from xtuner_tpu_torch.model.dense import DenseConfig\n"
        "from xtuner_tpu_torch.model.generate import GenerateConfig\n"
        "from xtuner_tpu_torch.module.attention import MHAConfig\n"
        "from xtuner_tpu_torch.rl.trainer import RLTrainerConfig\n"
        f"trainer = RLTrainerConfig(model_cfg=DenseConfig(vocab_size=300, num_hidden_layers=1,"
        f" hidden_size=32, intermediate_size=64, eos_token_id=258, attention=MHAConfig("
        f"num_attention_heads=2, num_key_value_heads=1, head_dim=16)), prompts_path="
        f"{str(_prompt_file(tmp_path))!r}, mesh_cfg=MeshConfig(param_dtype='float32'), "
        f"gen_cfg=GenerateConfig(max_new_tokens=4), group_size=2, prompts_per_step=2, "
        f"total_steps=1, max_prompt_length=40, exp_name='tiny')\n")
    t = trl_cli.main(["--config", str(tiny), "--device", "cpu"])
    assert len(_tracker(t)) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            trl_cli.main(["--config", str(tiny)])
    with pytest.raises(NotImplementedError, match=r"\[serve-rest\]"):
        ttrainer.RLTrainerConfig(model_cfg=None, prompts_path="x", load_from="/hf").build("cpu")
