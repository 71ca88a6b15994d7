"""The serving slice of the PyTorch port (`xtuner_tpu_torch`) against the
JAX `PagedGenerator`, end to end on the CPU.

A tiny Qwen3 (2 layers, hidden 256, 4 q / 2 kv heads, head_dim 128, vocab
512) gets the same weights in both packages through the weight bridge. JAX
decodes through its default gather path in fp32, the port through its plain
paged-decode and flash versions in fp32: greedy tokens must be identical and
logprobs within 1e-4 (fp32 summation order through two layers and a 512-way
log-softmax).

Sampling cannot match `jax.random` bit for bit, so sampled decoding is
tested for its properties instead: determinism under one generator seed,
and no token outside top-k / top-p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.model import qwen as jqwen
from xtuner_tpu.model.generate import GenerateConfig as JGenerateConfig
from xtuner_tpu.model.paged_generate import PagedGenerator as JPagedGenerator
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu_torch.model import qwen as tqwen
from xtuner_tpu_torch.model.generate import GenerateConfig, _forward_cached, init_cache
from xtuner_tpu_torch.model.paged_generate import PagedGenerator, _sample_rows
from xtuner_tpu_torch.module.params import params_from_numpy

LP_TOL = 1e-4
TINY = (256, 512, 2, 4, 2)  # hidden, inter, layers, q heads, kv heads
TINY_KW = {"head_dim": 128, "vocab": 512}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jqwen._qwen3_dense(*TINY, **TINY_KW)
    tcfg = tqwen._qwen3_dense(*TINY, **TINY_KW)
    jparams = j_init_params(jcfg.build().param_specs(), jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                                torch.float32)
    return jcfg, jparams, tcfg, tparams


def _requests():
    """5 requests for 4 slots (continuous admission): two buckets of prompt
    length, one GRPO group of two sharing a prompt whose tail is not block
    aligned, ragged token budgets so slots free at different steps."""
    rng = np.random.default_rng(3)
    lens, budgets = [5, 70, 33, 33, 12], [9, 6, 12, 7, 10]
    shared = rng.integers(1, 512, size=33).tolist()
    reqs = []
    for i, (n, m) in enumerate(zip(lens, budgets)):
        prompt = shared if i in (2, 3) else rng.integers(1, 512, size=n).tolist()
        r = {"prompt_ids": prompt, "max_new_tokens": m}
        if i in (2, 3):
            r["group"] = "g0"
        reqs.append(r)
    return reqs


def _greedy(cls, **kw):
    return cls(max_new_tokens=12, do_sample=False, temperature=0.0, max_length=128,
               prefix_cache=False, **kw)


def test_paged_generate_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    reqs = _requests()
    jeng = JPagedGenerator(jcfg.build(), jparams, _greedy(JGenerateConfig), max_batch=4,
                           block_size=16, compute_dtype=jnp.float32)
    want = jeng.generate(reqs)
    teng = PagedGenerator(tcfg.build(), tparams, _greedy(GenerateConfig), max_batch=4,
                          block_size=16, compute_dtype=torch.float32)
    got = teng.generate(reqs)
    for w, g in zip(want, got):
        assert g["token_ids"] == w["token_ids"]
        assert g["finish_reason"] == w["finish_reason"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], atol=LP_TOL)
    # block bookkeeping agrees too: every block returned, same refcounts
    assert not teng.cache.tables
    np.testing.assert_array_equal(teng.cache.allocator.refcount,
                                  jeng.cache.allocator.refcount)


def test_group_siblings_share_prompt_blocks(tiny):
    _, _, tcfg, tparams = tiny
    eng = PagedGenerator(tcfg.build(), tparams, _greedy(GenerateConfig), max_batch=4,
                         block_size=16, compute_dtype=torch.float32)
    queue = [dict(r, _idx=i) for i, r in enumerate(_requests())]
    eng.tick(queue, {})  # admits 4: the group pair lands in slots 2 and 3
    t2 = eng.cache.tables[eng.slots[2].seq_id]
    t3 = eng.cache.tables[eng.slots[3].seq_id]
    assert t2[:2] == t3[:2]  # the aligned 32-token prefix is shared
    assert t2[2] != t3[2]  # the ragged tail block was copied
    assert eng.cache.allocator.refcount[t2[0]] == 2
    eng.check_block_conservation()


def test_teacher_forced_logprobs_match_decode(tiny):
    """Re-prefilling prompt + generated tokens in one pass (flash) gives the
    logprobs decode reported (paged decode through the pool)."""
    _, _, tcfg, tparams = tiny
    model = tcfg.build()
    eng = PagedGenerator(model, tparams, _greedy(GenerateConfig), max_batch=4,
                         block_size=16, compute_dtype=torch.float32)
    for req, out in zip(_requests(), eng.generate(_requests())):
        ids = req["prompt_ids"] + out["token_ids"]
        logits, _, _ = _forward_cached(model, tparams, torch.tensor([ids]),
                                       torch.arange(len(ids))[None],
                                       init_cache(model, 1, len(ids), torch.float32, "cpu"),
                                       0, torch.float32)
        lps = torch.log_softmax(logits[0], dim=-1)
        p = len(req["prompt_ids"])
        tf = [lps[p - 1 + t, tok].item() for t, tok in enumerate(out["token_ids"])]
        np.testing.assert_allclose(tf, out["logprobs"], atol=LP_TOL)


def _sampled(seed, tiny, **kw):
    _, _, tcfg, tparams = tiny
    cfg = GenerateConfig(max_new_tokens=8, do_sample=True, temperature=0.7, top_p=0.95,
                         max_length=128, prefix_cache=False, **kw)
    eng = PagedGenerator(tcfg.build(), tparams, cfg, max_batch=4, block_size=16,
                         compute_dtype=torch.float32,
                         rng=torch.Generator().manual_seed(seed))
    return [o["token_ids"] for o in eng.generate(_requests())]


def test_sampling_deterministic_under_seed(tiny):
    a, b, c = _sampled(11, tiny), _sampled(11, tiny), _sampled(12, tiny)
    assert a == b
    assert a != c
    assert all(0 <= t < 512 for toks in a for t in toks)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.5), (20, 0.3)])
def test_sample_rows_stays_inside_top_k_top_p(top_k, top_p):
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal(64, dtype=np.float32) * 2)
    logits = base.repeat(512, 1)
    row = {"temperature": np.full(512, 0.7, np.float32), "top_p": np.full(512, top_p, np.float32),
           "top_k": np.full(512, top_k, np.int64)}
    cls = {"do_sample": True, "use_filter": True}
    got = _sample_rows(logits, torch.Generator().manual_seed(1), row, cls).numpy()
    scaled = base.numpy() / 0.7
    order = np.argsort(-scaled)
    allowed = set(order[:top_k].tolist()) if top_k else set(range(64))
    probs = np.exp(scaled[order] - scaled[order].max())
    cum = np.cumsum(probs / probs.sum())
    allowed &= set(order[:int((cum < top_p).sum()) + 1].tolist())
    assert set(got.tolist()) <= allowed
    assert len(set(got.tolist())) > 1 or len(allowed) == 1


def test_sample_rows_greedy_rows():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.0]])
    row = {"temperature": np.array([0.0, 0.0], np.float32), "top_p": np.ones(2, np.float32),
           "top_k": np.zeros(2, np.int64)}
    got = _sample_rows(logits, torch.Generator().manual_seed(0), row,
                       {"do_sample": True, "use_filter": False})
    assert got.tolist() == [1, 0]


@pytest.mark.parametrize("kw", [
    {"prefill_chunk": 64}, {"prefix_cache": True}, {"kv_cache_dtype": "int8"},
    {"mtp_speculative": True}, {"repetition_penalty": 1.1}, {"min_tokens": 2},
    {"logit_bias": {1: 1.0}}, {"top_logprobs": 2}])
def test_unported_options_raise(tiny, kw):
    _, _, tcfg, tparams = tiny
    cfg = GenerateConfig(**{"prefix_cache": False, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedGenerator(tcfg.build(), tparams, cfg)
