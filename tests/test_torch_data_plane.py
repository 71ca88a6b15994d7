"""The port's text data plane against the JAX package's: chat templates,
the toy tokenizer, the tokenize functions, jsonl datasets, soft and hard
packing, the samplers and `DataloaderConfig.build` on the repo's alpaca
demo. Both are numpy code over the same file and seed, so every batch must
be the same, array for array (exact equality), over two epochs; and a
sampler state taken mid-epoch resumes to the same next batch.
"""

from pathlib import Path

import numpy as np
import pytest

from xtuner_tpu.data_proto import templates as jtpl
from xtuner_tpu.datasets.config import DataloaderConfig as JDL
from xtuner_tpu.datasets.config import DatasetConfig as JDS
from xtuner_tpu.datasets.tokenize_fns import OpenaiSFTTokenizeFn as JSFT
from xtuner_tpu.datasets.tokenize_fns import PretrainTokenizeFn as JPT
from xtuner_tpu.train.toy_tokenizer import UTF8ByteTokenizer as JTok
from xtuner_tpu_torch.data_proto import templates as ttpl
from xtuner_tpu_torch.datasets.config import DataloaderConfig as TDL
from xtuner_tpu_torch.datasets.config import DatasetConfig as TDS
from xtuner_tpu_torch.datasets.jsonl import JsonlDataset
from xtuner_tpu_torch.datasets.tokenize_fns import OpenaiSFTTokenizeFn as TSFT
from xtuner_tpu_torch.datasets.tokenize_fns import PretrainTokenizeFn as TPT
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer as TTok

DEMO = Path(__file__).resolve().parents[1] / "examples" / "demo_data" / "alpaca_demo.jsonl"


def _build(pkg, pack_len, level, rows=2, micro=1, **kw):
    dl, ds, tok = (JDL, JDS, JTok) if pkg == "jax" else (TDL, TDS, TTok)
    cfg = dl(datasets=[ds(anno_path=str(DEMO))], pack_max_length=pack_len, pack_level=level,
             tokenize_num_proc=1, pad_token_id=256, **kw)
    return cfg.build(tok(), rows, micro)


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("pack_len,level", [(256, "soft"), (8192, "soft"), (256, "hard"),
                                            (8192, "hard")])
def test_dataloader_batches_match_jax_over_two_epochs(pack_len, level):
    j, t = _build("jax", pack_len, level), _build("torch", pack_len, level)
    assert len(j) == len(t)
    ji, ti = iter(j), iter(t)
    for _ in range(2 * len(j)):
        _same(next(ji), next(ti))
    assert j.get_state_dict() == t.get_state_dict()


@pytest.mark.parametrize("kw", [{"length_grouped": True}, {"pack_balance": "flops"},
                                {"shuffle": False, "seed": 3}])
def test_dataloader_options_match_jax(kw):
    j, t = _build("jax", 512, "soft", rows=4, micro=2, **kw), \
        _build("torch", 512, "soft", rows=4, micro=2, **kw)
    ji, ti = iter(j), iter(t)
    for _ in range(len(j) + 2):
        _same(next(ji), next(ti))


@pytest.mark.parametrize("workers", [0, 1])
def test_sampler_state_resumes_mid_epoch(workers):
    """Take a state after 3 steps (mid-epoch), restore it in a fresh
    loader: the next batch is the 4th, and is JAX's 4th. With a prefetch
    thread the state still counts only the batches handed out."""
    ref = iter(_build("jax", 256, "soft"))
    want = [next(ref) for _ in range(5)]
    first = _build("torch", 256, "soft", num_workers=workers)
    it = iter(first)
    for i in range(3):
        _same(next(it), want[i])
    state = first.get_state_dict()
    first.close()
    assert state["sampler"]["consumed"] == 6 and state["sampler"]["epoch"] == 0
    second = _build("torch", 256, "soft")
    second.load_state_dict(state)
    it2 = iter(second)
    _same(next(it2), want[3])
    _same(next(it2), want[4])


@pytest.mark.parametrize("name", ["qwen", "qwen3", "llama3", "gpt-oss", "glm"])
def test_chat_templates_tokenize_as_jax(name):
    tools = [{"name": "lookup", "parameters": {"type": "object"}}]
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "ok", "thinking": "hmm",
             "tool_calls": [{"function": {"name": "lookup", "arguments": "{\"q\": 1}"}}]},
            {"role": "tool", "content": "42"},
            {"role": "assistant", "content": "done"}]
    use_tools = jtpl.get_chat_template(name).tool_prompt is not None
    if name == "glm":  # its tool framing is a fault of the JAX template (below)
        msgs = [m for m in msgs if m["role"] != "tool"]
    want = jtpl.ChatMessages(messages=msgs, tools=tools if use_tools else None).tokenize(
        JTok(), jtpl.get_chat_template(name))
    got = ttpl.ChatMessages(messages=msgs, tools=tools if use_tools else None).tokenize(
        TTok(), ttpl.get_chat_template(name))
    assert got == want


def test_tokenize_fns_and_jsonl_cache_match_jax(tmp_path):
    item = {"messages": [{"role": "user", "content": "héllo"},
                         {"role": "assistant", "content": "wörld " * 40}]}
    assert TSFT(TTok(), "qwen", max_length=50)(item) == JSFT(JTok(), "qwen", max_length=50)(item)
    text = {"text": "plain pretrain text"}
    assert TPT(TTok())(text) == JPT(JTok())(text)
    assert TTok().encode("a<x>b", add_special_tokens=True) == \
        JTok().encode("a<x>b", add_special_tokens=True)
    ds = JsonlDataset(DEMO, TSFT(TTok()), cache_dir=tmp_path, sample_ratio=0.5,
                      num_proc=2)  # two spawned counting processes
    counts = ds.num_tokens
    assert len(ds) == 64 and len(list(tmp_path.glob("*.npy"))) == 1
    again = JsonlDataset(DEMO, TSFT(TTok()), cache_dir=tmp_path)
    np.testing.assert_array_equal(again.num_tokens, counts)  # read from the cache
    assert again[5]["num_tokens"] == counts[5]
    ds.close()
    again.close()


def test_glm_tool_framing_fault_is_repaired():
    """ROADMAP Queue 3: the JAX "glm" template frames a tool result with the
    positional "<|observation|>{}", which `.format(tool_extractor=...)`
    rejects; the port names the field."""
    msgs = [{"role": "user", "content": "q"}, {"role": "tool", "content": "42"}]
    with pytest.raises(IndexError):
        jtpl.ChatMessages(messages=msgs).tokenize(JTok(), jtpl.get_chat_template("glm"))
    out = ttpl.ChatMessages(messages=msgs).tokenize(TTok(), ttpl.get_chat_template("glm"))
    assert TTok().decode(out["input_ids"]).endswith("<|observation|>42")
    assert out["labels"] == [-100] * out["num_tokens"]


def test_prefetch_resume_fault_is_repaired():
    """ROADMAP Queue 3: with `num_workers` > 0 the JAX loader's state counts
    the batches its thread prefetched but never handed out, so a resume
    skips them; the port's state counts only the batches taken."""
    import time

    j = _build("jax", 256, "soft", num_workers=1)
    t = _build("torch", 256, "soft", num_workers=1)
    ji, ti = iter(j), iter(t)
    for _ in range(3):
        _same(next(ji), next(ti))
    deadline = time.monotonic() + 10
    while not (j._queue.full() and t._queue.full()) and time.monotonic() < deadline:
        time.sleep(0.01)  # both threads have prefetched their next batches
    assert j._queue.full() and t._queue.full()
    # JAX: the 2 queued batches (4 rows) and part or all of the one its
    # thread is building count as consumed
    assert j.get_state_dict()["sampler"]["consumed"] >= 6 + 2 * 2
    assert t.get_state_dict()["sampler"]["consumed"] == 6
    t.close()
