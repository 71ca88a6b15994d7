"""InternVL's training path in the PyTorch port (`xtuner_tpu_torch`) against
the JAX package, on the CPU, at JAX's own test sizes (`tests/model/
test_vlm.py`, `tests/train/test_vlm_trainer.py`): tiles of 28 x 28 in
patches of 7, a ViT of hidden 16, 2 heads, 2 layers, pixel shuffle 0.5, a
2-layer text model of hidden 32 over the toy tokenizer with InternVL's
three specials.

Every input comes from a numpy seed and reaches both packages as the same
arrays, the weights through `params_from_numpy`. JAX's tower computes its
attention in plain jnp; the port's runs the plain version of
`flash_attention(causal=False)` over the tiles as segments of one row. In
f32 the two differ only in summation order, so 1e-5 (absolute and
relative to each array's largest entry, `TOL`) for the tower, the
projector, the loss and every gradient leaf, and 1e-4 relative for the
3-step `Trainer.fit` curve (`CURVE_RTOL`, as the other trainer tests). The
numpy data plane must agree exactly.

- tiling and frames: `find_closest_aspect_ratio` (ties included),
  `dynamic_preprocess`, `dynamic_num_patch`, `get_frame_indices`;
- `InternVLTokenizeFn` (images, `<image>` in a string, a `.npy` clip, an
  ndarray video, a `max_length` cut after the images) and `vlm_collator`,
  field by field, and its raise above `max_tiles`;
- `vit_forward`, `projector_forward`, `ComposeModel.loss` and every
  gradient leaf against `jax.grad`, the port at remat "none", "full" and
  "save_attn"; a Dense model under "save_attn" against JAX's, with the
  flash forward's calls counted (it re-runs once a layer);
- `param_labels`, the `hf_key_map` (JAX's keys; a round trip through the
  port's export and a load of JAX's own export);
- a 3-step `Trainer.fit` on JAX's `test_vlm_trainer_fit` config;
- the reference faults: JAX's toy tokenizer drops the vision embeds, and
  a `max_length` cut or a pack cut inside a sample's image tokens shifts
  every later image of the micro-batch; the port keeps images on their
  tokens (ROADMAP.md, known faults);
- the recipes: InternVL-8B field for field against JAX's example (its
  depth cut), and Qwen3-VL-8B aligned whole (8.77 B params).
"""

import dataclasses
import functools
import importlib
import json
import runpy
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtuner_tpu.checkpoint import hf as jhf
from xtuner_tpu.checkpoint.spec import HFKey as JHFKey
from xtuner_tpu.config import optim as joptim
from xtuner_tpu.data_proto.sequence_context import SequenceContext as JSeq
from xtuner_tpu.datasets import config as jdata
from xtuner_tpu.datasets import vlm as jvlm
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model import compose as jcompose
from xtuner_tpu.model import dense as jdense
from xtuner_tpu.model import vision as jvision
from xtuner_tpu.module import attention as jattn
from xtuner_tpu.module.params import init_params as j_init_params
from xtuner_tpu.parallel import mesh as jmesh
from xtuner_tpu.train import trainer as jtrainer
from xtuner_tpu.train.toy_tokenizer import UTF8ByteTokenizer as JTok
from xtuner_tpu_torch.checkpoint.hf import load_hf_checkpoint, save_hf_checkpoint
from xtuner_tpu_torch.config import AdamWConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.data_proto import SequenceContext as TSeq
from xtuner_tpu_torch.datasets import config as tdata
from xtuner_tpu_torch.datasets import vlm as tvlm
from xtuner_tpu_torch.engine.train_engine import TrainEngine as TEngine
from xtuner_tpu_torch.loss.ce_loss import CELossConfig as TCE
from xtuner_tpu_torch.model import compose as tcompose
from xtuner_tpu_torch.model import dense as tdense
from xtuner_tpu_torch.model import vision as tvision
from xtuner_tpu_torch.module import attention as tattn
from xtuner_tpu_torch.module.params import count_params, params_from_numpy, tree_paths
from xtuner_tpu_torch.ops.attention import flash as tflash
from xtuner_tpu_torch.train import trainer as ttrainer
from xtuner_tpu_torch.train.toy_tokenizer import UTF8ByteTokenizer as TTok

TOL = 1e-5
CURVE_RTOL = 1e-4
CURVE_KEYS = ("reduced_llm_loss", "grad_norm", "total_loss", "lr", "consumed_tokens",
              "skipped")
SPECIALS = ["<img>", "</img>", "<IMG_CONTEXT>"]
CTX = 261  # the toy tokenizer's <IMG_CONTEXT>
VOCAB = 262
TPT = 4  # tokens per tile: a 4 x 4 grid, pixel shuffle 0.5
VIT = dict(image_size=28, patch_size=7, hidden_size=16, intermediate_size=32,
           num_hidden_layers=2, num_attention_heads=2, downsample_ratio=0.5)
TEXT = dict(vocab_size=VOCAB, num_hidden_layers=2, hidden_size=32, intermediate_size=64)
ATTN = dict(num_attention_heads=4, num_key_value_heads=2, head_dim=8)
REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "xtuner_tpu_torch" / "recipes" / "sft_internvl_8b_vlm.py"
ALIGN_RECIPE = REPO / "xtuner_tpu_torch" / "recipes" / "sft_qwen3_vl_8b_align.py"
ALIGN_PARAMS = 8_767_123_696


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


def _cfgs(**flags):
    """The JAX and the port ComposeConfig at JAX's test size."""
    jcfg = jcompose.ComposeConfig(
        vision_cfg=jvision.ViTConfig(**VIT),
        text_cfg=jdense.DenseConfig(**TEXT, attention=jattn.MHAConfig(**ATTN),
                                    lm_loss_cfg=JCE(chunk_size=64)),
        image_context_token_id=CTX, **flags)
    tcfg = tcompose.ComposeConfig(
        vision_cfg=tvision.ViTConfig(**VIT),
        text_cfg=tdense.DenseConfig(**TEXT, attention=tattn.MHAConfig(**ATTN),
                                    lm_loss_cfg=TCE(chunk_size=64)),
        image_context_token_id=CTX, **flags)
    return jcfg, tcfg


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


def _fn(pkg, **kw):
    if pkg == "jax":
        return jvlm.InternVLTokenizeFn(JTok(SPECIALS), image_size=28, max_num=2,
                                       tokens_per_tile=TPT, **kw)
    return tvlm.InternVLTokenizeFn(TTok(SPECIALS), image_size=28, max_num=2,
                                   tokens_per_tile=TPT, **kw)


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _items(rng, n: int):
    """Chats with one image of 56 x 28, 28 x 28 or 30 x 70 (3, 1 and 3
    tiles: two and a thumbnail, one, two and a thumbnail) before or after
    the text, and a text-only one every fourth."""
    items = []
    for i in range(n):
        text = {"type": "text", "text": f"what is in picture {i}? " * (1 + i % 2)}
        if i % 4 == 3:
            user = {"role": "user", "content": f"no picture here, item {i}"}
        else:
            parts = [{"type": "image", "image": _img(rng, *((56, 28), (28, 28), (30, 70))[i % 3])},
                     text]
            user = {"role": "user", "content": parts if i % 2 == 0 else parts[::-1]}
        items.append({"messages": [user, {"role": "assistant", "content": f"answer {i} " * 3}]})
    return items


def _batch(seed: int, rows: int, per_row: int, l: int = 256, max_tiles: int = 24):
    rng = np.random.default_rng(seed)
    fn = _fn("torch")
    samples = [fn(it) for it in _items(rng, rows * per_row)]
    packs = [samples[r * per_row:(r + 1) * per_row] for r in range(rows)]
    return tvlm.vlm_collator(packs, l, max_tiles=max_tiles, pad_token_id=256)


def _jseq(batch):
    return JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]),
                pixel_values=jnp.asarray(batch["pixel_values"]))


def _tseq(batch):
    return TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]),
                pixel_values=_t(batch["pixel_values"]))


# ---------------------------------------------------------------- tiling
def test_tiling_and_frame_helpers_match_jax():
    """The tile grids (ties: a square image over 0.5 x the grid's area takes
    the later grid), the tiles themselves bit for bit, the tile counts, the
    frame indices ("rand" seeded, "middle", "fps", a short clip) and the
    per-item ints."""
    target = tvlm._target_ratios(1, 12)
    for ar, w, h, size in ((1.0, 448, 448, 448), (1.0, 1000, 1000, 448), (2.0, 896, 448, 448),
                           (0.5, 300, 600, 448), (1.5, 150, 100, 28), (3.7, 370, 100, 28),
                           (1.0, 10, 10, 28)):
        assert tvlm.find_closest_aspect_ratio(ar, target, w, h, size) == \
            jvlm.find_closest_aspect_ratio(ar, target, w, h, size), (ar, w, h)
    # a tie: (1, 1) and (2, 2) both give ratio 1; the area decides
    assert tvlm.find_closest_aspect_ratio(1.0, target, 448, 448, 448) == (1, 1)
    assert tvlm.find_closest_aspect_ratio(1.0, target, 1000, 1000, 448) != (1, 1)
    rng = np.random.default_rng(0)
    for h, w in ((100, 300), (50, 50), (28, 56), (56, 28), (900, 100), (33, 47)):
        img = _img(rng, h, w)
        for max_num in (1, 2, 6, 12):
            got = tvlm.dynamic_preprocess(img, 28, max_num)
            np.testing.assert_array_equal(got, jvlm.dynamic_preprocess(img, 28, max_num))
            n = tvlm.dynamic_num_patch(w, h, 28, max_num)
            assert n == jvlm.dynamic_num_patch(w, h, 28, max_num) == got.shape[0]
    for args in ((4, 100, "middle", None), (6, 60, "rand", 7), (8, 3, "middle", None),
                 (5, 2, "rand", 1), (0, 30, "fps2", None), (3, 30, "fps0.5", None)):
        assert tvlm.get_frame_indices(*args) == jvlm.get_frame_indices(*args), args
    key = {"item": "x", "video": "clip.npy"}
    assert tvlm._stable_int(key, 4, 24) == jvlm._stable_int(key, 4, 24)


# ------------------------------------------------------ tokenize, collate
def test_tokenize_fn_matches_jax(tmp_path):
    """ids, labels, num_tokens and pixel_values equal JAX's: images in list
    content, `<image>` in a string, a `.npy` clip, an ndarray video, and a
    `max_length` cut after the last context token (kept, as JAX keeps it)."""
    rng = np.random.default_rng(1)
    clip = tmp_path / "clip.npy"
    np.save(clip, rng.integers(0, 256, (9, 40, 30, 3), dtype=np.uint8))
    video = rng.integers(0, 256, (5, 28, 28, 3), dtype=np.uint8)
    items = _items(rng, 6) + [
        {"messages": [{"role": "user", "content": "<image>\nlook"},
                      {"role": "assistant", "content": "ok"}], "image": _img(rng, 30, 70)},
        {"id": "v1", "messages": [{"role": "user", "content": [
            {"type": "video", "video": str(clip)}, {"type": "text", "text": "and?"}]},
            {"role": "assistant", "content": "frames"}]},
        {"messages": [{"role": "user", "content": "<video> what"},
                      {"role": "assistant", "content": "moves"}], "video": video},
    ]
    for kw in ({}, {"min_num_frames": 2, "max_num_frames": 4}):
        jfn, tfn = _fn("jax", **kw), _fn("torch", **kw)
        for it in items:
            got, want = tfn(it), jfn(it)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    # a cut after the images keeps the sample, as JAX does
    it = items[0]
    full = _fn("torch")(it)
    last_ctx = max(i for i, t in enumerate(full["input_ids"]) if t == CTX)
    cut = last_ctx + 3
    got, want = _fn("torch", max_length=cut)(it), _fn("jax", max_length=cut)(it)
    assert got["num_tokens"] == want["num_tokens"] == cut
    for k in ("input_ids", "labels", "pixel_values"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert _fn("torch").hash() != _fn("torch", max_length=cut).hash()


def test_collator_matches_jax_and_refuses_above_max_tiles():
    """Every field of `vlm_collator` equals JAX's on packs of whole
    samples (tiles padded with zeros to max_tiles); both raise on more
    tiles than max_tiles."""
    rng = np.random.default_rng(2)
    samples = [_fn("torch")(it) for it in _items(rng, 7)]
    packs = [samples[:3], samples[3:5], samples[5:]]
    got = tvlm.vlm_collator(packs, 512, max_tiles=16, pad_token_id=256)
    want = jvlm.vlm_collator(packs, 512, max_tiles=16, pad_token_id=256)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_tiles = sum(len(s.get("pixel_values", ())) for s in samples)
    assert got["pixel_values"].shape == (16, 3, 28, 28) and n_tiles < 16
    assert not got["pixel_values"][n_tiles:].any()
    assert int((got["input_ids"] == CTX).sum()) == n_tiles * TPT
    for collate in (tvlm.vlm_collator, jvlm.vlm_collator):
        with pytest.raises(ValueError, match="max_tiles"):
            collate(packs, 512, max_tiles=n_tiles - 1)


def test_dataloader_builds_internvl_batches(tmp_path):
    """`DataloaderConfig.build` with an "internvl" dataset and `max_tiles`:
    soft packs of whole samples, every key with a leading A, the tiles of
    each micro-batch on its context tokens."""
    path = _write_demo(tmp_path, 12, seed=3)
    cfg = tdata.DataloaderConfig(
        datasets=[tdata.DatasetConfig(anno_path=str(path), class_name="internvl")],
        pack_max_length=256, tokenize_num_proc=1, max_tiles=16, tokens_per_tile=TPT,
        image_size=28, image_max_num=2)
    loader = cfg.build(TTok(SPECIALS), global_batch_rows=4, micro_batch_rows=2)
    batch = next(iter(loader))
    assert batch["input_ids"].shape == (2, 2, 256)
    assert batch["pixel_values"].shape == (2, 16, 3, 28, 28)
    for a in range(2):
        real = int(np.abs(batch["pixel_values"][a]).sum(axis=(1, 2, 3)).astype(bool).sum())
        assert int((batch["input_ids"][a] == CTX).sum()) == real * TPT > 0
    loader.close()


def _write_demo(root: Path, n: int, seed: int) -> Path:
    """JAX's `test_vlm_trainer_fit` data: n chats, each with a .npy image
    of 56 x 28."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        img = root / f"{i}.npy"
        np.save(img, rng.integers(0, 255, (56, 28, 3)).astype(np.uint8))
        lines.append(json.dumps({"messages": [
            {"role": "user", "content": [{"type": "image", "image": str(img)},
                                         {"type": "text", "text": f"describe image {i}"}]},
            {"role": "assistant", "content": f"image number {i} shows noise"}]}))
    path = root / "vlm.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return path


# ------------------------------------------------------------ the model
def test_vit_and_projector_match_jax():
    """`vit_forward` (patchify, cls, blocks, pixel shuffle) and
    `projector_forward` against JAX's on the tiles of two packed rows (the
    zero padding tiles included), f32."""
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg, seed=3)
    batch = _batch(4, rows=2, per_row=3)
    pix = batch["pixel_values"]
    jv = jax.jit(lambda p, x: jvision.vit_forward(p, jcfg.vision_cfg, x, jnp.float32))(
        jax.tree.map(jnp.asarray, tree["vision"]), jnp.asarray(pix))
    jp = jax.jit(lambda p, x: jvision.projector_forward(p, jcfg.projector_cfg, x, jnp.float32))(
        jax.tree.map(jnp.asarray, tree["projector"]), jv)
    tparams = params_from_numpy(tree, tcfg, "cpu")
    with torch.no_grad():
        tv = tvision.vit_forward(tparams["vision"], tcfg.vision_cfg, _t(pix), torch.float32)
        tp = tvision.projector_forward(tparams["projector"], tcfg.projector_cfg, tv,
                                       torch.float32)
    assert tv.shape == (pix.shape[0], TPT, 64) and tp.shape == (pix.shape[0], TPT, 32)
    _close(tv.numpy(), jv, "vit")
    _close(tp.numpy(), jp, "projector")
    # the pixel shuffle alone, on distinct values: JAX's exact order
    x = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    s = x.reshape(2, 4, 4, 3).reshape(2, 4, 2, 6).transpose(0, 2, 1, 3).reshape(
        2, 2, 2, 12).transpose(0, 2, 1, 3).reshape(2, 4, 12)
    np.testing.assert_array_equal(tvision.pixel_shuffle(_t(x), 4, 0.5).numpy(), s)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX's `ComposeModel.loss` in f32 on two packed rows: (tree, batch,
    loss, gradient leaves by path)."""
    jcfg, _ = _cfgs()
    tree = _tree(jcfg, seed=5)
    batch = _batch(6, rows=2, per_row=3)
    jmodel = jcfg.build()
    denom = float(batch["loss_weights"].sum())
    jseq = _jseq(batch)

    def j_fn(p):
        return jmodel.loss(p, jseq, jnp.asarray(batch["shifted_labels"]),
                           jnp.asarray(batch["loss_weights"]), denom,
                           compute_dtype=jnp.float32, remat="save_attn").loss

    jl, jgrads = jax.jit(jax.value_and_grad(j_fn))(jax.tree.map(jnp.asarray, tree))
    return tree, batch, float(jl), dict(tree_paths(jax.tree.map(np.asarray, jgrads)))


def _leaves_tree(params):
    leaves = dict(tree_paths(params))
    for v in leaves.values():
        v.requires_grad_(True)
    return leaves


@pytest.mark.parametrize("remat", ["none", "full", "save_attn"])
def test_compose_loss_and_every_grad_leaf_match_jax(remat):
    """The loss and every gradient leaf (the tower's blocks, patch and
    position embeddings, cls token, the projector, the text layers and the
    untied embedding and head) against `jax.grad` of JAX's loss."""
    tree, batch, jl, jgrads = _jax_loss_and_grads()
    _, tcfg = _cfgs()
    tparams = params_from_numpy(tree, tcfg, "cpu")
    leaves = _leaves_tree(tparams)
    out = tcfg.build().loss(tparams, _tseq(batch), _t(batch["shifted_labels"]),
                            _t(batch["loss_weights"]), float(batch["loss_weights"].sum()),
                            compute_dtype=torch.float32, remat=remat)
    out.loss.backward()
    _close(out.loss.item(), jl, "loss")
    assert sorted(jgrads) == sorted(leaves)
    for path, v in leaves.items():
        _close(v.grad.numpy(), jgrads[path], ".".join(path))
    for path in (("vision", "cls_token"), ("vision", "blocks", "attn", "qkv", "w"),
                 ("vision", "patch_embed", "w"), ("projector", "fc1", "w")):
        assert np.abs(leaves[path].grad.numpy()).max() > 0, path


def test_dense_under_save_attn_matches_jax(monkeypatch):
    """A Dense model's loss and every gradient leaf under remat "save_attn"
    against JAX's under its "save_attn"; the flash forward runs twice a
    layer (the forward, then the backward's re-run for lse), where
    "save_out_lse" runs it once."""
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg, seed=8)["language"]
    batch = _batch(9, rows=2, per_row=2)
    denom = float(batch["loss_weights"].sum())
    jmodel = jcfg.text_cfg.build()
    jseq = JSeq(input_ids=jnp.asarray(batch["input_ids"]),
                segment_ids=jnp.asarray(batch["segment_ids"]),
                position_ids=jnp.asarray(batch["position_ids"]))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(
        p, jseq, jnp.asarray(batch["shifted_labels"]), jnp.asarray(batch["loss_weights"]),
        denom, compute_dtype=jnp.float32, remat="save_attn").loss))(
            jax.tree.map(jnp.asarray, tree))
    jgrads = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    calls = []
    real = tflash.flash_forward
    monkeypatch.setattr(tflash, "flash_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    seq = TSeq(_t(batch["input_ids"]), _t(batch["segment_ids"]), _t(batch["position_ids"]))
    for remat, want_calls in (("save_attn", 4), ("save_out_lse", 2)):
        calls.clear()
        tparams = params_from_numpy(tree, tcfg.text_cfg, "cpu")
        leaves = _leaves_tree(tparams)
        out = tcfg.text_cfg.build().loss(tparams, seq, _t(batch["shifted_labels"]),
                                         _t(batch["loss_weights"]), denom,
                                         compute_dtype=torch.float32, remat=remat)
        out.loss.backward()
        assert len(calls) == want_calls, remat
        _close(out.loss.item(), float(jl), remat)
        for path, v in leaves.items():
            _close(v.grad.numpy(), jgrads[path], ".".join(path))


def test_freeze_labels_and_a_frozen_tower_records_nothing():
    """`param_labels` by part, JAX's; a frozen tower (views that need no
    gradient) builds no autograd graph: its output needs no gradient."""
    for flags in ({"freeze_vision": True}, {"freeze_language": True, "freeze_projector": True}):
        jcfg, tcfg = _cfgs(**flags)
        jl = jcfg.build().param_labels(jcfg.build().param_specs())
        tl = tcfg.build().param_labels(tcfg.build().param_specs())
        assert dict(tree_paths(tl)) == dict(tree_paths(jax.tree.map(lambda x: x, jl)))
    _, tcfg = _cfgs(freeze_vision=True)
    tree = params_from_numpy(_tree(_cfgs()[0], seed=1), tcfg, "cpu")
    pix = _t(_batch(1, rows=1, per_row=2)["pixel_values"])
    assert not tvision.vit_forward(tree["vision"], tcfg.vision_cfg, pix,
                                   torch.float32).requires_grad


def test_hf_key_map_matches_jax_and_round_trips(tmp_path):
    """The compose key map equals JAX's key for key (template, transform,
    layer offset); the port's export loads back bit for bit, and JAX's own
    export of the same weights loads into the port, also through
    `TrainEngine.from_hf` and out again through `save_hf`; without the cls
    token there is no `vision_tower.cls_token`."""
    jcfg, tcfg = _cfgs()

    def flat(tree, j=False):
        if j:
            pairs = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JHFKey))[0]
            return {tuple(p.key for p in path): (k.template, k.transform, k.layer_offset)
                    for path, k in pairs}
        return {p: (k.template, k.transform, k.layer_offset) for p, k in tree_paths(tree)}

    tmodel = tcfg.build()
    assert flat(tmodel.hf_key_map()) == flat(jcfg.build().hf_key_map(), j=True)
    tree = _tree(jcfg, seed=2)
    params = params_from_numpy(tree, tcfg, "cpu")
    save_hf_checkpoint(tmp_path / "port", params, tmodel.hf_key_map())
    jhf.save_hf_checkpoint(tmp_path / "jax", jax.tree.map(jnp.asarray, tree),
                           jcfg.build().hf_key_map())
    for d in ("port", "jax"):
        back = load_hf_checkpoint(tmp_path / d, tmodel.param_specs(), tmodel.hf_key_map(), "cpu")
        for path, v in tree_paths(back):
            np.testing.assert_array_equal(v.numpy(), dict(tree_paths(tree))[path],
                                          err_msg=f"{d} {'.'.join(path)}")
    tnc = dataclasses.replace(tcfg, vision_cfg=dataclasses.replace(tcfg.vision_cfg,
                                                                   use_cls_token=False))
    keys = flat(tnc.build().hf_key_map())
    assert ("vision", "cls_token") not in keys
    assert "cls_token" not in tnc.build().param_specs()["vision"]
    jnc = jcfg.model_copy(update={"vision_cfg": jcfg.vision_cfg.model_copy(
        update={"use_cls_token": False})})
    assert keys == flat(jnc.build().hf_key_map(), j=True)
    # the engine loads and exports a compose model through the same maps
    eng = TEngine(tcfg, AdamWConfig(), LRConfig(), MeshConfig(param_dtype="float32"), 1,
                  device="cpu")
    eng.from_hf(str(tmp_path / "jax"))
    eng.save_hf(str(tmp_path / "engine"))
    back = load_hf_checkpoint(tmp_path / "engine", tmodel.param_specs(), tmodel.hf_key_map(),
                              "cpu")
    for path, v in tree_paths(back):
        np.testing.assert_array_equal(v.numpy(), dict(tree_paths(tree))[path])


# ---------------------------------------------------------- the trainer
def _trainer_cfgs(tmp_path, data: Path):
    kw = dict(global_batch_rows=8, micro_batch_rows=8, total_steps=3)
    jcfg, tcfg = _cfgs(freeze_vision=True)
    jtc = jtrainer.TrainerConfig(
        model_cfg=jcfg.model_copy(update={"text_cfg": jcfg.text_cfg.model_copy(
            update={"lm_loss_cfg": JCE(chunk_size=128)})}),
        dataloader_cfg=jdata.DataloaderConfig(
            datasets=[jdata.DatasetConfig(anno_path=str(data), class_name="internvl")],
            pack_max_length=256, max_tiles=48, tokens_per_tile=TPT, image_size=28,
            image_max_num=2, tokenize_num_proc=1),
        optim_cfg=joptim.AdamWConfig(lr=1e-3), lr_cfg=joptim.LRConfig(warmup_steps=1),
        mesh_cfg=jmesh.MeshConfig(fsdp_size=1, param_dtype="float32"),
        work_dir=str(tmp_path / "jax"), exp_name="vlm", **kw)
    ttc = ttrainer.TrainerConfig(
        model_cfg=dataclasses.replace(tcfg, text_cfg=dataclasses.replace(
            tcfg.text_cfg, lm_loss_cfg=TCE(chunk_size=128))),
        dataloader_cfg=tdata.DataloaderConfig(
            datasets=[tdata.DatasetConfig(anno_path=str(data), class_name="internvl")],
            pack_max_length=256, max_tiles=48, tokens_per_tile=TPT, image_size=28,
            image_max_num=2, tokenize_num_proc=1),
        optim_cfg=AdamWConfig(lr=1e-3), lr_cfg=LRConfig(warmup_steps=1),
        mesh_cfg=MeshConfig(param_dtype="float32"),
        work_dir=str(tmp_path / "torch"), exp_name="vlm", **kw)
    return jtc, ttc


def _tracker(trainer):
    return [json.loads(x) for x in (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]


def test_trainer_fit_matches_jax(tmp_path, monkeypatch):
    """JAX's `test_vlm_trainer_fit` (16 chats with a 56 x 28 image, packs
    of 256, 8 rows a step, max_tiles 48, the tower frozen) for 3 steps on
    both, JAX's Trainer given the specials its own test gives it: the same
    tracker curve; the frozen tower's leaves bit-unchanged, the projector
    moved."""
    data = _write_demo(tmp_path / "data", 16, seed=0)
    real_build_mesh = jmesh.build_mesh
    jeng_mod = importlib.import_module("xtuner_tpu.engine.train_engine")
    monkeypatch.setattr(jeng_mod, "build_mesh",
                        lambda cfg, devices=None: real_build_mesh(cfg, jax.devices()[:1]))
    monkeypatch.setattr(jtrainer.Trainer, "_build_tokenizer", lambda self: JTok(SPECIALS))
    jtc, ttc = _trainer_cfgs(tmp_path, data)
    jt = jtrainer.Trainer(jtc)
    init = jax.tree.map(np.asarray, jt.engine.params)
    jt.fit()
    tt = ttrainer.Trainer(ttc, device="cpu")
    assert tt.tokenizer.special_ids["<IMG_CONTEXT>"] == CTX
    tt.engine.load_params(params_from_numpy(init, ttc.model_cfg, "cpu"))
    tt.fit()
    want = np.array([[r[k] for k in CURVE_KEYS] for r in _tracker(jt)])
    got = np.array([[r[k] for k in CURVE_KEYS] for r in _tracker(tt)])
    assert got.shape == (3, len(CURVE_KEYS))
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL, atol=1e-7)
    final = dict(tree_paths(tt.engine.params))
    for path, a in tree_paths(init):
        same = np.array_equal(final[path].numpy(), a)
        assert same == (path[0] == "vision"), path


def test_trainer_refuses_a_context_id_the_tokenizer_lacks(tmp_path):
    data = _write_demo(tmp_path / "data", 4, seed=1)
    _, ttc = _trainer_cfgs(tmp_path, data)
    ttc.model_cfg = dataclasses.replace(ttc.model_cfg, image_context_token_id=151667)
    with pytest.raises(ValueError, match="image_context_token_id 151667"):
        ttrainer.Trainer(ttc, device="cpu")


# ----------------------------------------------------- reference faults
def test_jax_toy_tokenizer_drops_the_vision_embeds_and_the_port_does_not(tmp_path):
    """JAX's `Trainer._build_tokenizer` (no tokenizer_path) gives the toy
    tokenizer no specials: InternVLTokenizeFn writes <IMG_CONTEXT> as bytes,
    no id equals image_context_token_id, and JAX's forward is the same with
    the pixels and without. The port's Trainer builds the specials, so the
    sample's context tokens are the config's id."""
    jtok = jtrainer.Trainer._build_tokenizer(types.SimpleNamespace(
        cfg=types.SimpleNamespace(tokenizer_path=None)))
    rng = np.random.default_rng(4)
    item = _items(rng, 1)[0]
    jsample = jvlm.InternVLTokenizeFn(jtok, image_size=28, max_num=2, tokens_per_tile=TPT)(item)
    assert CTX not in jsample["input_ids"] and jsample["pixel_values"].shape[0] == 3
    batch = jvlm.vlm_collator([[jsample]], 512, max_tiles=4)
    jcfg, _ = _cfgs()
    jmodel = jcfg.build()
    params = jax.tree.map(jnp.asarray, _tree(jcfg, seed=6))
    with_pix = jmodel.forward(params, _jseq(batch), compute_dtype=jnp.float32)
    without = jmodel.forward(params, _jseq(batch).replace(pixel_values=None),
                             compute_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(with_pix), np.asarray(without))
    data = _write_demo(tmp_path / "data", 4, seed=2)
    _, ttc = _trainer_cfgs(tmp_path, data)
    tok = ttrainer.Trainer(ttc, device="cpu").tokenizer
    tsample = tvlm.InternVLTokenizeFn(tok, image_size=28, max_num=2, tokens_per_tile=TPT)(item)
    assert tsample["input_ids"].count(CTX) == 3 * TPT


def test_a_cut_inside_image_tokens_shifts_later_images_in_jax_not_in_the_port():
    """Sample A (two images) cut by max_length inside its first image's
    context tokens, then sample B (one image) in the same micro-batch. JAX
    keeps all of A's tiles but few of its context tokens, so B's first
    context token takes A's vision token (`_fuse_vision`'s k-th to k-th).
    The port drops A whole: B's tokens take B's own tile. A pack row that
    cuts a sample with tiles: JAX keeps the cut sample's tiles; the port
    drops that sample, tokens and tiles."""
    rng = np.random.default_rng(5)
    img = {"type": "image", "image": _img(rng, 56, 28)}  # 3 tiles, 12 context tokens
    a = {"messages": [{"role": "user", "content": [img, {"type": "text", "text": "a"}, img]},
                      {"role": "assistant", "content": "two"}]}
    b = {"messages": [{"role": "user", "content": [{"type": "image",
                                                     "image": _img(rng, 28, 28)}]},
                      {"role": "assistant", "content": "one"}]}
    first_ctx = _fn("torch")(a)["input_ids"].index(CTX)
    cut = first_ctx + 3  # 3 of image 1's 12 context tokens kept
    ja, jb = _fn("jax", max_length=cut)(a), _fn("jax")(b)
    assert ja["pixel_values"].shape[0] == 6 and ja["input_ids"].count(CTX) == 3
    jbatch = jvlm.vlm_collator([[ja, jb]], 256, max_tiles=8)
    ids = jbatch["input_ids"][0]
    b_first = int(np.flatnonzero(ids == CTX)[3])  # B's first context token
    k = int(np.cumsum(ids == CTX)[b_first]) - 1
    assert k == 3 and k // TPT == 0  # JAX: B reads tile 0 (A's), not tile 6 (B's)
    ta = _fn("torch", max_length=cut)(a)
    assert ta["num_tokens"] == 0 and "pixel_values" not in ta and ta["input_ids"] == []
    tb = _fn("torch")(b)
    tbatch = tvlm.vlm_collator([[tb]], 256, max_tiles=8)
    assert int(np.cumsum(tbatch["input_ids"][0] == CTX)[
        int(np.flatnonzero(tbatch["input_ids"][0] == CTX)[0])]) - 1 == 0
    np.testing.assert_array_equal(tbatch["pixel_values"][0], tb["pixel_values"][0])
    # the pack row cuts A (2 x 3 tiles) after B, inside A's first image
    fa, fb = _fn("torch")(a), _fn("torch")(b)
    row = len(fb["input_ids"]) + cut
    jcut = jvlm.vlm_collator([[fb, fa]], row, max_tiles=8)
    tcut = tvlm.vlm_collator([[fb, fa]], row, max_tiles=8)
    n_real = lambda pv: int(np.abs(pv).sum(axis=(1, 2, 3)).astype(bool).sum())
    assert n_real(jcut["pixel_values"]) == 7 > int((jcut["input_ids"] == CTX).sum()) // TPT
    assert n_real(tcut["pixel_values"]) == 1 == int((tcut["input_ids"] == CTX).sum()) // TPT


# ----------------------------------------------------------- the recipes
def _recipe(path: Path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return runpy.run_path(str(path))


def test_internvl_recipe_is_jax_example(tmp_path, monkeypatch):
    """`recipes/sft_internvl_8b_vlm.py` against `examples/v1/
    sft_internvl_8b_vlm.py` field for field, but for what its docstring
    lists: the toy tokenizer's context id, the demo set, the port's own
    export to load, no tokenizer_path, and the language model cut in depth
    (every width kept)."""
    ns = _recipe(RECIPE, tmp_path, monkeypatch)
    jns = runpy.run_path(str(REPO / "examples" / "v1" / "sft_internvl_8b_vlm.py"))
    t, j = ns["trainer"], jns["trainer"]
    tm, jm = t.model_cfg, j.model_cfg
    assert dataclasses.asdict(tm.vision_cfg) == jm.vision_cfg.model_dump()
    assert (tm.freeze_vision, tm.freeze_language, tm.freeze_projector) == (True, False, False)
    assert tm.image_context_token_id == TTok(SPECIALS).special_ids["<IMG_CONTEXT>"]
    text, jtext = tm.text_cfg, jm.text_cfg
    for f in ("vocab_size", "hidden_size", "intermediate_size", "rope_theta",
              "tie_word_embeddings", "max_position_embeddings", "rms_norm_eps"):
        assert getattr(text, f) == getattr(jtext, f), f
    assert dataclasses.asdict(text.attention) == {
        k: v for k, v in jtext.attention.model_dump().items()
        if k in dataclasses.asdict(text.attention)}
    assert text.num_hidden_layers == ns["LAYERS"] < jtext.num_hidden_layers
    assert text.lm_loss_cfg.mode == jtext.lm_loss_cfg.mode == "chunk"
    dl, jdl = t.dataloader_cfg, j.dataloader_cfg
    for f in ("pack_max_length", "max_tiles", "tokens_per_tile", "image_size", "image_max_num"):
        assert getattr(dl, f) == getattr(jdl, f), f
    assert dl.datasets[0].class_name == "internvl"
    assert (t.optim_cfg.lr, t.lr_cfg.warmup_ratio) == (j.optim_cfg.lr, j.lr_cfg.warmup_ratio)
    assert t.mesh_cfg.remat_policy == j.mesh_cfg.remat_policy == "save_attn"
    assert t.global_batch_rows == j.global_batch_rows == 8
    assert t.tokenizer_path is None and t.load_from == str(ns["EXPORT"])
    assert count_params(tm.build().param_specs()) == ns["PARAMS"]


def test_qwen3_vl_8b_align_recipe(tmp_path, monkeypatch):
    """`recipes/sft_qwen3_vl_8b_align.py`: the registry's qwen3-vl-8b whole
    (8,767,123,696 params), the language model frozen, the 4B recipe's
    demo set and geometry, remat "full", 4 steps."""
    ns = _recipe(ALIGN_RECIPE, tmp_path, monkeypatch)
    t = ns["trainer"]
    m = t.model_cfg
    assert count_params(m.build().param_specs()) == ALIGN_PARAMS
    assert (m.freeze_vision, m.freeze_projector, m.freeze_language) == (False, False, True)
    assert m.vision_cfg.head_dim == 72 and m.vision_cfg.depth == 27
    assert t.mesh_cfg.remat_policy == "full" and t.total_steps == 4
    dl = t.dataloader_cfg
    assert (dl.pack_max_length, dl.max_patches, dl.vision_patch_size) == (8192, 32768, 16)
    assert dl.datasets[0].class_name == "qwen3_vl"
