"""The port's `Trainer`, `sft` CLI and checkpoints against the JAX package.

The model is the moe_heavy structure at a tiny size: 2 MoE layers, hidden
128, 2 q / 1 kv heads of 128 with qk-norm, 4 experts top-2, a tied vocab
of 300 (the toy tokenizer's), fused CE, remat "save_attn_residuals", f32
compute, on the repo's alpaca demo packed to 256. The JAX `Trainer` runs
on one CPU device with its Pallas CE kernels in interpret mode; the port's
`Trainer` runs the plain versions of its kernels. Both start from the JAX
init (carried across with `params_from_numpy`), see the same batches, and
must log the same tracker curve within 1e-4 relative (they differ only in
summation order).
"""

import importlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from xtuner_tpu.config import optim as joptim
from xtuner_tpu.datasets import config as jdata
from xtuner_tpu.loss.ce_loss import CELossConfig as JCE
from xtuner_tpu.model.moe import MoEConfig as JMoE
from xtuner_tpu.module.attention import MHAConfig as JMHA
from xtuner_tpu.parallel import mesh as jmesh
from xtuner_tpu.train import trainer as jtrainer
from xtuner_tpu.train.cli import sft as jsft
from xtuner_tpu_torch.config import AdamWConfig, CELossConfig, LRConfig, MeshConfig
from xtuner_tpu_torch.datasets import config as tdata
from xtuner_tpu_torch.model.moe import MoEConfig
from xtuner_tpu_torch.module.attention import MHAConfig
from xtuner_tpu_torch.module.params import params_from_numpy, tree_paths
from xtuner_tpu_torch.train import trainer as ttrainer
from xtuner_tpu_torch.train.cli import sft as tsft
from xtuner_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "examples" / "demo_data" / "alpaca_demo.jsonl"
RECIPE = REPO / "xtuner_tpu_torch" / "recipes" / "sft_moe_heavy.py"
CURVE_RTOL = 1e-4
CURVE_KEYS = ("reduced_llm_loss", "grad_norm", "total_loss", "lr", "consumed_tokens",
              "maxvio", "skipped")


def _model_kw():
    return dict(vocab_size=300, num_hidden_layers=2, hidden_size=128, intermediate_size=256,
                moe_intermediate_size=64, n_routed_experts=4, num_experts_per_tok=2,
                tie_word_embeddings=True, rope_theta=1e6, balancing_loss_coef=0.001)


def _tcfg(tmp_path, remat="save_attn_residuals", **kw):
    base = dict(
        model_cfg=MoEConfig(**_model_kw(), attention=MHAConfig(
            num_attention_heads=2, num_key_value_heads=1, head_dim=128, qk_norm=True),
            lm_loss_cfg=CELossConfig(chunk_size=128, mode="fused")),
        dataloader_cfg=tdata.DataloaderConfig(
            datasets=[tdata.DatasetConfig(anno_path=str(DEMO))], pack_max_length=256,
            tokenize_num_proc=1),
        optim_cfg=AdamWConfig(lr=2e-3), lr_cfg=LRConfig(warmup_steps=1),
        mesh_cfg=MeshConfig(param_dtype="float32", remat_policy=remat),
        global_batch_rows=4, micro_batch_rows=2, total_steps=4,
        work_dir=str(tmp_path / "torch"), exp_name="t")
    base.update(kw)
    return ttrainer.TrainerConfig(**base)


def _tracker(trainer):
    return [json.loads(x) for x in (trainer.work_dir / "tracker.jsonl").read_text().splitlines()]


def test_trainer_curve_matches_jax(tmp_path, monkeypatch):
    real_build_mesh = jmesh.build_mesh
    jeng_mod = importlib.import_module("xtuner_tpu.engine.train_engine")
    monkeypatch.setattr(jeng_mod, "build_mesh",
                        lambda cfg, devices=None: real_build_mesh(cfg, jax.devices()[:1]))
    jcfg = jtrainer.TrainerConfig(
        model_cfg=JMoE(**_model_kw(), attention=JMHA(
            num_attention_heads=2, num_key_value_heads=1, head_dim=128, qk_norm=True),
            lm_loss_cfg=JCE(chunk_size=128, mode="fused")),
        dataloader_cfg=jdata.DataloaderConfig(
            datasets=[jdata.DatasetConfig(anno_path=str(DEMO))], pack_max_length=256,
            tokenize_num_proc=1),
        optim_cfg=joptim.AdamWConfig(lr=2e-3), lr_cfg=joptim.LRConfig(warmup_steps=1),
        mesh_cfg=jmesh.MeshConfig(fsdp_size=1, param_dtype="float32",
                                  remat_policy="save_attn_residuals"),
        global_batch_rows=4, micro_batch_rows=2, total_steps=4,
        work_dir=str(tmp_path / "jax"), exp_name="t")
    jt = jtrainer.Trainer(jcfg)
    init = jax.tree.map(np.asarray, jt.engine.params)
    jt.fit()

    tt = ttrainer.Trainer(_tcfg(tmp_path), device="cpu")
    tt.engine.load_params(params_from_numpy(init, tt.cfg.model_cfg, "cpu"))
    tt.fit()
    want = np.array([[r[k] for k in CURVE_KEYS] for r in _tracker(jt)])
    got = np.array([[r[k] for k in CURVE_KEYS] for r in _tracker(tt)])
    assert got.shape == (4, len(CURVE_KEYS))
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL, atol=1e-7)
    assert got[-1, 0] < got[0, 0]  # the loss falls
    assert (tt.work_dir / "checkpoints" / "step-4" / "train_state.json").exists()


def test_remat_policies_give_the_same_gradients():
    """none, full and save_attn_residuals differ only in what the backward
    recomputes: every gradient leaf agrees to f32 rounding."""
    from xtuner_tpu_torch.data_proto import SequenceContext
    from xtuner_tpu_torch.datasets.collator import fake_collator
    from xtuner_tpu_torch.module.params import init_params

    model = _tcfg(Path("."), remat="full").model_cfg.build()
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in fake_collator(2, 64, 300, seed=1).items()}
    grads = {}
    for remat in ("none", "full", "save_attn_residuals"):
        leaves = {p: t.clone().requires_grad_(True) for p, t in tree_paths(params)}
        tree: dict = {}
        for path, t in leaves.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        out = model.loss(tree, SequenceContext(batch["input_ids"], batch["segment_ids"],
                                               batch["position_ids"]),
                         batch["shifted_labels"], batch["loss_weights"],
                         batch["loss_weights"].sum(), compute_dtype=torch.float32, remat=remat)
        out.total_loss().backward()
        grads[remat] = {p: t.grad for p, t in leaves.items()}
    for remat in ("full", "save_attn_residuals"):
        for p, g in grads["none"].items():
            torch.testing.assert_close(grads[remat][p], g, rtol=1e-6, atol=1e-7,
                                       msg=f"{remat} {'.'.join(p)}")


def test_cli_parser_matches_jax():
    """The JAX CLI's flags, and `--device` (default cuda), the port's own."""
    def flags(parser):
        return sorted((a.dest, a.default, tuple(a.choices or ()), getattr(a.type, "__name__", None))
                      for a in parser._actions if a.dest not in ("help", "device"))

    assert flags(tsft.build_parser()) == flags(jsft.build_parser())
    assert tsft.build_parser().parse_args([]).device == "cuda"
    assert tsft.build_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_no_card_and_no_device_raises(tmp_path, monkeypatch):
    """The engine and `Trainer` default to the card; on a machine without
    one they raise, naming it, instead of running on the CPU."""
    from xtuner_tpu_torch.engine.train_engine import TrainEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tcfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TrainEngine(cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TrainEngine(cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg, 2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrainer.Trainer(cfg)
    assert not (tmp_path / "torch").exists()  # raised before it built anything
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsft.main(["--config", str(RECIPE)])


def test_config_file_loads_bench_moe_heavy():
    """The recipe is bench.py's primary `_build_cfg` at its defaults."""
    bench = importlib.import_module("bench")
    want = bench._build_cfg(layers=10, moe_inter=768, experts=16, topk=8)
    args = tsft.build_parser().parse_args(["--config", str(RECIPE)])
    cfg = tsft.config_from_args(args)
    assert isinstance(cfg, ttrainer.TrainerConfig)
    assert Config.fromfile(RECIPE)["trainer"].total_steps == 6
    got = cfg.model_cfg
    for name in ("vocab_size", "num_hidden_layers", "hidden_size", "intermediate_size",
                 "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
                 "tie_word_embeddings", "rope_theta", "balancing_loss_coef",
                 "rms_norm_eps", "max_position_embeddings", "first_k_dense_replace"):
        assert getattr(got, name) == getattr(want, name), name
    assert vars(got.attention) == dict(want.attention)
    assert got.router.router_type == want.router.router_type == "greedy"
    assert (got.lm_loss_cfg.mode, got.lm_loss_cfg.chunk_size) == ("fused", 2048)
    assert cfg.mesh_cfg.remat_policy == "save_attn_residuals"
    assert cfg.mesh_cfg.compute_dtype == torch.bfloat16
    assert (cfg.global_batch_rows, cfg.micro_batch_rows,
            cfg.dataloader_cfg.pack_max_length) == (2, 2, 8192)
    assert (cfg.optim_cfg.lr, cfg.lr_cfg.warmup_steps) == (1e-5, 2)
    assert Path(cfg.dataloader_cfg.datasets[0].anno_path) == DEMO


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """3 steps, a checkpoint, then a resumed run to 5: the same steps 4-5
    (weights, optimizer state and data position restored) as one 5-step
    run. A constant schedule, so that the LR does not depend on
    total_steps."""
    const = LRConfig(lr_type="constant", warmup_steps=1)
    straight = ttrainer.Trainer(_tcfg(tmp_path, total_steps=5, exp_name="straight",
                                      lr_cfg=const), device="cpu")
    straight.fit()
    first = ttrainer.Trainer(_tcfg(tmp_path, total_steps=3, checkpoint_interval=3,
                                   lr_cfg=const), device="cpu")
    first.fit()
    second = ttrainer.Trainer(_tcfg(tmp_path, total_steps=5, resume=True, lr_cfg=const),
                              device="cpu")
    assert second.start_step == 3
    second.fit()
    want = [[r[k] for k in CURVE_KEYS] for r in _tracker(straight)[3:]]
    got = [[r[k] for k in CURVE_KEYS] for r in _tracker(second)[3:]]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6)
    ckpts = second.work_dir / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step-3", "step-5"]  # max_keep 2


def test_selective_resume(tmp_path):
    t1 = ttrainer.Trainer(_tcfg(tmp_path, total_steps=2), device="cpu")
    t1.fit()
    saved = t1.engine.params["embed"]["w"].clone()

    t2 = ttrainer.Trainer(_tcfg(tmp_path, total_steps=4, resume=True,
                                load_optimizer_states=False, load_dataset=False), device="cpu")
    assert t2.start_step == 2
    torch.testing.assert_close(t2.engine.params["embed"]["w"], saved, rtol=0, atol=0)
    state = t2.engine.opt_state
    assert state["count"] == 0 and all(float(m.abs().sum()) == 0 for m in state["m"])
    assert t2.dataloader.get_state_dict()["sampler"]["consumed"] == 0

    t3 = ttrainer.Trainer(_tcfg(tmp_path, total_steps=4, resume=True, load_model=False),
                          device="cpu")
    assert not torch.equal(t3.engine.params["embed"]["w"], saved)  # the fresh init
    assert t3.engine.opt_state["count"] == 2
    assert t3.dataloader.get_state_dict()["sampler"]["consumed"] == 8


def test_resume_takes_a_snapshot_newer_than_the_checkpoint(tmp_path):
    """Snapshots keep their own max_keep; a final save cut short (no commit
    marker) is skipped, and the newer committed snapshot is resumed."""
    t1 = ttrainer.Trainer(_tcfg(tmp_path, total_steps=3, snapshot_interval=2), device="cpu")
    t1.fit()
    snaps = t1.work_dir / "snapshots" / "checkpoints"
    assert sorted(p.name for p in snaps.iterdir()) == ["step-2"]
    (t1.work_dir / "checkpoints" / "step-3" / "train_state.json").unlink()
    t2 = ttrainer.Trainer(_tcfg(tmp_path, total_steps=4, resume=True, snapshot_interval=2),
                          device="cpu")
    assert t2.start_step == 2
    assert t2.engine.opt_state["count"] == 2
    t2.close()


@pytest.mark.parametrize("kw,tag", [
    ({"load_from": "/nonexistent/hf"}, "serve-rest"),
    ({"hf_interval": 2}, "serve-rest"),
    ({"profile_step": 1}, "profiler"),
    ({"track_memory": True}, "profiler"),
    ({"health_check_interval": 1}, "trainer-rest"),
    ({"exp_tracker": "tensorboard"}, "trainer-rest"),
    ({"mesh_cfg": MeshConfig(fsdp_size=2)}, "parallelism"),
    ({"mesh_cfg": MeshConfig(sp_size=2)}, "parallelism"),
    ({"mesh_cfg": MeshConfig(remat_policy="dots")}, None),
])
def test_unported_options_raise(tmp_path, kw, tag):
    cfg = _tcfg(tmp_path, **kw)
    if tag is None:  # the remat policy raises at the first step
        t = ttrainer.Trainer(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match=r"\[train-slice\]"):
            t.fit()
        return
    with pytest.raises(NotImplementedError, match=rf"\[{tag}\]"):
        ttrainer.Trainer(cfg, device="cpu")


def test_cli_muon_raises():
    args = tsft.build_parser().parse_args(["--model", "qwen3-0-6b", "--dataset", str(DEMO),
                                           "--optim", "Muon"])
    with pytest.raises(NotImplementedError, match=r"\[muon\]"):
        tsft.config_from_args(args)
