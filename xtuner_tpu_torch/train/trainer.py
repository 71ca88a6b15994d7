"""Trainer: the SFT / pretrain training loop (counterpart:
`xtuner_tpu/train/trainer.py`).

`TrainerConfig` keeps the JAX fields and defaults (a dataclass);
`Trainer` owns the work dir and its meta, the tokenizer, the data plane
(`DataloaderConfig.build`: text, and Qwen3-VL's), the `TrainEngine`, the jsonl tracker and
checkpoint save / resume, and `fit` logs the same step line and writes the
same tracker keys as the JAX `fit`; a DSA model's indexer loss
(`dsa_index_loss`) joins both, beside `reduced_llm_loss`. Without a
`tokenizer_path` the tokenizer is the UTF-8 byte toy, with the three
vision specials when a dataset is "qwen3_vl" and InternVL's `<img>`,
`</img>` and `<IMG_CONTEXT>` when one is "internvl" (JAX's has none: its
Qwen3-VL tokenize function then fails on every sample, and its InternVL
one writes the context as bytes that no model id matches, so the vision
embeds are dropped silently: ROADMAP.md, known faults in the reference).
A model with an `image_context_token_id` (`model/compose.py`) trained on
an "internvl" dataset must name the tokenizer's `<IMG_CONTEXT>` id, one
token, or the trainer refuses it before it builds the data plane.

`load_from` starts from an HF checkpoint's weights (`checkpoint/hf.py`);
`hf_interval` N exports the masters to `<work_dir>/hf-step-N` every N
steps on a background thread, at most one export in flight, joined before
`fit` returns.

Options off the ported path raise: `profile_step`, `debug_nan_hooks`, `act_stats_interval`
and `track_memory` ([profiler]); `health_check_interval` and the
tensorboard tracker ([trainer-rest]); any mesh axis above 1 ([parallelism],
checked before the data plane is built, so the JAX rules for sp > 1 have
no counterpart here yet).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

from .. import not_ported
from ..checkpoint.torch_io import TrainCheckpointManager
from ..config.optim import AdamWConfig, LRConfig
from ..datasets.config import DataloaderConfig
from ..engine.train_engine import TrainEngine, resolve_device
from ..parallel.mesh import MeshConfig
from ..utils.logger import get_logger, log_file_handler
from ..writer import JsonlWriter, TensorboardWriter

logger = get_logger()


class TrainerHook:
    """Hook protocol: called after each train step and each save."""

    def after_train_step(self, trainer: "Trainer", step: int, metrics: dict) -> None: ...

    def after_save_checkpoint(self, trainer: "Trainer", step: int) -> None: ...

    def after_save_hf(self, trainer: "Trainer", step: int, path: str) -> None: ...


def _git_state() -> dict:
    """Commit and diff stat of the running code; empty outside a git repo."""
    def run(*args):
        try:
            return subprocess.run(["git", *args], capture_output=True, text=True, timeout=5,
                                  cwd=str(Path(__file__).resolve().parent)).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            return ""

    commit = run("rev-parse", "HEAD")
    if not commit:
        return {}
    return {"commit": commit, "branch": run("rev-parse", "--abbrev-ref", "HEAD"),
            "diff_stat": run("diff", "--stat")[-2000:]}


@dataclass
class TrainerConfig:
    model_cfg: Any
    dataloader_cfg: DataloaderConfig
    optim_cfg: Any = field(default_factory=AdamWConfig)
    lr_cfg: LRConfig = field(default_factory=LRConfig)
    mesh_cfg: MeshConfig = field(default_factory=MeshConfig)
    # batch geometry: rows are packed sequences of pack_max_length tokens
    global_batch_rows: int = 8
    micro_batch_rows: int = 1
    total_steps: Optional[int] = None
    epochs: float = 1.0
    # io
    load_from: Optional[str] = None  # HF checkpoint dir
    tokenizer_path: Optional[str] = None  # None -> UTF8ByteTokenizer toy
    work_dir: str = "work_dirs"
    exp_name: str = "default"
    checkpoint_interval: Optional[int] = None  # steps; None = only at the end
    checkpoint_max_keep: Optional[int] = 2
    snapshot_interval: Optional[int] = None
    snapshot_max_keep: int = 1
    hf_interval: Optional[int] = None  # steps between HF exports (<work_dir>/hf-step-N)
    resume: bool = False
    # selective resume; the LR schedule is a function of the restored step
    load_model: bool = True
    load_optimizer_states: bool = True
    load_dataset: bool = True
    log_interval: int = 1
    seed: int = 0
    exp_tracker: str = "jsonl"  # jsonl | tensorboard ([trainer-rest])
    hooks: list[Any] = field(default_factory=list)  # TrainerHook instances
    profile_step: Optional[int] = None  # [profiler]
    health_check_interval: Optional[int] = None  # [trainer-rest]
    act_stats_interval: Optional[int] = None  # [profiler]
    debug_nan_hooks: bool = False  # [profiler]
    track_memory: bool = False  # [profiler]

    def check_ported(self) -> None:
        self.mesh_cfg.check_ported()  # before the data plane tokenizes anything
        for name in ("profile_step", "act_stats_interval", "debug_nan_hooks",
                     "track_memory"):
            if getattr(self, name):
                raise not_ported(f"the trainer's {name} option", "profiler")
        if self.health_check_interval:
            raise not_ported("the accelerator health check (health_check_interval)",
                             "trainer-rest")


class Trainer:
    """`Trainer(cfg, device=None)`: on the card unless `device` names
    another; with no card and no device given it raises before it builds
    anything."""

    def __init__(self, cfg: TrainerConfig, device=None):
        cfg.check_ported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.work_dir = Path(cfg.work_dir) / cfg.exp_name
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self._log_handler = log_file_handler(str(self.work_dir / "rank0.log"))
        self._write_meta()

        self.tokenizer = self._build_tokenizer()
        self._check_image_context()
        self._reconcile_config()
        self.dataloader = cfg.dataloader_cfg.build(
            self.tokenizer, cfg.global_batch_rows, cfg.micro_batch_rows
        )
        steps_per_epoch = len(self.dataloader)
        self.total_steps = cfg.total_steps or max(int(steps_per_epoch * cfg.epochs), 1)

        self.engine = TrainEngine(
            cfg.model_cfg, cfg.optim_cfg, cfg.lr_cfg, cfg.mesh_cfg, self.total_steps,
            device=self.device,
        )
        logger.info(
            f"model: {self.engine.num_params/1e6:.1f}M params | device {self.engine.device} "
            f"| compute {self.engine.compute_dtype} | remat {self.engine.remat} | "
            f"total_steps {self.total_steps}"
        )
        if cfg.load_from:
            self.engine.from_hf(cfg.load_from, cfg.seed)
            logger.info(f"loaded HF checkpoint from {cfg.load_from}")
        else:
            self.engine.init_random(cfg.seed)

        self._hf_export = None  # the async HF export in flight
        self.ckpt_mgr = TrainCheckpointManager(self.work_dir, cfg.checkpoint_max_keep)
        self.snapshot_mgr = None
        if cfg.snapshot_interval:
            self.snapshot_mgr = TrainCheckpointManager(
                self.work_dir / "snapshots", cfg.snapshot_max_keep)
        writer_cls = JsonlWriter if cfg.exp_tracker == "jsonl" else TensorboardWriter
        self.writer = writer_cls(self.work_dir)
        self.start_step = 0
        if cfg.resume:
            self._maybe_resume()

    # ------------------------------------------------------------------
    def _write_meta(self) -> None:
        """Experiment history in xtuner_meta.json: time, config, git state."""
        meta_path = self.work_dir / "xtuner_meta.json"
        history = json.loads(meta_path.read_text()) if meta_path.exists() else {"exps": []}
        history["exps"].append({
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
            "config": json.loads(json.dumps(dataclasses.asdict(self.cfg), default=str)),
            "git": _git_state(),
        })
        meta_path.write_text(json.dumps(history, indent=1))

    def _build_tokenizer(self):
        if self.cfg.tokenizer_path:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(self.cfg.tokenizer_path, trust_remote_code=True)
        from .toy_tokenizer import UTF8ByteTokenizer

        logger.info("no tokenizer_path given; using UTF8ByteTokenizer toy tokenizer")
        classes = {d.class_name for d in self.cfg.dataloader_cfg.datasets}
        specials = []
        if "qwen3_vl" in classes:
            # the vision specials as single tokens: JAX's Trainer builds the toy
            # tokenizer without them, and Qwen3VLTokenizeFn then takes "<" for
            # the image pad and raises on every sample
            from ..datasets.qwen_vl import VL_SPECIALS

            specials += VL_SPECIALS
        if "internvl" in classes:
            # and InternVL's: without them JAX's InternVLTokenizeFn writes
            # <IMG_CONTEXT> as 13 bytes, which no image_context_token_id matches
            from ..datasets.vlm import IMG_SPECIALS

            specials += IMG_SPECIALS
        return UTF8ByteTokenizer(specials)

    def _check_image_context(self) -> None:
        """An image-context model on an "internvl" dataset: its
        `image_context_token_id` must be the tokenizer's one `<IMG_CONTEXT>`
        id, or no position would take a vision token."""
        want = getattr(self.cfg.model_cfg, "image_context_token_id", None)
        if want is None or not any(d.class_name == "internvl"
                                   for d in self.cfg.dataloader_cfg.datasets):
            return
        from ..datasets.vlm import IMG_CONTEXT

        ids = self.tokenizer.encode(IMG_CONTEXT, add_special_tokens=False)
        if list(ids) != [want]:
            raise ValueError(f"image_context_token_id {want} is not the tokenizer's "
                             f"{IMG_CONTEXT} (it encodes to {list(ids)[:16]}): the vision "
                             f"embeds would reach no position")

    def _reconcile_config(self) -> None:
        """Config conflict resolution, as the JAX trainer: the dataloader
        takes the loss's reduction, and the pad id comes from the tokenizer
        (pad -> eos -> 0) when the config gives none."""
        cfg = self.cfg
        loss_red = cfg.model_cfg.lm_loss_cfg.loss_reduction
        if cfg.dataloader_cfg.loss_reduction != loss_red:
            cfg.dataloader_cfg.loss_reduction = loss_red

        if cfg.dataloader_cfg.pad_token_id is None:
            pad = getattr(self.tokenizer, "pad_token_id", None)
            if pad is None:
                pad = getattr(self.tokenizer, "eos_token_id", None)
            if isinstance(pad, list):
                pad = pad[0]
            if not isinstance(pad, int):
                logger.warning(f"tokenizer pad_token_id is {pad!r}; using 0")
                pad = 0
            cfg.dataloader_cfg.pad_token_id = pad

    def _maybe_resume(self) -> None:
        latest = self.ckpt_mgr.latest_step()
        mgr = self.ckpt_mgr
        # a newer snapshot beats an older full checkpoint
        if self.snapshot_mgr is not None:
            snap = self.snapshot_mgr.latest_step()
            if snap is not None and (latest is None or snap > latest):
                latest, mgr = snap, self.snapshot_mgr
        if latest is None:
            logger.info("resume requested but no checkpoint found; starting fresh")
            return
        _, opt_state, train_state, dl_state = mgr.restore(
            latest, self.engine.params, self.engine.opt_state,
            load_model=self.cfg.load_model,
            load_optimizer=self.cfg.load_optimizer_states,
            load_dataset=self.cfg.load_dataset,
        )
        # the params were restored in place, into the engine's masters
        if self.cfg.load_optimizer_states:
            self.engine.opt_state = opt_state
        self.start_step = train_state["step"]
        if dl_state is not None:
            self.dataloader.load_state_dict(dl_state)
        logger.info(f"resumed from checkpoint step {latest}")

    def _save(self, step: int, mgr: Optional[TrainCheckpointManager] = None) -> None:
        (mgr or self.ckpt_mgr).save(
            step, self.engine.params, self.engine.opt_state,
            train_state={"step": step},
            dataloader_state=self.dataloader.get_state_dict(),
        )

    # ------------------------------------------------------------------
    def fit(self) -> None:
        cfg = self.cfg
        data_iter = iter(self.dataloader)
        consumed_tokens = 0
        t_start = time.time()
        try:
            for step in range(self.start_step + 1, self.total_steps + 1):
                t0 = time.time()
                batch = next(data_iter)
                t_data = time.time() - t0
                metrics = self.engine.train_step(batch, step)  # reads the device back
                step_time = time.time() - t0
                consumed_tokens += int(metrics["consumed_tokens"])
                # real consumed tokens, not the pack ceiling
                tgs = metrics["consumed_tokens"] / step_time
                eta = (self.total_steps - step) * step_time
                if step % cfg.log_interval == 0 or step == self.total_steps:
                    idx = "".join(f"{k} {metrics[k]:.4f} " for k in
                                  ("dsa_index_loss", "mtp_loss") if k in metrics)
                    logger.info(
                        f"Step {step}/{self.total_steps} lr {metrics['lr']:.3e} "
                        f"text_tokens {metrics['consumed_tokens']:.0f} "
                        f"reduced_llm_loss {metrics['reduced_llm_loss']:.4f} {idx}"
                        f"grad_norm {metrics['grad_norm']:.4f} "
                        f"tgs {tgs:.1f} data_time {t_data:.3f}s step_time {step_time:.3f}s "
                        f"eta {eta/60:.1f}min"
                    )
                    self.writer.add_scalars(
                        {**metrics, "tgs": tgs, "step_time": step_time, "data_time": t_data},
                        step)
                for hook in cfg.hooks:
                    hook.after_train_step(self, step, metrics)
                if self.snapshot_mgr is not None and step % cfg.snapshot_interval == 0:
                    self._save(step, self.snapshot_mgr)
                if cfg.checkpoint_interval and step % cfg.checkpoint_interval == 0 \
                        and step != self.total_steps:
                    self._save(step)
                    for hook in cfg.hooks:
                        hook.after_save_checkpoint(self, step)
                if cfg.hf_interval and step % cfg.hf_interval == 0:
                    hf_path = str(self.work_dir / f"hf-step-{step}")
                    # snapshot to the host, write in the background (at most
                    # one export in flight)
                    if self._hf_export is not None:
                        self._hf_export.join()
                    self._hf_export = self.engine.async_save_hf(hf_path)
                    for hook in cfg.hooks:
                        hook.after_save_hf(self, step, hf_path)

            self._save(self.total_steps)
            if self._hf_export is not None:
                self._hf_export.join()
            self.ckpt_mgr.wait()
            if self.snapshot_mgr is not None:
                self.snapshot_mgr.wait()
            total_time = time.time() - t_start
            logger.info(
                f"training done: {self.total_steps - self.start_step} steps, "
                f"{consumed_tokens} tokens, {total_time/60:.1f} min"
            )
        finally:
            self.close()

    def close(self) -> None:
        """Flush the tracker, stop the prefetch thread, close the log file."""
        self.writer.close()
        self.dataloader.close()
        logger.removeHandler(self._log_handler)
        self._log_handler.close()
