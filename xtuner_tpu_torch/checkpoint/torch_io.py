"""Train checkpoint save and resume (counterpart:
`xtuner_tpu/checkpoint/orbax_io.py`, `TrainCheckpointManager`).

The same API and directory layout:

    <work_dir>/checkpoints/step-N/params.pt            the f32 master tree
    <work_dir>/checkpoints/step-N/opt_state.pt         AdamW count, m, v
    <work_dir>/checkpoints/step-N/dataloader_state.json
    <work_dir>/checkpoints/step-N/train_state.json     commit marker, written last

A directory without `train_state.json` (a save cut short) is never listed
or restored. `max_keep` keeps the newest committed steps. Saves are
synchronous here: `save` returns when the files are on disk and `wait()`
has nothing to wait for (the JAX manager's async save is ROADMAP
[trainer-rest]). `restore` copies the saved params INTO the template (the
engine's masters, wherever they live), so a resumed engine keeps its
tensors and views; tensors are read memory-mapped.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

from ..module.params import tree_paths
from ..utils.logger import get_logger

logger = get_logger()


def _flat(tree) -> dict[str, torch.Tensor]:
    return {"/".join(path): t.detach() for path, t in tree_paths(tree)}


@torch.no_grad()
def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    if src.dtype != dst.dtype:
        logger.warning(f"checkpoint dtype drift at {name}: saved {src.dtype} -> "
                       f"restoring as {dst.dtype}")
    dst.copy_(src)


class TrainCheckpointManager:
    def __init__(self, work_dir: str | Path, max_keep: Optional[int] = None):
        self.ckpt_dir = Path(work_dir).resolve() / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_keep = max_keep

    def _step_dir(self, step: int) -> Path:
        return self.ckpt_dir / f"step-{step}"

    def list_steps(self) -> list[int]:
        steps = []
        for p in self.ckpt_dir.glob("step-*"):
            if (p / "train_state.json").exists():  # only committed checkpoints
                steps.append(int(p.name.split("-")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state: dict, train_state: dict[str, Any],
             dataloader_state: Optional[dict] = None) -> None:
        """params: the master tree; opt_state: `AdamW.state_dict()`."""
        step_dir = self._step_dir(step)
        if step_dir.exists():
            shutil.rmtree(step_dir)  # a save cut short, or a re-run of this step
        step_dir.mkdir(parents=True)
        torch.save(_flat(params), step_dir / "params.pt")
        torch.save({"count": int(opt_state["count"]),
                    "m": [t.detach() for t in opt_state["m"]],
                    "v": [t.detach() for t in opt_state["v"]]}, step_dir / "opt_state.pt")
        if dataloader_state is not None:
            (step_dir / "dataloader_state.json").write_text(json.dumps(dataloader_state))
        (step_dir / "train_state.json").write_text(json.dumps(train_state))
        logger.info(f"saved checkpoint step {step} -> {step_dir}")
        self._gc()

    def _gc(self) -> None:
        if self.max_keep is None:
            return
        for step in self.list_steps()[: -self.max_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, params_template, opt_template: dict, *,
                load_model: bool = True, load_optimizer: bool = True,
                load_dataset: bool = True):
        """Copy step `step`'s params into `params_template` (the current
        params tree) and return (params, opt_state, train_state,
        dataloader_state); opt_state is the saved `AdamW.state_dict()`,
        read memory-mapped, for `AdamW.load_state_dict`. A False flag keeps
        the caller's state for that component (selective resume): the
        template comes back, and dataloader_state is None."""
        step_dir = self._step_dir(step)
        if load_model:
            saved = torch.load(step_dir / "params.pt", map_location="cpu", mmap=True,
                               weights_only=True)
            want = _flat(params_template)
            if sorted(saved) != sorted(want):
                raise ValueError(f"checkpoint params differ: missing "
                                 f"{sorted(set(want) - set(saved))}, extra "
                                 f"{sorted(set(saved) - set(want))}")
            for name, dst in want.items():
                _copy_into(dst, saved[name], name)
        opt_state = opt_template
        if load_optimizer:
            opt_state = torch.load(step_dir / "opt_state.pt", map_location="cpu", mmap=True,
                                   weights_only=True)
        train_state = json.loads((step_dir / "train_state.json").read_text())
        dl_path = step_dir / "dataloader_state.json"
        dataloader_state = (json.loads(dl_path.read_text())
                            if load_dataset and dl_path.exists() else None)
        return params_template, opt_state, train_state, dataloader_state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""
