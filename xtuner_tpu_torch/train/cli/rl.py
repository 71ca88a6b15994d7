"""GRPO RL CLI (counterpart: `xtuner_tpu/train/cli/rl.py`): builds the
colocate trainer from a config file that defines
`trainer = RLTrainerConfig(...)` and runs it.

    python -m xtuner_tpu_torch.train.cli.rl --config xtuner_tpu_torch/recipes/rl_qwen3_4b_grpo.py

`--device` (default `cuda`) is the port's one flag of its own: the run is
on the card, and fails without one, unless it says `--device cpu`. `main`
returns the trainer after `fit`.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ...rl.trainer import RLColocateTrainer, RLTrainerConfig
from ...utils.config import Config


def load_config(path: str) -> RLTrainerConfig:
    cfg = Config.fromfile(path)["trainer"]
    if not isinstance(cfg, RLTrainerConfig):
        raise TypeError("config file must define `trainer = RLTrainerConfig(...)`")
    return cfg


def main(argv: Optional[list[str]] = None) -> RLColocateTrainer:
    p = argparse.ArgumentParser(description="xtuner-tpu GRPO RL trainer (PyTorch port)")
    p.add_argument("--config", type=str, required=True,
                   help="python config file defining `trainer = RLTrainerConfig(...)`")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    args = p.parse_args(argv)
    trainer = load_config(args.config).build(device=args.device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
