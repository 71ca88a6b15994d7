"""Optimizer, schedule, loss and mesh configs of the port (counterpart:
`xtuner_tpu/config/`)."""

from ..loss.ce_loss import CELossConfig
from ..parallel.mesh import MeshConfig
from .optim import AdamWConfig, LRConfig, MuonConfig, build_lr_schedule

__all__ = ["CELossConfig", "MeshConfig", "AdamWConfig", "MuonConfig", "LRConfig",
           "build_lr_schedule"]
