"""GRPO RL of the port (counterpart: `xtuner_tpu/rl/`): the colocate trainer
(`trainer.py`), its losses, advantages, judgers, replay buffer, rollout-IS
correction, trace store and evaluator. The scale plane of the JAX package
(rollout workers, producers, the disaggregated trainer, session server,
transports, sandbox, health manager, spans) is not ported ([rl-rest])."""

from .advantage import compute_advantage
from .grpo_loss import GRPOLossConfig, OREALLossConfig, grpo_loss, kl_penalty, oreal_loss
from .judger import GSM8KJudger, HTTPJudger, Judger
from .replay_buffer import ReplayBuffer, SampleGroup

__all__ = [
    "compute_advantage",
    "GRPOLossConfig",
    "OREALLossConfig",
    "grpo_loss",
    "oreal_loss",
    "kl_penalty",
    "Judger",
    "GSM8KJudger",
    "HTTPJudger",
    "ReplayBuffer",
    "SampleGroup",
]
