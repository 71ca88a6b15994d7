"""RL evaluator: eval-set rollouts scored with pass@k by data source
(counterpart: `xtuner_tpu/rl/evaluator.py`; the config is a dataclass).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..utils.logger import get_logger

logger = get_logger()


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k estimator (Codex paper): 1 - C(n-c, k)/C(n, k)."""
    if n - c < k:
        return 1.0
    return 1.0 - math.prod((n - c - i) / (n - i) for i in range(k))


@dataclass
class EvaluatorConfig:
    eval_path: str  # jsonl with {"prompt"|"messages", "label", "source"?}
    samples_per_prompt: int = 1
    pass_k: list[int] = field(default_factory=lambda: [1])
    max_prompts: Optional[int] = None
    eval_interval: Optional[int] = None  # trainer steps between evals


class Evaluator:
    def __init__(self, cfg: EvaluatorConfig, judger, generate_fn):
        """generate_fn(prompts: list[dict], n: int) -> list[list[str]]:
        n response texts per prompt (the trainer binds this to its rollout)."""
        self.cfg = cfg
        self.judger = judger
        self.generate_fn = generate_fn
        self.items = [json.loads(x) for x in Path(cfg.eval_path).read_text().splitlines() if x]
        if cfg.max_prompts:
            self.items = self.items[: cfg.max_prompts]

    def run(self) -> dict[str, float]:
        n = self.cfg.samples_per_prompt
        responses = self.generate_fn(self.items, n)
        by_source: dict[str, list[tuple[int, int]]] = {}
        rewards = []
        for item, resps in zip(self.items, responses):
            label = item.get("label") or item.get("answer")
            correct = sum(1 for r in resps if self.judger.judge(r, label) > 0.5)
            rewards.extend(self.judger.judge(r, label) for r in resps)
            by_source.setdefault(item.get("source", "default"), []).append((len(resps), correct))

        metrics: dict[str, float] = {"eval_mean_reward": float(np.mean(rewards)) if rewards else 0.0}
        for source, counts in by_source.items():
            prefix = f"eval/{source}" if source != "default" else "eval"
            metrics[f"{prefix}_accuracy"] = float(
                np.mean([c / max(nn, 1) for nn, c in counts]))
            for k in self.cfg.pass_k:
                if k <= n:
                    metrics[f"{prefix}_pass@{k}"] = float(
                        np.mean([pass_at_k(nn, c, k) for nn, c in counts]))
        logger.info("evaluation: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        return metrics
