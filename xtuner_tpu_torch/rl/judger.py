"""Judgers, the reward functions (counterpart: `xtuner_tpu/rl/judger.py`).

The local judgers are copies of JAX's (that module imports no JAX): GSM8K's
`#### n` gold answer against the response's last number or last
`\\boxed{}`, DAPO's literal `\\boxed{}` match, and a weighted composition
by data source. `HTTPJudger`, the LLM verifier behind a chat endpoint,
raises: it needs a judge served over the network ([rl-rest]).
"""

from __future__ import annotations

import re
from typing import Any, Optional, Protocol

from .. import not_ported


class Judger(Protocol):
    def judge(self, response: str, label: Any) -> float: ...


def extract_last_number(text: str) -> Optional[str]:
    matches = re.findall(r"-?\d[\d,]*\.?\d*", text.replace("$", ""))
    if not matches:
        return None
    return matches[-1].rstrip(".").replace(",", "")


def extract_boxed(text: str) -> Optional[str]:
    m = re.findall(r"\\boxed\{([^{}]*)\}", text)
    return m[-1].strip() if m else None


class GSM8KJudger:
    """Reward 1.0 for the correct final answer (reference gsm8k.py:80:
    '#### <answer>' gold format, last-number extraction from the response)."""

    def __init__(self, extract_fn: str = "last_number"):
        self.extract_fn = extract_fn

    def judge(self, response: str, label: Any) -> float:
        gold = str(label).split("####")[-1].strip().replace(",", "")
        pred = extract_boxed(response) or extract_last_number(response)
        if pred is None:
            return 0.0
        try:
            return 1.0 if abs(float(pred) - float(gold)) < 1e-6 else 0.0
        except ValueError:
            return 1.0 if pred == gold else 0.0


class MathBoxedJudger:
    """DAPO-style: compare \\boxed{...} answers literally (judger/gsm8k.py:293)."""

    def judge(self, response: str, label: Any) -> float:
        pred = extract_boxed(response)
        return 1.0 if pred is not None and pred == str(label).strip() else 0.0


class ComposedJudger:
    """Weighted sum of judgers keyed by data source (reference multi-judger)."""

    def __init__(self, judgers: dict[str, Judger], weights: Optional[dict[str, float]] = None):
        self.judgers = judgers
        self.weights = weights or {}

    def judge(self, response: str, label: Any, source: str = "default") -> float:
        judger = self.judgers.get(source) or next(iter(self.judgers.values()))
        w = self.weights.get(source, 1.0)
        return w * judger.judge(response, label)


JUDGER_MAP = {
    "gsm8k": GSM8KJudger,
    "math_boxed": MathBoxedJudger,
}


class HTTPJudger:
    """An LLM verifier over an OpenAI-compatible chat endpoint (JAX
    `HTTPJudger`); not ported."""

    def __init__(self, *args, **kwargs):
        raise not_ported("HTTPJudger (an LLM judge over the network)", "rl-rest")
