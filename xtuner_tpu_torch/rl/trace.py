"""Rollout trace store (counterpart: `xtuner_tpu/rl/trace.py`, a copy: that
module imports no JAX).

One jsonl shard per train step under <work_dir>/rollout_traces/, each line
a sample record (prompt / response ids and text, reward, advantage,
logprobs, policy version). `record` is the trainer's capture,
`load_groups` its debug replay; `load_step` / `iter_traces` read records
back. A sample's R3 routing (`routed_experts`, (n, nL, K)) is recorded
and replayed too: JAX's shards drop it, so a JAX replay of an R3 capture
routes afresh (ROADMAP.md, known faults in the reference). JAX reads the
port's shards and ignores the extra key."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np

from .replay_buffer import SampleGroup


class RolloutTraceStore:
    def __init__(self, root: str | Path, enabled: bool = True):
        self.root = Path(root) / "rollout_traces"
        self.enabled = enabled
        self._written: set[int] = set()  # steps written by THIS run
        if enabled:
            self.root.mkdir(parents=True, exist_ok=True)

    def _shard(self, step: int) -> Path:
        return self.root / f"step-{step:06d}.jsonl"

    def record(self, step: int, groups: list[SampleGroup], tokenizer=None) -> None:
        if not self.enabled:
            return
        # first write of a step in this run truncates any stale shard from an
        # interrupted earlier capture (append would duplicate records and
        # double the replayed batch)
        mode = "a" if step in self._written else "w"
        self._written.add(step)
        with self._shard(step).open(mode) as f:
            for g in groups:
                for si, s in enumerate(g.samples):
                    rec: dict[str, Any] = {
                        "ts": time.time(),
                        "step": step,
                        "prompt_id": g.prompt_id,
                        "sample_index": si,
                        "policy_version": g.policy_version,
                        "prompt_ids": list(map(int, s["prompt_ids"])),
                        "response_ids": list(map(int, s["response_ids"])),
                        "reward": float(s.get("reward", 0.0)),
                        "advantage": float(s.get("advantage", 0.0)),
                        "logprobs": [float(x) for x in s.get("logprobs", [])],
                    }
                    if tokenizer is not None:
                        rec["response_text"] = tokenizer.decode(rec["response_ids"])
                    if "versions" in s:
                        rec["token_versions"] = list(map(int, s["versions"]))
                    if "routed_experts" in s:
                        rec["routed_experts"] = np.asarray(s["routed_experts"]).tolist()
                    f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("-")[1]) for p in self.root.glob("step-*.jsonl"))

    def load_step(self, step: int) -> list[dict]:
        path = self._shard(step)
        if not path.exists():
            return []
        return [json.loads(l) for l in path.read_text().splitlines() if l]

    def iter_traces(self, start: Optional[int] = None,
                    end: Optional[int] = None) -> Iterator[dict]:
        for step in self.steps():
            if start is not None and step < start:
                continue
            if end is not None and step > end:
                break
            yield from self.load_step(step)

    def load_groups(self, step: int) -> list[SampleGroup]:
        """Reconstruct SampleGroups from a captured step — the debug-replay
        feed (reference rl_trainer.py:978-1010: train on a captured rollout
        batch instead of regenerating)."""
        by_prompt: dict[int, list[dict]] = {}
        versions: dict[int, int] = {}
        for rec in self.load_step(step):
            pid = int(rec["prompt_id"])
            versions[pid] = int(rec.get("policy_version", step))
            sample = {
                "prompt_ids": rec["prompt_ids"],
                "response_ids": rec["response_ids"],
                "logprobs": rec.get("logprobs", []),
                "reward": rec.get("reward", 0.0),
                "advantage": rec.get("advantage", 0.0),
            }
            if "routed_experts" in rec:
                sample["routed_experts"] = np.asarray(rec["routed_experts"], np.int32)
            by_prompt.setdefault(pid, []).append(sample)
        groups = []
        for pid, samples in by_prompt.items():
            rewards = [s["reward"] for s in samples]
            groups.append(SampleGroup(
                prompt_id=pid, samples=samples, policy_version=versions[pid],
                meta={"mean_reward": float(sum(rewards) / max(len(rewards), 1))}))
        return groups
