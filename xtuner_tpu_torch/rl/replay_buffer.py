"""Replay buffer with staleness expiry (counterpart:
`xtuner_tpu/rl/replay_buffer.py`, a copy: that module imports no JAX).

`SampleGroup` is one prompt's rollouts; `ReplayBuffer` keeps groups in FIFO
order, drops those older than `max_staleness` policy versions, and pops
them by count (`get`) or by a Mongo-style filter (`query`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class SampleGroup:
    """One prompt's G rollout samples + rewards/advantages."""

    prompt_id: Any
    samples: list[dict]  # each: {prompt_ids, response_ids, logprobs, reward, advantage, ...}
    policy_version: int = 0
    meta: dict = field(default_factory=dict)


class ReplayBuffer:
    def __init__(self, max_staleness: Optional[int] = None):
        self.groups: list[SampleGroup] = []
        self.max_staleness = max_staleness

    def put(self, group: SampleGroup) -> None:
        self.groups.append(group)

    def __len__(self) -> int:
        return len(self.groups)

    def num_samples(self) -> int:
        return sum(len(g.samples) for g in self.groups)

    def maybe_expire(self, current_version: int) -> int:
        """Drop groups older than max_staleness policy versions; returns count."""
        if self.max_staleness is None:
            return 0
        before = len(self.groups)
        self.groups = [
            g for g in self.groups
            if current_version - g.policy_version <= self.max_staleness
        ]
        return before - len(self.groups)

    def get(self, n_groups: int, predicate: Optional[Callable[[SampleGroup], bool]] = None
            ) -> list[SampleGroup]:
        """FIFO pop of up to n_groups groups matching the predicate."""
        taken, kept = [], []
        for g in self.groups:
            if len(taken) < n_groups and (predicate is None or predicate(g)):
                taken.append(g)
            else:
                kept.append(g)
        self.groups = kept
        return taken

    # ------------------------------------------------------------------
    def query(self, q: dict, pop: bool = False, limit: Optional[int] = None
              ) -> list[SampleGroup]:
        """Mongo-style filter over groups (reference query language,
        replay_buffer.py:179-228): `{"$and"|"$or": [...]}` logic nodes over
        `{field: {"$eq"|"$ne"|"$gt"|"$gte"|"$lt"|"$lte"|"$in"|"$not_in"|
        "$between": value}}` conditions. Fields resolve against the group
        (prompt_id, policy_version) then its meta dict. `pop=True` removes
        the matches (FIFO order preserved)."""
        matches, kept = [], []
        for g in self.groups:
            if (limit is None or len(matches) < limit) and _match(g, q):
                matches.append(g)
            else:
                kept.append(g)
        if pop:
            self.groups = kept
        return matches


def _field(g: SampleGroup, name: str):
    if hasattr(g, name):
        return getattr(g, name)
    if name in g.meta:
        return g.meta[name]
    raise KeyError(f"unknown query field {name!r}; group fields: prompt_id, "
                   f"policy_version, meta keys {sorted(g.meta)}")


def _match(g: SampleGroup, q: dict) -> bool:
    for key, spec in q.items():
        if key == "$and":
            if not all(_match(g, sub) for sub in spec):
                return False
        elif key == "$or":
            if not any(_match(g, sub) for sub in spec):
                return False
        else:
            val = _field(g, key)
            if not isinstance(spec, dict):
                spec = {"$eq": spec}
            for op, arg in spec.items():
                ok = {
                    "$eq": lambda: val == arg,
                    "$ne": lambda: val != arg,
                    "$gt": lambda: val > arg,
                    "$gte": lambda: val >= arg,
                    "$lt": lambda: val < arg,
                    "$lte": lambda: val <= arg,
                    "$in": lambda: val in arg,
                    "$not_in": lambda: val not in arg,
                    "$between": lambda: arg[0] <= val <= arg[1],
                }.get(op)
                if ok is None:
                    raise ValueError(f"unknown query op {op!r}")
                if not ok():
                    return False
    return True
