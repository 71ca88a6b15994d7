"""Parallelism layout (counterpart: `xtuner_tpu/parallel/mesh.py`).

`MeshConfig` keeps the JAX fields and defaults so configs translate. On one
card the port reads the mixed-precision and remat fields: `param_dtype` is
the compute dtype of the forward and backward, `remat_policy` (and
`recompute_ratio`, as the JAX engine reads it) pick the remat policy of
`model/dense.py::remat_wrap`. Every mesh axis must be 1 or -1 (absorb the
one device); a larger axis, custom sharding rules or another reduce dtype
raise ([parallelism]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .. import not_ported

MESH_AXES = ("dp", "fsdp", "ep", "sp", "tp")


@dataclass
class MeshConfig:
    dp_size: int = 1  # HSDP replicate dim; -1 = absorb remaining devices
    fsdp_size: int = -1  # -1 = absorb all remaining devices
    ep_size: int = 1
    sp_size: int = 1
    tp_size: int = 1
    sharding_rules: list[tuple[str, Any]] = field(default_factory=list)
    param_dtype: str = "bfloat16"  # compute dtype for params
    reduce_dtype: str = "float32"  # grad accumulation dtype
    recompute_ratio: float = 1.0
    remat_policy: str = "full"

    def check_ported(self) -> None:
        sizes = {a: getattr(self, f"{a}_size") for a in MESH_AXES}
        if [a for a, v in sizes.items() if v == -1][1:]:
            raise ValueError(f"At most one mesh axis may be -1, got {sizes}")
        bigger = {a: v for a, v in sizes.items() if v not in (1, -1)}
        if bigger:
            raise not_ported(f"mesh axes {bigger} on one card", "parallelism")
        if self.sharding_rules:
            raise not_ported("custom sharding rules", "parallelism")
        if self.reduce_dtype != "float32":
            raise not_ported(f"reduce_dtype {self.reduce_dtype!r}", "parallelism")

    @property
    def compute_dtype(self) -> torch.dtype:
        dtype = getattr(torch, self.param_dtype, None)
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"param_dtype {self.param_dtype!r} is not a float dtype")
        return dtype

    @property
    def remat(self) -> str:
        """The policy the engine runs (the JAX engine's rule)."""
        return self.remat_policy if self.recompute_ratio > 0 else "none"
