"""MoE expert MLP and its dispatch pipeline (counterpart:
`xtuner_tpu/module/moe_layer.py`).

`moe_mlp_forward` follows the JAX package's grouped-GEMM branch
(`moe_layer.py:95-129`): route, permute rows by expert, one grouped GEMM on
gate|up concatenated into (E, H, 2F), silu(gate) * up in f32, one grouped
GEMM on down, weighted combine. The grouped GEMMs are
`ops/bf16_grouped.py::bf16_grouped_linear`: the Hopper kernels on a card,
their plain versions on the CPU.

With `XTUNER_FUSED_MLP` set to anything but "0", act "silu" and no fp8,
it follows JAX's fused branch (`moe_layer.py:107-118`): one
`ops/fused_moe_mlp.py::fused_moe_mlp` call on the sorted rows, `w_cat` and
down (TPU kernel #16, whose backward runs the grouped "nt" and wgrad
kernels). JAX takes that branch only with `gemm_impl="pallas"` (on the
TPU); the port has no `gemm_impl` and takes it wherever the switch is set.
Under fp8 or another activation the switch is ignored, as in JAX.

With `fp8_cfg` enabled it follows JAX's fp8 branch (`moe_layer.py:130-154`):
gate, up and down are three `ops/fp8_grouped.py::fp8_grouped_linear` calls
(TPU kernels #12 and #13). gate and up stay two calls, not one on the
fused (E, H, 2F) weight: the wgrad quantises g with one scale per 128-row
tile over all its columns, so a fused (M, 2F) gradient would get other
scales than two (M, F) ones.

gpt-oss's clipped experts (act "swiglu_clipped", `ops/act_fn.py`) take the
decomposed or the fp8 branch, as in JAX: the fused branch is silu only.

`fuse_gate_up` lays a stack's gate and up weights out as the two halves of
one gate|up buffer; `gate_up_weight` then reads that buffer as a view
where it would otherwise concatenate the two (1.06 GB a layer at
gpt-oss-20b's E32 H2880 F2880). The values are the same either way.

Not ported yet: the a2a and agrs dispatchers and expert parallelism
(Queue 1, parallelism).
"""

from __future__ import annotations

import os

import torch

from .. import not_ported
from ..ops.act_fn import gated_act
from ..ops.bf16_grouped import bf16_grouped_linear
from ..ops.float8 import fp8_enabled
from ..ops.fp8_grouped import fp8_grouped_linear
from ..ops.fused_moe_mlp import fused_moe_mlp
from ..ops.moe import permute, unpermute
from .params import ParamSpec
from .router import RouterConfig, RouterOutput, route


def expert_mlp_param_specs(hidden_size: int, moe_intermediate_size: int,
                           num_experts: int, init_scale: float = 0.02) -> dict:
    e, h, f = num_experts, hidden_size, moe_intermediate_size
    return {
        "gate_proj": ParamSpec((e, h, f), scale=init_scale),
        "up_proj": ParamSpec((e, h, f), scale=init_scale),
        "down_proj": ParamSpec((e, f, h), scale=init_scale),
    }


def fuse_gate_up(experts: dict) -> None:
    """Replace `experts["gate_proj"]` and `["up_proj"]` (..., H, F), IN
    PLACE, by the two halves of one (..., H, 2F) buffer holding the same
    values (`gate_up_weight` reads it without a copy). A no-op where they
    already are."""
    g, u = experts["gate_proj"], experts["up_proj"]
    if _halves_of_one(g, u):
        return
    f = g.shape[-1]
    gu = torch.cat([g, u], dim=-1)
    experts["gate_proj"], experts["up_proj"] = gu[..., :f], gu[..., f:]


def _halves_of_one(g: torch.Tensor, u: torch.Tensor) -> bool:
    """Whether g and u are the left and right halves of one contiguous
    (..., 2F) tensor."""
    f = g.shape[-1]
    want = torch.empty((*g.shape[:-1], 2 * f), device="meta").stride()
    return (g.shape == u.shape and g.dtype == u.dtype and g.stride() == u.stride() == want
            and g.untyped_storage().data_ptr() == u.untyped_storage().data_ptr()
            and u.storage_offset() == g.storage_offset() + f)


def gate_up_weight(p: dict, dtype) -> torch.Tensor:
    """gate|up as one (E, H, 2F) weight in `dtype`: a view where gate_proj
    and up_proj are the halves of one buffer (`fuse_gate_up`), else their
    concatenation."""
    g, u = p["gate_proj"].to(dtype), p["up_proj"].to(dtype)
    if _halves_of_one(g, u):
        return g.as_strided((*g.shape[:-1], 2 * g.shape[-1]), g.stride())
    return torch.cat([g, u], dim=2)


def moe_mlp_forward(p: dict, router_p: dict, router_cfg: RouterConfig, x: torch.Tensor,
                    *, num_experts: int, top_k: int, act: str = "silu",
                    compute_dtype=torch.bfloat16, dispatcher: str = "gspmd",
                    forced_topk_idx=None, fp8_cfg=None):
    """x: (B, L, H) -> (out (B, L, H), RouterOutput, expert_load (E,) int32).
    Dropless: every routed token is computed. `forced_topk_idx` (B L, K):
    the replayed expert ids (`router.py::route`; entries below 0 route
    afresh) or None."""
    if dispatcher != "gspmd":
        raise not_ported(f"the {dispatcher!r} MoE dispatcher", "parallelism")
    b, l, h = x.shape
    x2d = x.reshape(b * l, h)
    r: RouterOutput = route(router_p, router_cfg, x2d, top_k, forced_idx=forced_topk_idx)
    info = permute(x2d.to(compute_dtype), r.topk_idx, num_experts,
                   topk_weights=r.topk_weights)
    if fp8_enabled(fp8_cfg):
        e5m2 = getattr(fp8_cfg, "e5m2_grads", False)

        def gg(x_, w_):
            return fp8_grouped_linear(x_, w_.to(compute_dtype), info.group_sizes, e5m2)

        gate = gg(info.sorted_tokens, p["gate_proj"]).float()
        up = gg(info.sorted_tokens, p["up_proj"]).float()
        hidden = gated_act(gate, up, act).to(compute_dtype)
        out = gg(hidden, p["down_proj"])
        combined = unpermute(out, info, b * l)
        return combined.reshape(b, l, h).to(compute_dtype), r, info.group_sizes
    f = p["gate_proj"].shape[2]
    w_cat = gate_up_weight(p, compute_dtype)
    if act == "silu" and os.environ.get("XTUNER_FUSED_MLP", "0") != "0":
        out = fused_moe_mlp(info.sorted_tokens, w_cat, p["down_proj"].to(compute_dtype),
                            info.group_sizes)
    else:
        gu = bf16_grouped_linear(info.sorted_tokens, w_cat, info.group_sizes)
        gate, up = gu[:, :f].float(), gu[:, f:].float()
        hidden = gated_act(gate, up, act).to(compute_dtype)
        out = bf16_grouped_linear(hidden, p["down_proj"].to(compute_dtype), info.group_sizes)
    combined = unpermute(out, info, b * l)
    return combined.reshape(b, l, h).to(compute_dtype), r, info.group_sizes
