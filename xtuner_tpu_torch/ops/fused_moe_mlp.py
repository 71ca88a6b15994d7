"""Fused MoE expert MLP over expert-sorted rows (counterpart:
`xtuner_tpu/ops/fused_moe_mlp.py`: `_mlp_kernel` in `fused_mlp_fwd_kernel`
and the custom VJP `fused_moe_mlp`).

`fused_moe_mlp` is differentiable. Its forward is TPU kernel #16: per
expert, gate|up GEMM, silu(gate) * up and the down GEMM in one sweep,
writing only out and gu (`fused_moe_mlp_fwd`: the hand-written Hopper
kernel `csrc/fused_moe_mlp.cu` on a CUDA tensor, the plain version beside
it on a CPU tensor). The kernel walks expert-pure tiles of 128 rows
(`grouped_tile_plan`, the grouped GEMMs' rule), each in two phases:
gate|up by 128-column chunks of F with the activation in registers, its
hidden rows into the CTA's slot of a small bf16 scratch; then out by
256-column passes over that slot. `fused_mlp_chunked_plain` is that order
in plain torch, for the CPU tests. gu is rounded to bf16 before the
activation, as JAX rounds it, so the forward equals the decomposed path's
and the backward re-reads the same bf16 gu. The backward follows JAX's
`_fmlp_bwd` step by step on the grouped GEMMs of `ops/bf16_grouped.py`
(#6 "nt" for the two dgrads, #7 for the two wgrads) with the activation
and its gradient in plain PyTorch. JAX's 512-row padding, visit table and
dump block are TPU artefacts and are not needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bf16_grouped import (_ceil, _mm_f32, grouped_gemm_bf16, grouped_gemm_bf16_dw,
                           grouped_tile_plan)

MAX_F = 1536  # the kernel's hidden slots (128 x F bf16 per CTA) stay within L2
MAX_EXPERTS = 1024  # the kernel's tables in shared memory
TILE_M = 128  # rows of a kernel tile (the grouped GEMMs' too)
F_CHUNK = 128  # gate (and up) columns of a phase-1 chunk
N_PASS = 256  # output columns of a phase-2 pass
CHUNK = 64  # depth of one contraction chunk of the kernel's ring


def fused_mlp_plan_counts(group_sizes: torch.Tensor, m: int, h: int,
                          f: int) -> tuple[int, int, int]:
    """What one kernel launch walks, as its device counter sums it: (tiles
    with products, zero tiles, contraction chunks). A tile walks
    ceil(F / 128) x H / 64 chunks in phase 1 and ceil(H / 256) x F / 64 in
    phase 2."""
    expert = grouped_tile_plan(group_sizes, m, TILE_M)[0]
    busy = int((expert >= 0).sum())
    per = _ceil(f, F_CHUNK) * (h // CHUNK) + _ceil(h, N_PASS) * (f // CHUNK)
    return busy, len(expert) - busy, busy * per


def fused_mlp_chunked_plain(x, w_gu, w_dn, group_sizes):
    """The kernel's order in plain torch: per tile of `grouped_tile_plan`,
    gate|up over 128-column chunks of F (gu rounded to x.dtype, hidden =
    silu(gate) * up in f32 rounded to x.dtype), then out over 256-column
    passes of the whole hidden tile; rows past the last group zero. -> (out
    (M, H), gu (M, 2F)) in x.dtype."""
    m, h = x.shape
    f = w_dn.shape[1]
    out = x.new_zeros((m, h))
    gu = x.new_zeros((m, 2 * f))
    for e, rs, re in zip(*(t.tolist() for t in grouped_tile_plan(group_sizes, m, TILE_M))):
        if e < 0:
            continue
        xt = x[rs:re]
        hidden = x.new_empty((re - rs, f))
        for f0 in range(0, f, F_CHUNK):
            fc = min(F_CHUNK, f - f0)
            w_c = torch.cat([w_gu[e][:, f0:f0 + fc], w_gu[e][:, f + f0:f + f0 + fc]], dim=1)
            chunk = _mm_f32(xt, w_c).to(x.dtype)
            gu[rs:re, f0:f0 + fc] = chunk[:, :fc]
            gu[rs:re, f + f0:f + f0 + fc] = chunk[:, fc:]
            hidden[:, f0:f0 + fc] = _act(chunk, fc, x.dtype)
        for n0 in range(0, h, N_PASS):
            out[rs:re, n0:n0 + N_PASS] = _mm_f32(hidden, w_dn[e][:, n0:n0 + N_PASS]).to(x.dtype)
    return out, gu


def _act(gu: torch.Tensor, f: int, dtype) -> torch.Tensor:
    """bf16(silu(gate) * up) in f32 from the bf16 gu, as JAX's `act`."""
    gf = gu.float()
    return (F.silu(gf[:, :f]) * gf[:, f:]).to(dtype)


def fused_moe_mlp_plain(x, w_gu, w_dn, group_sizes):
    """Plain version of `_mlp_kernel`: an expert loop over the row ranges.
    x (M, H); w_gu (E, H, 2F); w_dn (E, F, H) -> (out (M, H), gu (M, 2F))
    in x.dtype; rows past the last group are zero. Reads the group sizes
    on the host; differentiable by autograd (no in-place writes)."""
    m = x.shape[0]
    f = w_dn.shape[1]
    outs, gus = [], []
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            gu_e = _mm_f32(x[start:start + n], w_gu[e]).to(x.dtype)
            gus.append(gu_e)
            outs.append(_mm_f32(_act(gu_e, f, x.dtype), w_dn[e]).to(x.dtype))
        start += n
    tail = m - start  # rows past the last group
    outs.append(x.new_zeros((tail, w_dn.shape[2])))
    gus.append(x.new_zeros((tail, 2 * f)))
    return torch.cat(outs), torch.cat(gus)


def fused_moe_mlp_fwd(x: torch.Tensor, w_gu: torch.Tensor, w_dn: torch.Tensor,
                      group_sizes: torch.Tensor):
    """The forward kernel (#16): (out (M, H), gu (M, 2F)) in x.dtype."""
    m, h = x.shape
    e, h2, f2 = w_gu.shape
    f = f2 // 2
    if h2 != h or f2 != 2 * f or w_dn.shape != (e, f, h) or group_sizes.shape != (e,):
        raise ValueError(f"fused_moe_mlp: x {tuple(x.shape)}, w_gu {tuple(w_gu.shape)}, "
                         f"w_dn {tuple(w_dn.shape)}, group_sizes {tuple(group_sizes.shape)} "
                         f"do not fit")
    if x.device.type == "cpu":
        return fused_moe_mlp_plain(x, w_gu, w_dn, group_sizes)
    for t in (w_gu, w_dn, group_sizes):
        if t.device != x.device:
            raise ValueError("fused_moe_mlp: operands on different devices")
    for t in (x, w_gu, w_dn):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fused_moe_mlp kernel: operand is {t.dtype}, want bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_moe_mlp kernel: operands must be contiguous and "
                             "16-byte aligned")
    if group_sizes.dtype != torch.int32:
        raise ValueError("fused_moe_mlp: group_sizes must be (E,) int32")
    if h % 128 or f % 64 or f > MAX_F or e > MAX_EXPERTS:
        raise ValueError(f"fused_moe_mlp kernel: H {h} must be a multiple of 128 and F {f} "
                         f"a multiple of 64 and at most {MAX_F} (the hidden slots, 128 x F "
                         f"per CTA, stay within L2), E {e} at most {MAX_EXPERTS}")
    out = torch.empty((m, h), dtype=x.dtype, device=x.device)
    gu = torch.empty((m, 2 * f), dtype=x.dtype, device=x.device)
    if m == 0:
        return out, gu  # nothing to launch
    from .cuda_lib import check, load

    # one hidden slot per CTA: the kernel's grid is min(SMs, an upper bound on its tiles)
    slots = min(torch.cuda.get_device_properties(x.device).multi_processor_count,
                m // TILE_M + e + 1)
    hid = torch.empty((slots * TILE_M, f), dtype=x.dtype, device=x.device)
    err = load().xt_fused_moe_mlp_bf16(
        x.data_ptr(), w_gu.data_ptr(), w_dn.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), gu.data_ptr(), hid.data_ptr(), slots, m, e, h, f,
        _tile_counter(x.device).data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "xt_fused_moe_mlp_bf16")
    fused_moe_mlp_fwd.launches += 1
    return out, gu


fused_moe_mlp_fwd.launches = 0  # kernel launches since the last reset
_TILE_COUNT: dict = {}  # device -> int64 (3,): what the kernel's CTAs walked


def _tile_counter(device) -> torch.Tensor:
    if device not in _TILE_COUNT:
        _TILE_COUNT[device] = torch.zeros(3, dtype=torch.int64, device=device)
    return _TILE_COUNT[device]


def fused_mlp_tiles_walked() -> tuple[int, int, int]:
    """(tiles with products, zero tiles, contraction chunks) the kernel's
    CTAs walked since the last `reset_launches()` (reads the device
    counters: synchronizes). `fused_mlp_plan_counts` says what one launch
    should walk."""
    walked = [0, 0, 0]
    for c in _TILE_COUNT.values():
        walked = [a + b for a, b in zip(walked, c.tolist())]
    return tuple(walked)


def reset_launches() -> None:
    fused_moe_mlp_fwd.launches = 0
    for c in _TILE_COUNT.values():
        c.zero_()


class _FusedMoEMLP(torch.autograd.Function):
    """JAX's custom VJP: residuals (x, w_gu, w_dn, gu, group_sizes)."""

    @staticmethod
    def forward(ctx, x, w_gu, w_dn, group_sizes):
        out, gu = fused_moe_mlp_fwd(x, w_gu.to(x.dtype).contiguous(),
                                    w_dn.to(x.dtype).contiguous(), group_sizes)
        ctx.save_for_backward(x, w_gu, w_dn, gu, group_sizes)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_gu, w_dn, gu, group_sizes = ctx.saved_tensors
        e, f = w_dn.shape[0], w_dn.shape[1]
        g = g.to(x.dtype).contiguous()
        hidden = _act(gu, f, g.dtype)
        # down GEMM: dhidden (#6 nt), dw_dn (#7)
        dhidden = grouped_gemm_bf16(g, w_dn.to(g.dtype).contiguous(), group_sizes,
                                    transpose_rhs=True)
        dw_dn = grouped_gemm_bf16_dw(hidden, g, group_sizes, e)
        # the activation's VJP in f32, rounded to gu's dtype
        gf = gu.float()
        gate, up = gf[:, :f], gf[:, f:]
        sig = torch.sigmoid(gate)
        dh = dhidden.float()
        dgu = torch.cat([dh * up * sig * (1 + gate * (1 - sig)), dh * gate * sig],
                        dim=1).to(gu.dtype)
        # gate|up GEMM: dx (#6 nt), dw_gu (#7)
        dx = grouped_gemm_bf16(dgu, w_gu.to(g.dtype).contiguous(), group_sizes,
                               transpose_rhs=True)
        dw_gu = grouped_gemm_bf16_dw(x, dgu, group_sizes, e)
        return dx.to(x.dtype), dw_gu.to(w_gu.dtype), dw_dn.to(w_dn.dtype), None


def fused_moe_mlp(x: torch.Tensor, w_gu: torch.Tensor, w_dn: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable fused expert MLP over expert-sorted rows: x (M, H);
    w_gu (E, H, 2F) fused gate|up; w_dn (E, F, H); group_sizes (E,) int32
    -> (M, H) in x.dtype. silu only (the activation the kernel computes)."""
    return _FusedMoEMLP.apply(x, w_gu, w_dn, group_sizes)
