"""Tile-wise fp8 grouped GEMMs of the MoE expert path (counterpart:
`xtuner_tpu/ops/fp8_grouped.py`: `quantize_blockwise_stack`,
`quantize_rowtile`, `fp8_grouped_gemm` (`_gg_kernel`, TPU kernel #12),
`fp8_grouped_gemm_dw` (`_dw_kernel`, #13) and the custom VJP
`fp8_grouped_linear`).

Rows arrive sorted by expert; `group_sizes` (E,) int32 stays on the device.
On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/fp8_grouped.cu`) or raises; on a CPU tensor it runs the plain
version beside it, a per-expert loop over f32-dequantised operands. The
kernels find their experts from device offsets, so the TPU wrapper's visit
table (`build_visit_table`) and its 256-row padding are not needed; the
wgrad's 128-row quantisation tiles start at row 0 and may straddle experts,
and a zero-padded M is part of that quantisation, so M is padded to a 128
multiple there (zero rows change no tile's amax).

Operand layouts. The fp8 tensor cores take both operands K-major. The
forward and dgrad weights are laid out (E, N_out, K_contract) by the
wrapper (E K N bytes read and written per call); the wgrad's two operands,
which contract over rows, are laid out row-contiguous in 128-row tiles,
(M/128, K, 128) and (M/128, N, 128) (M (K + N) bytes read and written per
call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bf16_grouped import _offsets
from .fp8_gemm import (_FP8_CODE, _OUT_CODE, check_aligned, check_fp8_operands,
                       dequantize_blockwise, dequantize_tilewise, k_major, quantise,
                       quantize_tilewise)


def quantize_blockwise_stack(w: torch.Tensor, tile: int = 128, dtype=torch.float8_e4m3fn,
                             eps: float = 1e-12):
    """w (E, K, N) -> (q (E, K, N) fp8, scale (E, K/tile, N/tile) f32)."""
    e, k, n = w.shape
    if k % tile or n % tile:
        raise ValueError(f"quantize_blockwise_stack: ({k}, {n}) is not in {tile}-blocks")
    q, scale = quantise(w.reshape(e, k // tile, tile, n // tile, tile), (2, 4), dtype, eps)
    return q.reshape(e, k, n), scale[:, :, 0, :, 0]


def quantize_rowtile(x: torch.Tensor, tile: int = 128, dtype=torch.float8_e4m3fn,
                     eps: float = 1e-12):
    """x (M, K) -> (q fp8, scale (M/tile, 1) f32): one scale per 128-row
    tile, the quantisation the wgrad's contraction over rows needs."""
    m, k = x.shape
    if m % tile:
        raise ValueError(f"quantize_rowtile: M {m} is not a multiple of {tile}")
    q, scale = quantise(x.reshape(m // tile, tile, k), (1, 2), dtype, eps)
    return q.reshape(m, k), scale[:, 0, :]


def dequantize_rowtile(q: torch.Tensor, scale: torch.Tensor, tile: int = 128):
    m, k = q.shape
    return (q.float().reshape(m // tile, tile, k) * scale[:, :, None]).reshape(m, k)


def fp8_grouped_gemm_plain(xq, sx, wq, sw, group_sizes, *, tile: int = 128,
                           out_dtype=torch.bfloat16):
    """Plain version of `_gg_kernel`: per expert, the f32 product of the
    dequantised rows and weights; rows past the last group are zero. Reads
    the group sizes on the host."""
    xd = dequantize_tilewise(xq, sx, tile)
    wd = dequantize_blockwise(wq, sw, tile)
    out = torch.zeros((xq.shape[0], wq.shape[2]), dtype=out_dtype, device=xq.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = (xd[start:start + n] @ wd[e]).to(out_dtype)
        start += n
    return out


def fp8_grouped_gemm_dw_plain(xq_m, sx_m, dyq_m, sy_m, group_sizes, num_experts: int,
                              *, tile: int = 128):
    """Plain version of `_dw_kernel`: dw[e] = x_e^T dy_e over the
    dequantised rows of expert e, f32; zero for an empty expert."""
    xd = dequantize_rowtile(xq_m, sx_m, tile)
    yd = dequantize_rowtile(dyq_m, sy_m, tile)
    dw = torch.zeros((num_experts, xq_m.shape[1], dyq_m.shape[1]), dtype=torch.float32,
                     device=xq_m.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            dw[e] = xd[start:start + n].T @ yd[start:start + n]
        start += n
    return dw


def _row_tiles_k_major(q: torch.Tensor, tile: int) -> torch.Tensor:
    """(M, K) codes -> contiguous (M/tile, K, tile) uint8: each 128-row
    tile transposed, its rows contiguous."""
    m, k = q.shape
    return k_major(q.reshape(m // tile, tile, k))


def _check_sizes(name, group_sizes, num_experts, dev):
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (num_experts,):
        raise ValueError(f"{name}: group_sizes must be ({num_experts},) int32")
    if group_sizes.device != dev:
        raise ValueError(f"{name}: group_sizes on {group_sizes.device}, operands on {dev}")


def fp8_grouped_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     group_sizes: torch.Tensor, *, tile: int = 128,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq (M, K) fp8 rows sorted by expert, sx (M, K/tile) f32; wq (E, K, N)
    fp8, sw (E, K/tile, N/tile) f32; group_sizes (E,) int32 -> (M, N)
    out_dtype, each row through its own expert's weights; rows past the
    last group are zero."""
    m, k = xq.shape
    e, k2, n = wq.shape
    if k2 != k or k % tile or n % tile or sx.shape != (m, k // tile) \
            or sw.shape != (e, k // tile, n // tile):
        raise ValueError(f"fp8_grouped_gemm: xq {tuple(xq.shape)}, sx {tuple(sx.shape)}, "
                         f"wq {tuple(wq.shape)}, sw {tuple(sw.shape)} do not fit tile {tile}")
    _check_sizes("fp8_grouped_gemm", group_sizes, e, xq.device)
    if xq.device.type == "cpu":
        return fp8_grouped_gemm_plain(xq, sx, wq, sw, group_sizes, tile=tile,
                                      out_dtype=out_dtype)
    check_fp8_operands("fp8_grouped_gemm", tile, (xq, sx), (wq, sw))
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"fp8_grouped_gemm kernel: out_dtype {out_dtype}, want bf16 or f32")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    from .cuda_lib import check, load

    xc, sxc, wt, swc = xq.contiguous(), sx.contiguous(), k_major(wq), sw.contiguous()
    offs = _offsets(group_sizes)
    check_aligned("fp8_grouped_gemm", xc, wt)
    err = load().xt_fp8_grouped_gemm(
        xc.data_ptr(), sxc.data_ptr(), wt.data_ptr(), swc.data_ptr(), offs.data_ptr(),
        out.data_ptr(), m, k, n, e, _FP8_CODE[xq.dtype], _FP8_CODE[wq.dtype],
        _OUT_CODE[out_dtype], torch.cuda.current_stream(xq.device).cuda_stream)
    check(err, "xt_fp8_grouped_gemm")
    fp8_grouped_gemm.launches += 1
    return out


def fp8_grouped_gemm_dw(xq_m: torch.Tensor, sx_m: torch.Tensor, dyq_m: torch.Tensor,
                        sy_m: torch.Tensor, group_sizes: torch.Tensor, num_experts: int,
                        *, tile: int = 128) -> torch.Tensor:
    """wgrad: dw[e] = sum over 128-row tiles r of (x_r^T dy_r) sx[r] sy[r],
    restricted to expert e's rows. xq_m (M, K) and dyq_m (M, N) fp8 with
    one scale per 128-row tile, (M/tile, 1) f32 -> (E, K, N) f32, zero for
    an empty expert."""
    m, k = xq_m.shape
    m2, n = dyq_m.shape
    mt = m // tile
    if m2 != m or m % tile or k % tile or n % tile or sx_m.shape != (mt, 1) \
            or sy_m.shape != (mt, 1):
        raise ValueError(f"fp8_grouped_gemm_dw: xq_m {tuple(xq_m.shape)}, dyq_m "
                         f"{tuple(dyq_m.shape)}, scales {tuple(sx_m.shape)}, "
                         f"{tuple(sy_m.shape)} do not fit tile {tile}")
    _check_sizes("fp8_grouped_gemm_dw", group_sizes, num_experts, xq_m.device)
    if xq_m.device.type == "cpu":
        return fp8_grouped_gemm_dw_plain(xq_m, sx_m, dyq_m, sy_m, group_sizes, num_experts,
                                         tile=tile)
    check_fp8_operands("fp8_grouped_gemm_dw", tile, (xq_m, sx_m), (dyq_m, sy_m))
    from .cuda_lib import check, load

    # both operands contract over rows: row-contiguous, one 128-row tile at a time
    xt, yt = _row_tiles_k_major(xq_m, tile), _row_tiles_k_major(dyq_m, tile)
    sxc, syc = sx_m.contiguous(), sy_m.contiguous()
    offs = _offsets(group_sizes)
    check_aligned("fp8_grouped_gemm_dw", xt, yt)
    dw = torch.empty((num_experts, k, n), dtype=torch.float32, device=xq_m.device)
    err = load().xt_fp8_grouped_dw(
        xt.data_ptr(), sxc.data_ptr(), yt.data_ptr(), syc.data_ptr(), offs.data_ptr(),
        dw.data_ptr(), m, k, n, num_experts, _FP8_CODE[xq_m.dtype], _FP8_CODE[dyq_m.dtype],
        torch.cuda.current_stream(xq_m.device).cuda_stream)
    check(err, "xt_fp8_grouped_dw")
    fp8_grouped_gemm_dw.launches += 1
    return dw


fp8_grouped_gemm.launches = 0  # kernel launches since the last reset
fp8_grouped_gemm_dw.launches = 0


def reset_launches() -> None:
    fp8_grouped_gemm.launches = 0
    fp8_grouped_gemm_dw.launches = 0


def _pad_rows(x: torch.Tensor, mult: int = 128) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    return F.pad(x, (0, 0, 0, pad)) if pad else x


class _Fp8GroupedLinear(torch.autograd.Function):
    """JAX's `_fgl_fwd` / `_fgl_bwd` step for step."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, e5m2_grads):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.e5m2_grads = e5m2_grads
        xq, sx = quantize_tilewise(x)
        wq, sw = quantize_blockwise_stack(w)
        return fp8_grouped_gemm(xq, sx, wq, sw, group_sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, group_sizes = ctx.saved_tensors
        g_dtype = torch.float8_e5m2 if ctx.e5m2_grads else torch.float8_e4m3fn
        # dgrad: dy (M, N) x w^T (E, N, K)
        gq, sg = quantize_tilewise(g, dtype=g_dtype)
        wtq, swt = quantize_blockwise_stack(w.transpose(1, 2))
        dx = fp8_grouped_gemm(gq, sg, wtq, swt, group_sizes)
        # wgrad: per-expert x_e^T dy_e, operands re-quantised along 128-row tiles
        xq_m, sx_m = quantize_rowtile(_pad_rows(x))
        gq_m, sg_m = quantize_rowtile(_pad_rows(g), dtype=g_dtype)
        dw = fp8_grouped_gemm_dw(xq_m, sx_m, gq_m, sg_m, group_sizes, w.shape[0])
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def fp8_grouped_linear(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                       e5m2_grads: bool = False) -> torch.Tensor:
    """Differentiable tile-wise fp8 grouped linear: x (M, K) rows sorted by
    expert, w (E, K, N) -> (M, N) bf16. All three GEMMs run in fp8: forward
    e4m3 x e4m3; dgrad (e5m2 or e4m3) x e4m3; wgrad re-quantised along
    128-row tiles. dx comes back in x's dtype, dw in w's."""
    return _Fp8GroupedLinear.apply(x, w, group_sizes, e5m2_grads)
