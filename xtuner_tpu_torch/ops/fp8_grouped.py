"""Tile-wise fp8 grouped GEMMs of the MoE expert path (counterpart:
`xtuner_tpu/ops/fp8_grouped.py`: `quantize_blockwise_stack`,
`quantize_rowtile`, `fp8_grouped_gemm` (`_gg_kernel`, TPU kernel #12),
`fp8_grouped_gemm_dw` (`_dw_kernel`, #13) and the custom VJP
`fp8_grouped_linear`).

Rows arrive sorted by expert; `group_sizes` (E,) int32 stays on the device.
On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/fp8_grouped.cu`, one persistent wgmma/TMA kernel with a promotion
per 128-deep scale step) or raises; on a CPU tensor it runs the plain
version beside it, a per-expert loop over f32-dequantised operands. The
kernel scans the group sizes itself, so the TPU wrapper's visit table
(`build_visit_table`) and its 256-row padding are not needed; the wgrad's
128-row quantisation tiles start at row 0 and may straddle experts, and a
zero-padded M is part of that quantisation, so M is padded to a 128
multiple there (zero rows change no tile's amax).

Operand layouts. The fp8 tensor cores take both operands K-major. The
forward and dgrad weights are laid out (E, N_out, K_contract) by the
wrapper (E K N bytes read and written per call); the wgrad's two operands,
which contract over rows, are laid out row-contiguous in 128-row tiles,
(M/128, K, 128) and (M/128, N, 128) (M (K + N) bytes read and written per
call). `fp8_grouped_gemm_launch` and `fp8_grouped_dw_launch` launch the
kernel on operands already so laid out (the tools time them alone).

The kernels' work orders in plain torch, for tests and `chip_smoke.py`
only: `fp8_grouped_tiled_plain` walks `grouped_tile_plan`'s expert-pure
128-row tiles in 128-deep steps with a promotion per step;
`fp8_dw_walk_plain` walks `fp8_dw_items` (the global row tiles of each
wgrad item) and zeroes the codes of a straddling tile through the
kernel's byte masks (`swizzle_128b`, `straddle_keep`). `fp8_plan_counts`
says what one launch walks, as the kernels' device counters sum it
(`fp8_grouped_walked`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bf16_grouped import MAX_EXPERTS, grouped_tile_plan
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


TILE = 128  # the kernel's tile rows and columns and its scale step's depth


def _row_tiles_k_major(q: torch.Tensor, tile: int) -> torch.Tensor:
    """(M, K) codes -> contiguous (M/tile, K, tile) codes: each 128-row
    tile transposed, its rows contiguous."""
    m, k = q.shape
    return k_major(q.reshape(m // tile, tile, k)).view(q.dtype)


def _check_sizes(name, group_sizes, num_experts, dev):
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (num_experts,):
        raise ValueError(f"{name}: group_sizes must be ({num_experts},) int32")
    if group_sizes.device != dev:
        raise ValueError(f"{name}: group_sizes on {group_sizes.device}, operands on {dev}")


def _check_launch(name, codes, scales, group_sizes, num_experts) -> None:
    """What a launch takes, checked before its pointers reach the kernel:
    fp8 codes and f32 scales, contiguous, on one CUDA device, 16-byte
    aligned codes, (E,) int32 group sizes there, E <= MAX_EXPERTS."""
    dev = codes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: operands on {dev}, want a CUDA device")
    if any(q.dtype not in _FP8_CODE for q in codes) or \
            any(t.dtype != torch.float32 for t in scales):
        raise ValueError(f"{name} kernel: want fp8 codes (e4m3fn or e5m2) with float32 scales")
    if any(t.device != dev or not t.is_contiguous() for t in (*codes, *scales)):
        raise ValueError(f"{name} kernel: operands must be contiguous and on one device")
    _check_sizes(name, group_sizes, num_experts, dev)
    if num_experts > MAX_EXPERTS:
        raise ValueError(f"{name} kernel: {num_experts} experts, at most {MAX_EXPERTS}")
    check_aligned(name, *codes)


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
    return fp8_grouped_gemm_launch(xq.contiguous(), sx.contiguous(),
                                   k_major(wq).view(wq.dtype), sw.contiguous(),
                                   group_sizes, out_dtype)


def fp8_grouped_gemm_launch(xq: torch.Tensor, sx: torch.Tensor, wt: torch.Tensor,
                            sw: torch.Tensor, group_sizes: torch.Tensor,
                            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch #12 on operands in its layout: xq (M, K) fp8 codes, sx (M,
    K/128) f32, wt (E, N, K) fp8 codes (each expert's W K-major), sw (E,
    K/128, N/128) f32, all contiguous on one card -> (M, N) out_dtype."""
    m, k = xq.shape
    e, n, k2 = wt.shape
    if k2 != k or k % TILE or n % TILE or sx.shape != (m, k // TILE) \
            or sw.shape != (e, k // TILE, n // TILE):
        raise ValueError(f"fp8_grouped_gemm kernel: xq {tuple(xq.shape)}, sx {tuple(sx.shape)}, "
                         f"wt {tuple(wt.shape)}, sw {tuple(sw.shape)} do not fit its layout")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"fp8_grouped_gemm kernel: out_dtype {out_dtype}, want bf16 or f32")
    _check_launch("fp8_grouped_gemm", (xq, wt), (sx, sw), group_sizes, e)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    from .cuda_lib import check, load

    gs = group_sizes.contiguous()
    err = load().xt_fp8_grouped_gemm(
        xq.data_ptr(), sx.data_ptr(), wt.data_ptr(), sw.data_ptr(), gs.data_ptr(),
        out.data_ptr(), _walk_counter(xq.device, "gg").data_ptr(), m, k, n, e,
        _FP8_CODE[xq.dtype], _FP8_CODE[wt.dtype], _OUT_CODE[out_dtype],
        torch.cuda.current_stream(xq.device).cuda_stream)
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
    # both operands contract over rows: row-contiguous, one 128-row tile at a time
    return fp8_grouped_dw_launch(_row_tiles_k_major(xq_m, tile), sx_m.contiguous(),
                                 _row_tiles_k_major(dyq_m, tile), sy_m.contiguous(),
                                 group_sizes, num_experts)


def fp8_grouped_dw_launch(xt: torch.Tensor, sx: torch.Tensor, yt: torch.Tensor,
                          sy: torch.Tensor, group_sizes: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Launch #13 on operands in its layout: xt (Mp/128, K, 128) and yt
    (Mp/128, N, 128) fp8 codes (`_row_tiles_k_major`), sx and sy (Mp/128, 1)
    f32, all contiguous on one card -> (E, K, N) f32."""
    mt, k, tx = xt.shape
    mt2, n, ty = yt.shape
    if (mt2, tx, ty) != (mt, TILE, TILE) or k % TILE or n % TILE or sx.shape != (mt, 1) \
            or sy.shape != (mt, 1):
        raise ValueError(f"fp8_grouped_gemm_dw kernel: xt {tuple(xt.shape)}, yt "
                         f"{tuple(yt.shape)}, scales {tuple(sx.shape)}, {tuple(sy.shape)} do "
                         f"not fit its layout")
    _check_launch("fp8_grouped_gemm_dw", (xt, yt), (sx, sy), group_sizes, num_experts)
    from .cuda_lib import check, load

    gs = group_sizes.contiguous()
    dw = torch.empty((num_experts, k, n), dtype=torch.float32, device=xt.device)
    err = load().xt_fp8_grouped_dw(
        xt.data_ptr(), sx.data_ptr(), yt.data_ptr(), sy.data_ptr(), gs.data_ptr(),
        dw.data_ptr(), _walk_counter(xt.device, "dw").data_ptr(), mt * TILE, k, n,
        num_experts, _FP8_CODE[xt.dtype], _FP8_CODE[yt.dtype],
        torch.cuda.current_stream(xt.device).cuda_stream)
    check(err, "xt_fp8_grouped_dw")
    fp8_grouped_gemm_dw.launches += 1
    return dw


fp8_grouped_gemm.launches = 0  # kernel launches since the last reset
fp8_grouped_gemm_dw.launches = 0
_KINDS = ("gg", "dw")
_WALK: dict = {}  # device -> int64 (2, 3): per kernel, what its CTAs walked


def _walk_counter(device, kind: str) -> torch.Tensor:
    if device not in _WALK:
        _WALK[device] = torch.zeros((len(_KINDS), 3), dtype=torch.int64, device=device)
    return _WALK[device][_KINDS.index(kind)]


def fp8_grouped_walked() -> dict:
    """"gg" (#12) and "dw" (#13) -> (items with products, zero items, scale
    steps) the kernels' CTAs walked since the last `reset_launches()`
    (reads the device counters: synchronizes). `fp8_plan_counts` says what
    one launch should walk."""
    walked = {kind: (0, 0, 0) for kind in _KINDS}
    for c in _WALK.values():
        for kind, row in zip(_KINDS, c.tolist()):
            walked[kind] = tuple(a + b for a, b in zip(walked[kind], row))
    return walked


def reset_launches() -> None:
    fp8_grouped_gemm.launches = 0
    fp8_grouped_gemm_dw.launches = 0
    for c in _WALK.values():
        c.zero_()


# ------------------------------------------------ the kernels' work orders
def swizzle_128b(row, j):
    """Byte offset, in 128-byte shared-memory row `row` of a 1024-byte-aligned
    tile, of the code at M position j (0..127), as TMA writes a box under
    CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk (j / 16) ^ (row % 8), byte j % 16."""
    return 16 * ((j // 16) ^ (row % 8)) + j % 16


def straddle_keep(rows: int, lo: int, hi: int) -> torch.Tensor:
    """(rows, 128) bool over (smem row, M position): the codes #13 keeps in
    a straddling row tile whose expert rows are positions [lo, hi). Built as
    the kernel's `mask_row` builds it, chunk by chunk of the swizzled row
    (chunk q of row p holds positions 16 (q ^ (p % 8)) ..), then read back
    through `swizzle_128b`; equal to lo <= j < hi in every row when the two
    agree."""
    p = torch.arange(rows)[:, None, None]
    q = torch.arange(8)[None, :, None]
    pos = 16 * (q ^ (p % 8)) + torch.arange(16)[None, None, :]  # (rows, 8, 16)
    phys = ((pos >= lo) & (pos < hi)).reshape(rows, TILE)
    j = torch.arange(TILE)[None, :]
    return torch.gather(phys, 1, swizzle_128b(torch.arange(rows)[:, None], j).expand(rows, -1))


def _row_bounds(group_sizes: torch.Tensor, m: int):
    sizes = group_sizes.to(torch.int64).cpu().clamp(min=0)
    ends = torch.cumsum(sizes, 0).clamp(max=m)
    return torch.cat([ends.new_zeros(1), ends[:-1]]), ends


def fp8_dw_items(group_sizes: torch.Tensor, m: int, k: int, n: int) -> dict:
    """#13's work list in its order: one item per (expert, 128-row K tile,
    128-column N tile), experts by falling row count (ties by index). Each
    item walks `steps` global 128-row tiles from `t0`, those that overlap
    the expert's rows [rs, re) (offsets clamped to m); an empty expert's
    items have 0 steps and are stored as zeros. -> dict of int64 tensors
    expert, k0, n0, rs, re, t0, steps."""
    rs, re = _row_bounds(group_sizes, m)
    rows = re - rs
    order = torch.sort(-rows, stable=True).indices
    per = (k // TILE) * (n // TILE)
    expert = order.repeat_interleave(per)
    idx = torch.arange(per).repeat(len(order))
    t0 = rs[expert] // TILE
    steps = torch.where(rows[expert] > 0, (re[expert] - 1) // TILE - t0 + 1, 0)
    return {"expert": expert, "k0": (idx // (n // TILE)) * TILE, "n0": (idx % (n // TILE)) * TILE,
            "rs": rs[expert], "re": re[expert], "t0": t0, "steps": steps}


def fp8_plan_counts(group_sizes: torch.Tensor, m: int, kind: str, k: int,
                    n: int) -> tuple[int, int, int]:
    """What one launch walks, as the kernel's device counter sums it: (items
    with products, zero items, scale steps). "gg": xq (m, k) -> (m, n), items
    `grouped_tile_plan`'s tiles times the n / 128 column tiles, k / 128
    steps each; "dw": dW (E, k, n) over m rows, `fp8_dw_items`."""
    if kind == "dw":
        steps = fp8_dw_items(group_sizes, m, k, n)["steps"]
        busy = int((steps > 0).sum())
        return busy, len(steps) - busy, int(steps.sum())
    expert = grouped_tile_plan(group_sizes.cpu(), m)[0]
    busy = int((expert >= 0).sum())
    return busy * (n // TILE), (len(expert) - busy) * (n // TILE), busy * (n // TILE) * (k // TILE)


def fp8_grouped_tiled_plain(xq, sx, wq, sw, group_sizes, *, out_dtype=torch.float32):
    """#12 in its order, in plain torch: per tile of `grouped_tile_plan`
    (expert-pure, 128 rows at most), per 128-deep step t the f32 product
    of the codes (exact), promoted as acc + part * (sx[row, t] sw[e, t, n /
    128]); rows of zero tiles are zero."""
    m, k = xq.shape
    n = wq.shape[2]
    xf, wf = xq.float(), wq.float()
    out = torch.zeros((m, n), dtype=out_dtype, device=xq.device)
    for e, r0, r1 in zip(*(t.tolist() for t in grouped_tile_plan(group_sizes.cpu(), m))):
        if e < 0:
            continue
        acc = torch.zeros((r1 - r0, n), dtype=torch.float32, device=xq.device)
        for t in range(k // TILE):
            ks = slice(TILE * t, TILE * (t + 1))
            part = xf[r0:r1, ks] @ wf[e, ks]
            acc = acc + part * (sx[r0:r1, t, None] * sw[e, t].repeat_interleave(TILE)[None])
        out[r0:r1] = acc.to(out_dtype)
    return out


def fp8_dw_walk_plain(xq_m, sx_m, dyq_m, sy_m, group_sizes, num_experts: int):
    """#13 in its order, in plain torch: per expert, the global 128-row
    tiles of `fp8_dw_items`, each a fresh f32 product of the codes (exact)
    with the codes outside the expert's rows zeroed through the kernel's
    byte masks (`straddle_keep`), promoted as acc + part * (sx[r] sy[r]).
    The items' K and N tiles are one product here: no sum crosses them."""
    m, k = xq_m.shape
    n = dyq_m.shape[1]
    xf, yf = xq_m.float(), dyq_m.float()
    dw = torch.zeros((num_experts, k, n), dtype=torch.float32, device=xq_m.device)
    rs_all, re_all = _row_bounds(group_sizes, m)
    for e in range(num_experts):
        rs, re = int(rs_all[e]), int(re_all[e])
        if re <= rs:
            continue
        for r in range(rs // TILE, (re - 1) // TILE + 1):
            rows = slice(TILE * r, TILE * (r + 1))
            xt, yt = xf[rows].T, yf[rows].T  # (K, 128), (N, 128): the kernel's smem rows
            lo, hi = rs - TILE * r, re - TILE * r
            if lo > 0 or hi < TILE:
                keep = straddle_keep(TILE, lo, hi).to(xf.device)
                xt = xt * keep[torch.arange(k) % TILE]
                yt = yt * keep[torch.arange(n) % TILE]
            dw[e] = dw[e] + (xt @ yt.T) * (sx_m[r, 0] * sy_m[r, 0])
    return dw


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
