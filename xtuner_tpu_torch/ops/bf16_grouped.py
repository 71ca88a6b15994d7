"""Ragged grouped GEMMs of the MoE expert path (counterpart:
`xtuner_tpu/ops/bf16_grouped.py`: `grouped_gemm_bf16` (`_gg_kernel`, "nn"
and "nt"), `grouped_gemm_bf16_dw` (`_dw_kernel`) and the custom VJP
`bf16_grouped_linear`).

Rows arrive sorted by expert; `group_sizes` (E,) int32 gives each expert's
row count and stays on the device. On a CUDA tensor each wrapper launches
its hand-written Hopper kernel (`csrc/grouped_gemm.cu`) or raises; on a CPU
tensor it runs the plain version beside it, an expert loop of `torch.mm`
over the row ranges (like `xtuner_tpu/ops/moe.py::grouped_gemm_reference`),
in the inputs' dtype with an f32 product (`_mm_f32`). The TPU wrapper's 512-row
padding of M and its visit table are TPU artefacts and are not needed: the
kernel reads the sizes and builds its own work list on the device
(`grouped_tile_plan` is that list in plain torch, for tests and counts).
"""

from __future__ import annotations

import torch


MAX_EXPERTS = 256  # the kernel's limit: DeepSeek-V3's routed experts, the most of any preset
TILE_M = 128  # rows of a kernel tile (nn/nt: output rows; dw: rows of dW)
CHUNK = 64  # depth of one contraction chunk of the kernel's ring


def _block_n(n_out: int) -> int:
    """The output columns of a kernel tile, as the kernel picks them."""
    return 128 if n_out <= 128 else 256


def _ceil(a, b):
    return -(-a // b)


def grouped_tile_plan(group_sizes: torch.Tensor, m: int, tile: int = TILE_M):
    """The nn/nt kernel's M tiles, in its order: each expert's rows
    [offs[e], offs[e + 1]) (offsets clamped to m) cut into ceil(n_e / tile)
    tiles that start at the expert's first row, then the rows past the last
    group, [offs[E], m), as zero tiles. Returns (expert, row_start, row_end),
    int64 tensors with expert -1 for a zero tile. Each tile runs once per
    block of output columns (`_block_n`). For counts and tests; the main
    path never calls it."""
    sizes = group_sizes.to(torch.int64).clamp(min=0)
    ends = torch.cumsum(sizes, 0).clamp(max=m)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    tiles = _ceil(ends - starts, tile)
    expert = torch.repeat_interleave(torch.arange(len(sizes), device=sizes.device), tiles)
    first = torch.cumsum(tiles, 0) - tiles
    j = torch.arange(len(expert), device=sizes.device) - first[expert]
    rs = starts[expert] + tile * j
    re = torch.minimum(rs + tile, ends[expert])
    last = int(ends[-1]) if len(ends) else 0
    zs = last + tile * torch.arange(_ceil(m - last, tile), device=sizes.device)
    return (torch.cat([expert, torch.full_like(zs, -1)]), torch.cat([rs, zs]),
            torch.cat([re, torch.clamp(zs + tile, max=m)]))


def grouped_plan_counts(group_sizes: torch.Tensor, m: int, kind: str, k: int,
                        n: int) -> tuple[int, int, int]:
    """What one kernel launch walks, as its device counter sums it: (items
    with products, zero items, contraction chunks). kind "nn": x (m, k) @
    w (E, k, n); "nt": x (m, n) @ w^T; "dw": dW (E, k, n). nn/nt items are
    `grouped_tile_plan`'s tiles times the column blocks; dw items are
    (expert, 128-row K tile, column block), zero for an empty expert."""
    if kind == "dw":
        sizes = group_sizes.to(torch.int64).clamp(min=0)
        ends = torch.cumsum(sizes, 0).clamp(max=m)
        rows = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
        per = _ceil(k, TILE_M) * _ceil(n, _block_n(n))
        busy = int((rows > 0).sum())
        return (busy * per, (len(rows) - busy) * per,
                int(_ceil(rows, CHUNK).sum()) * per)
    c, n_out = (k, n) if kind == "nn" else (n, k)
    expert = grouped_tile_plan(group_sizes, m)[0]
    blocks = _ceil(n_out, _block_n(n_out))
    busy = int((expert >= 0).sum())
    return busy * blocks, (len(expert) - busy) * blocks, busy * blocks * _ceil(c, CHUNK)


def _mm_f32(a, b):
    """a @ b with an f32 result: bf16 operands on the card go to
    `torch.mm(..., out_dtype=float32)`; elsewhere both are upcast."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def grouped_gemm_plain(x, w, group_sizes, transpose_rhs: bool = False,
                       out_dtype=None):
    """Plain version of `_gg_kernel`: out[rows of e] = x[rows of e] @ w[e]
    (or @ w[e]^T); rows past the last group are zero. Reads the group
    sizes on the host."""
    out_dtype = out_dtype or x.dtype
    n_out = w.shape[1] if transpose_rhs else w.shape[2]
    out = torch.zeros((x.shape[0], n_out), dtype=out_dtype, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            we = w[e].T if transpose_rhs else w[e]
            out[start:start + n] = _mm_f32(x[start:start + n], we).to(out_dtype)
        start += n
    return out


def grouped_gemm_dw_plain(x, dy, group_sizes, num_experts: int):
    """Plain version of `_dw_kernel`: dw[e] = x_e^T @ dy_e in f32, zero for
    an empty expert. Reads the group sizes on the host."""
    dw = torch.zeros((num_experts, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            dw[e] = _mm_f32(x[start:start + n].T, dy[start:start + n])
        start += n
    return dw


def _check(name, group_sizes, *tensors):
    dev = tensors[0].device
    for t in (*tensors, group_sizes):
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: operand is {t.dtype}, want bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: operands must be contiguous and 16-byte aligned")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1:
        raise ValueError(f"{name}: group_sizes must be (E,) int32")
    if group_sizes.shape[0] > MAX_EXPERTS:
        raise ValueError(f"{name} kernel: {group_sizes.shape[0]} experts, at most "
                         f"{MAX_EXPERTS} experts")


def grouped_gemm_bf16(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                      *, transpose_rhs: bool = False) -> torch.Tensor:
    """x (M, C) rows sorted by expert; w (E, K, N); group_sizes (E,) int32.

    transpose_rhs=False: C == K, returns (M, N) = x @ w[e]     ("nn", fwd)
    transpose_rhs=True:  C == N, returns (M, K) = x @ w[e]^T   ("nt", dgrad)
    in x.dtype; rows past the last group are zero."""
    m, c = x.shape
    e, k, n = w.shape
    if c != (n if transpose_rhs else k) or group_sizes.shape != (e,):
        raise ValueError(f"grouped_gemm_bf16: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}, "
                         f"transpose_rhs={transpose_rhs} do not fit")
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, group_sizes, transpose_rhs)
    _check("grouped_gemm_bf16", group_sizes, x, w)
    n_out = k if transpose_rhs else n
    if c % 32 or n_out % 8:
        raise ValueError(f"grouped_gemm_bf16 kernel: contraction {c} must be a multiple "
                         f"of 32 and output width {n_out} of 8")
    out = torch.empty((m, n_out), dtype=x.dtype, device=x.device)
    if m == 0:
        return out  # nothing to launch
    from .cuda_lib import check, load

    kind = "nt" if transpose_rhs else "nn"
    err = load().xt_grouped_gemm_bf16(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        m, c, e, k, n, int(transpose_rhs), _tile_counter(x.device, kind).data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "xt_grouped_gemm_bf16")
    grouped_gemm_bf16.launches[kind] += 1
    return out


def grouped_gemm_bf16_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """wgrad: dw[e] = x_e^T @ dy_e over ragged expert rows; x (M, K), dy
    (M, N) expert-sorted -> (E, K, N) f32, zero for an empty expert."""
    m, k = x.shape
    if dy.shape[0] != m or group_sizes.shape != (num_experts,):
        raise ValueError(f"grouped_gemm_bf16_dw: x {tuple(x.shape)}, dy {tuple(dy.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)} do not fit")
    if x.device.type == "cpu":
        return grouped_gemm_dw_plain(x, dy, group_sizes, num_experts)
    _check("grouped_gemm_bf16_dw", group_sizes, x, dy)
    n = dy.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"grouped_gemm_bf16_dw kernel: K {k} and N {n} must be "
                         f"multiples of 16")
    from .cuda_lib import check, load

    dw = torch.empty((num_experts, k, n), dtype=torch.float32, device=x.device)
    err = load().xt_grouped_gemm_dw_bf16(
        x.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), dw.data_ptr(),
        m, num_experts, k, n, _tile_counter(x.device, "dw").data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "xt_grouped_gemm_dw_bf16")
    grouped_gemm_bf16_dw.launches += 1
    return dw


grouped_gemm_bf16.launches = {"nn": 0, "nt": 0}  # kernel launches since the last reset
grouped_gemm_bf16_dw.launches = 0
_KINDS = ("nn", "nt", "dw")
_TILE_COUNT: dict = {}  # device -> int64 (3, 3): per kind, what its CTAs walked


def _tile_counter(device, kind: str) -> torch.Tensor:
    if device not in _TILE_COUNT:
        _TILE_COUNT[device] = torch.zeros((len(_KINDS), 3), dtype=torch.int64, device=device)
    return _TILE_COUNT[device][_KINDS.index(kind)]


def grouped_tiles_walked() -> dict:
    """kind -> (items with products, zero items, contraction chunks) the
    kernels' CTAs walked since the last `reset_launches()` (reads the device
    counters: synchronizes). `grouped_plan_counts` says what one launch
    should walk."""
    walked = {kind: [0, 0, 0] for kind in _KINDS}
    for c in _TILE_COUNT.values():
        for kind, row in zip(_KINDS, c.tolist()):
            walked[kind] = [a + b for a, b in zip(walked[kind], row)]
    return {kind: tuple(v) for kind, v in walked.items()}


def reset_launches() -> None:
    grouped_gemm_bf16.launches = {"nn": 0, "nt": 0}
    grouped_gemm_bf16_dw.launches = 0
    for c in _TILE_COUNT.values():
        c.zero_()


class _GroupedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return grouped_gemm_bf16(x, w.to(x.dtype), group_sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, group_sizes = ctx.saved_tensors
        g = g.contiguous()
        dx = grouped_gemm_bf16(g, w.to(g.dtype), group_sizes, transpose_rhs=True)
        dw = grouped_gemm_bf16_dw(x, g, group_sizes, w.shape[0])
        return dx.to(x.dtype), dw.to(w.dtype), None


def bf16_grouped_linear(x: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable grouped linear over expert-sorted rows: x (M, K),
    w (E, K, N) -> (M, N) in x.dtype; forward "nn", dgrad "nt", wgrad the dw
    kernel (f32, cast to w.dtype as the JAX VJP does)."""
    return _GroupedLinear.apply(x, w, group_sizes)
