"""Tile-wise fp8 GEMM (counterpart: `xtuner_tpu/ops/fp8_gemm.py`: the
quantisers `quantize_tilewise` and `quantize_blockwise`, and
`fp8_gemm_tilewise`, whose `_gemm_kernel` is TPU kernel #11).

    y[m, n] = sum_t (sum_{k in tile t} xq[m, k] wq[k, n]) * sx[m, t] * sw[t, n / 128]

with f32 accumulation and one rescale per 128-deep K tile, output in
`out_dtype`. Layouts as in JAX: xq (M, K) e4m3 or e5m2, sx (M, K/128) f32,
wq (K, N) e4m3 or e5m2, sw (K/128, N/128) f32.

The quantisers are plain PyTorch, as JAX's are jnp: f32 amax over the
tile, scale = max(amax, eps) / fp8 max, codes = (x / scale) cast. They give
the same codes and scales as JAX's, bit for bit (`tests/test_torch_float8.py`),
on the card too: there PyTorch turns a division by a Python number into a
multiplication by its reciprocal, which can move the scale by one ulp, so
the fp8 max divides as a tensor on the data's device. Each takes two passes
over x in its own dtype (`quantise`): the amax, then the f32 division cast
to fp8 as it is stored; XLA fuses JAX's the same way.

On a CUDA tensor `fp8_gemm_tilewise` launches the hand-written Hopper
kernel (`csrc/fp8_gemm.cu`) or raises; on a CPU tensor it runs the plain
version, the f32 dequantise-then-matmul of JAX's
`fp8_gemm_tilewise_emulated`. The kernel takes B K-major (the fp8 tensor
cores' operand layout), so the wrapper lays wq out as (N, K) codes: K * N
bytes read and written once per call. K and N must be 128 multiples (the
quantisers' tiles: `float8.py::_tile_dot` pads them); M is never padded.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_FP8_MAX = {torch.float8_e4m3fn: E4M3_MAX, torch.float8_e5m2: E5M2_MAX}
_FP8_CODE = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}  # the kernels' type codes
_OUT_CODE = {torch.bfloat16: 0, torch.float32: 1}


def quantise(xt: torch.Tensor, dims, dtype, eps: float = 1e-12):
    """(codes of xt / scale in `dtype`, scale = max(max |xt| over `dims`,
    eps) / fp8 max, dims kept). Two passes over xt, in its dtype: the amax,
    then the division, computed in f32 and cast to fp8 on store."""
    amax = torch.linalg.vector_norm(xt, ord=float("inf"), dim=dims, keepdim=True,
                                    dtype=torch.float32)
    # a device tensor, not a Python number: an IEEE division on the card too
    scale = amax.clamp(min=eps) / torch.full((), _FP8_MAX[dtype], device=xt.device)
    q = torch.empty(xt.shape, dtype=dtype, device=xt.device)
    return torch.div(xt, scale, out=q), scale


def quantize_tilewise(x: torch.Tensor, tile: int = 128, dtype=torch.float8_e4m3fn,
                      eps: float = 1e-12):
    """x (..., K) -> (q (..., K) fp8, scale (..., K/tile) f32): one scale per
    contiguous K-tile of each row."""
    *lead, k = x.shape
    if k % tile:
        raise ValueError(f"quantize_tilewise: K {k} is not a multiple of {tile}")
    q, scale = quantise(x.reshape(*lead, k // tile, tile), -1, dtype, eps)
    return q.reshape(*lead, k), scale[..., 0]


def quantize_blockwise(w: torch.Tensor, tile: int = 128, dtype=torch.float8_e4m3fn,
                       eps: float = 1e-12):
    """w (K, N) -> (q (K, N) fp8, scale (K/tile, N/tile) f32): one scale per
    (tile x tile) block."""
    k, n = w.shape
    if k % tile or n % tile:
        raise ValueError(f"quantize_blockwise: ({k}, {n}) is not in {tile}-blocks")
    q, scale = quantise(w.reshape(k // tile, tile, n // tile, tile), (1, 3), dtype, eps)
    return q.reshape(k, n), scale[:, 0, :, 0]


def dequantize_tilewise(q: torch.Tensor, scale: torch.Tensor, tile: int = 128):
    """(..., K) codes with (..., K/tile) scales -> f32."""
    *lead, k = q.shape
    return (q.float().reshape(*lead, k // tile, tile) * scale[..., None]).reshape(*lead, k)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, tile: int = 128):
    """(..., K, N) codes with (..., K/tile, N/tile) block scales -> f32."""
    *lead, k, n = q.shape
    qt = q.float().reshape(*lead, k // tile, tile, n // tile, tile)
    return (qt * scale[..., :, None, :, None]).reshape(*lead, k, n)


def fp8_gemm_tilewise_plain(xq, sx, wq, sw, *, tile: int = 128, out_dtype=torch.bfloat16):
    """Plain version of `_gemm_kernel` (JAX's `fp8_gemm_tilewise_emulated`):
    f32 dequantise, then one f32 GEMM: the same per-tile-scaled products,
    summed in another order."""
    y = dequantize_tilewise(xq, sx, tile) @ dequantize_blockwise(wq, sw, tile)
    return y.to(out_dtype)


def check_fp8_operands(name: str, tile: int, *pairs) -> None:
    """What the fp8 kernels take: `tile` 128, fp8 codes, f32 scales, one
    device, contiguous codes."""
    if tile != 128:
        raise ValueError(f"{name} kernel: tile {tile}; the kernel's tiles are 128")
    dev = pairs[0][0].device
    for q, s in pairs:
        if q.dtype not in _FP8_CODE or s.dtype != torch.float32:
            raise ValueError(f"{name} kernel: operands {q.dtype} / {s.dtype}, want fp8 "
                             f"codes (e4m3fn or e5m2) with float32 scales")
        if q.device != dev or s.device != dev:
            raise ValueError(f"{name}: operands on different devices")


def check_aligned(name: str, *codes) -> None:
    """The kernels copy codes 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in codes):
        raise ValueError(f"{name} kernel: fp8 operands must start 16-byte aligned")


def k_major(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) fp8 codes -> contiguous (..., N, K) uint8: the operand
    layout of the fp8 tensor cores. A view that is already a transpose of a
    contiguous tensor costs nothing."""
    return q.view(torch.uint8).transpose(-1, -2).contiguous()


def fp8_gemm_tilewise(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                      *, tile: int = 128, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(M, K) fp8 x (K, N) fp8 -> (M, N) out_dtype, per-tile rescaled f32
    accumulation (see the module docstring)."""
    m, k = xq.shape
    k2, n = wq.shape
    if k2 != k or k % tile or n % tile or sx.shape != (m, k // tile) \
            or sw.shape != (k // tile, n // tile):
        raise ValueError(f"fp8_gemm_tilewise: xq {tuple(xq.shape)}, sx {tuple(sx.shape)}, "
                         f"wq {tuple(wq.shape)}, sw {tuple(sw.shape)} do not fit tile {tile}")
    if xq.device.type == "cpu":
        return fp8_gemm_tilewise_plain(xq, sx, wq, sw, tile=tile, out_dtype=out_dtype)
    check_fp8_operands("fp8_gemm_tilewise", tile, (xq, sx), (wq, sw))
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"fp8_gemm_tilewise kernel: out_dtype {out_dtype}, want bf16 or f32")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0:
        return out
    from .cuda_lib import check, load

    # every operand bound to a name until the launch: a temporary freed
    # early could hand its memory to the next one
    xc, sxc, wt, swc = xq.contiguous(), sx.contiguous(), k_major(wq), sw.contiguous()
    check_aligned("fp8_gemm_tilewise", xc, wt)
    err = load().xt_fp8_gemm(
        xc.data_ptr(), sxc.data_ptr(), wt.data_ptr(), swc.data_ptr(), out.data_ptr(),
        m, k, n, _FP8_CODE[xq.dtype],
        _FP8_CODE[wq.dtype], _OUT_CODE[out_dtype],
        torch.cuda.current_stream(xq.device).cuda_stream)
    check(err, "xt_fp8_gemm")
    fp8_gemm_tilewise.launches += 1
    return out


fp8_gemm_tilewise.launches = 0  # kernel launches since the last reset


def reset_launches() -> None:
    fp8_gemm_tilewise.launches = 0
