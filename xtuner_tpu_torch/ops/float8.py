"""Float8 training path (counterpart: `xtuner_tpu/ops/float8.py`).

`Float8Config` (the JAX fields and defaults, as a dataclass), the
quantisers, `_tile_dot` and the differentiable `fp8_matmul`:

- tilewise: x quantised per (row, 128-column) tile, w per 128 x 128
  block, the product through `ops/fp8_gemm.py::fp8_gemm_tilewise` (TPU
  kernel #11: the Hopper kernel on a card, its plain version on the CPU).
  The backward is a bf16 product with f32 output by default; with
  `e5m2_grads` both backward products run through #11 too, the incoming
  gradient quantised to e5m2 (dgrad: A in e5m2; wgrad: B in e5m2).
- tensorwise: one amax scale per tensor. JAX runs one `dot_general` on the
  fp8 codes (no Pallas kernel); here the codes are cast to bf16, which is
  exact, multiplied with an f32 result and scaled by sx * sw.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .bf16_grouped import _mm_f32
from .fp8_gemm import (E4M3_MAX, fp8_gemm_tilewise, quantise, quantize_blockwise,
                       quantize_tilewise)

__all__ = ["Float8Config", "E4M3_MAX", "quantize_e4m3", "dequantize", "fp8_matmul"]


@dataclass
class Float8Config:
    """Same fields and defaults as the JAX `Float8Config`."""

    enabled: bool = True
    scaling_granularity: str = "tilewise"  # tensorwise | tilewise
    tile: int = 128
    # quantize incoming grads to e5m2 in backward (reference e5m2 grad path);
    # False = fp8 forward, bf16 backward
    e5m2_grads: bool = False

    def __post_init__(self):
        if self.scaling_granularity not in ("tensorwise", "tilewise"):
            raise ValueError(f"scaling_granularity {self.scaling_granularity!r}: "
                             f"want 'tensorwise' or 'tilewise'")


def fp8_enabled(cfg) -> bool:
    return cfg is not None and getattr(cfg, "enabled", False)


def quantize_e4m3(x: torch.Tensor, granularity: str = "tilewise", tile: int = 128):
    """-> (x_fp8, scale f32). Tilewise: scale (*lead, K/tile, 1) per (row,
    col-tile); tensorwise: one scale, all dims kept (size 1), as in JAX."""
    if granularity == "tensorwise":
        return quantise(x, tuple(range(x.dim())), torch.float8_e4m3fn)
    *lead, d = x.shape
    q, scale = quantise(x.reshape(*lead, d // tile, tile), -1, torch.float8_e4m3fn)
    return q.reshape(*lead, d), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, granularity: str = "tilewise",
               tile: int = 128) -> torch.Tensor:
    if granularity == "tensorwise":
        return q.float() * scale
    *lead, d = q.shape
    return (q.reshape(*lead, d // tile, tile).float() * scale).reshape(*lead, d)


def _tile_dot(a, b, tile: int, out_dtype, a_dtype=torch.float8_e4m3fn,
              b_dtype=torch.float8_e4m3fn):
    """a (M, K) x b (K, N) through the tile-wise fp8 GEMM: a quantised per
    (row, K-tile), b per (K-tile, N-tile) block. K and N are zero-padded to
    tile multiples; M is not padded."""
    k, n = b.shape
    pk, pn = (-k) % tile, (-n) % tile
    if pk:
        a = F.pad(a, (0, pk))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    aq, sa = quantize_tilewise(a, tile, a_dtype)
    bq, sb = quantize_blockwise(b, tile, b_dtype)
    y = fp8_gemm_tilewise(aq, sa, bq, sb, tile=tile, out_dtype=out_dtype)
    return y[:, :n] if pn else y


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, granularity, tile, e5m2_grads):
        ctx.save_for_backward(x, w)
        ctx.cfg = (granularity, tile, e5m2_grads)
        k, n = w.shape
        if granularity == "tensorwise":
            xq, sx = quantize_e4m3(x, "tensorwise")
            wq, sw = quantize_e4m3(w, "tensorwise")
            y = _mm_f32(xq.reshape(-1, k).to(torch.bfloat16), wq.to(torch.bfloat16))
            return (y * (sx.reshape(()) * sw.reshape(()))).to(x.dtype).reshape(
                *x.shape[:-1], n)
        return _tile_dot(x.reshape(-1, k), w, tile, x.dtype).reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        granularity, tile, e5m2_grads = ctx.cfg
        k, n = w.shape
        g2d, x2d = g.reshape(-1, n), x.reshape(-1, k)
        if granularity == "tilewise" and e5m2_grads:
            # dgrad: g (M, N) in e5m2 per (row, N-tile) x w^T blocks; wgrad:
            # x^T (K, M) per (row, M-tile) x g (M, N) blocks in e5m2
            dx = _tile_dot(g2d, w.T, tile, x.dtype, a_dtype=torch.float8_e5m2)
            dw = _tile_dot(x2d.T, g2d, tile, w.dtype, b_dtype=torch.float8_e5m2)
        else:
            gb = g2d.to(torch.bfloat16)
            dx = _mm_f32(gb, w.to(torch.bfloat16).T).to(x.dtype)
            dw = _mm_f32(x2d.to(torch.bfloat16).T, gb).to(w.dtype)
        return dx.reshape(x.shape), dw, None, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, granularity: str = "tilewise",
               tile: int = 128, e5m2_grads: bool = False) -> torch.Tensor:
    """y = x @ w with fp8 operands. x: (..., K); w: (K, N); y in x.dtype."""
    return _Fp8Matmul.apply(x, w, granularity, tile, e5m2_grads)
