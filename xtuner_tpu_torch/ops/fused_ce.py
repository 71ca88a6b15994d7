"""Fused chunk-free cross-entropy statistics (counterpart:
`xtuner_tpu/ops/fused_ce.py`: `ce_lse_and_label_vh` with its custom VJP,
`ce_stats_vh` and `ce_lse_and_label`, i.e. TPU kernels #8 `_fwd_kernel`,
#9 `_dh_kernel` and #10 `_dw_kernel`).

For each row r of h (N, H) and a VOCAB-MAJOR weight w (V, H), the forward
computes

    lse[r]         = logsumexp_v(h[r] . w[v])
    label_logit[r] = h[r] . w[labels[r]]

and the backward takes the cotangents (g_lse, g_lab) to

    c[r, v] = p[r, v] g_lse[r] + 1[v == labels[r]] g_lab[r]   (rounded to w.dtype)
    dh = c . w  (in h.dtype),   dw = c^T . h  (in w.dtype)

with f32 logits and f32 accumulation, as the TPU kernels. On a CUDA tensor
each of the three wrappers launches its hand-written Hopper kernel
(`csrc/fused_ce.cu`), which never writes the (N, V) logits to device
memory, or raises; on a CPU tensor it runs the plain version beside it:
f32 logits from the same operands, a chunk of rows at a time.

The TPU path splits a vocab that does not tile (Qwen's 151936) into a
kernel prefix and an XLA tail merged with `logaddexp`; the CUDA kernels
mask the last tile instead, so `ce_stats_vh` is `ce_lse_and_label_vh` over
the whole vocab. Labels must lie in [0, V): the caller clamps ignored rows
and gives them zero cotangents (`loss/ce_loss.py::_fused_ce`).
"""

from __future__ import annotations

import torch

from .bf16_grouped import _mm_f32

PLAIN_ROWS = 2048  # rows per f32 logits chunk of the plain versions
BLOCK = 128  # the kernels' row and vocab tile


def _logits_plain(h_c, w):
    """f32 logits (rows, V) of bf16 or f32 operands."""
    return _mm_f32(h_c, w.T)


def ce_fwd_plain(h, w, labels):
    """Plain version of `_fwd_kernel`: (lse, label_logit), each (N,) f32."""
    lse, lab = [], []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        logits = _logits_plain(h[s:s + PLAIN_ROWS], w)
        lse.append(torch.logsumexp(logits, dim=-1))
        lab.append(logits.gather(1, labels[s:s + PLAIN_ROWS, None].long())[:, 0])
    return torch.cat(lse), torch.cat(lab)


def _coeff(logits, labels, lse, g_lse, g_lab, dtype):
    """The gradient coefficient tile, rounded to the operands' dtype."""
    c = torch.exp(logits - lse[:, None]) * g_lse[:, None]
    c.scatter_add_(1, labels[:, None].long(), g_lab[:, None])
    return c.to(dtype)


def ce_dh_plain(h, w, labels, lse, g_lse, g_lab):
    """Plain version of `_dh_kernel`: dh (N, H) in h.dtype."""
    out = []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        sl = slice(s, s + PLAIN_ROWS)
        c = _coeff(_logits_plain(h[sl], w), labels[sl], lse[sl], g_lse[sl], g_lab[sl], w.dtype)
        out.append(_mm_f32(c, w).to(h.dtype))
    return torch.cat(out)


def ce_dw_plain(h, w, labels, lse, g_lse, g_lab):
    """Plain version of `_dw_kernel`: dw (V, H) in w.dtype."""
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for s in range(0, h.shape[0], PLAIN_ROWS):
        sl = slice(s, s + PLAIN_ROWS)
        c = _coeff(_logits_plain(h[sl], w), labels[sl], lse[sl], g_lse[sl], g_lab[sl], w.dtype)
        dw += _mm_f32(c.T, h[sl])
    return dw.to(w.dtype)


def _check(name, h, w, labels, *rows):
    n, hd = h.shape
    if w.dim() != 2 or w.shape[1] != hd or labels.shape != (n,):
        raise ValueError(f"{name}: h {tuple(h.shape)}, w {tuple(w.shape)}, labels "
                         f"{tuple(labels.shape)} do not fit")
    for t in (w, labels, *rows):
        if t.device != h.device:
            raise ValueError(f"{name}: operands on different devices")
    if h.device.type == "cpu":
        return
    if h.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {h.device}")
    for nm, t in (("h", h), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: {nm} is {t.dtype}, want bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {nm} must be contiguous and 16-byte aligned")
    if hd % 128 or n == 0 or w.shape[0] == 0:
        raise ValueError(f"{name} kernel: hidden {hd} must be a multiple of 128, N and V > 0")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError(f"{name} kernel: labels must be contiguous int32")
    for t in rows:
        if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel: row statistics must be contiguous f32 (N,)")


def ce_fwd(h, w, labels):
    """Kernel #8: (lse, label_logit), each (N,) f32."""
    _check("ce_fwd", h, w, labels)
    if h.device.type == "cpu":
        return ce_fwd_plain(h, w, labels)
    from .cuda_lib import check, load

    n, hd = h.shape
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    lab = torch.empty(n, dtype=torch.float32, device=h.device)
    err = load().xt_ce_fwd_bf16(h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                                lab.data_ptr(), n, w.shape[0], hd,
                                torch.cuda.current_stream(h.device).cuda_stream)
    check(err, "xt_ce_fwd_bf16")
    ce_fwd.launches += 1
    return lse, lab


def _splits(outer: int, inner: int, device) -> int:
    """CTAs along the inner axis: enough outer tiles x splits to fill the
    card, at most one per 256-wide inner chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-outer // BLOCK)
    return max(1, min(round(sms / tiles), -(-inner // (2 * BLOCK))))


def _bwd_kernel(h, w, labels, lse, g_lse, g_lab, dw: bool):
    from .cuda_lib import check, load

    n, hd = h.shape
    v = w.shape[0]
    outer, inner = (v, n) if dw else (n, v)
    splits = _splits(outer, inner, h.device)
    part = torch.empty((splits, -(-outer // BLOCK) * BLOCK, hd), dtype=torch.float32,
                       device=h.device)
    out = torch.empty((outer, hd), dtype=torch.bfloat16, device=h.device)
    err = load().xt_ce_bwd_bf16(h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                                g_lse.data_ptr(), g_lab.data_ptr(), part.data_ptr(),
                                out.data_ptr(), n, v, hd, splits, int(dw),
                                torch.cuda.current_stream(h.device).cuda_stream)
    check(err, "xt_ce_bwd_bf16")
    return out


def ce_dh(h, w, labels, lse, g_lse, g_lab):
    """Kernel #9: dh (N, H) in h.dtype."""
    _check("ce_dh", h, w, labels, lse, g_lse, g_lab)
    if h.device.type == "cpu":
        return ce_dh_plain(h, w, labels, lse, g_lse, g_lab)
    out = _bwd_kernel(h, w, labels, lse, g_lse, g_lab, dw=False)
    ce_dh.launches += 1
    return out


def ce_dw(h, w, labels, lse, g_lse, g_lab):
    """Kernel #10: dw (V, H) in w.dtype (the embedding layout)."""
    _check("ce_dw", h, w, labels, lse, g_lse, g_lab)
    if h.device.type == "cpu":
        return ce_dw_plain(h, w, labels, lse, g_lse, g_lab)
    out = _bwd_kernel(h, w, labels, lse, g_lse, g_lab, dw=True)
    ce_dw.launches += 1
    return out


ce_fwd.launches = 0  # kernel launches since the last reset
ce_dh.launches = 0
ce_dw.launches = 0


def reset_launches() -> None:
    ce_fwd.launches = ce_dh.launches = ce_dw.launches = 0


class _FusedCE(torch.autograd.Function):
    """`ce_lse_and_label_vh`'s custom VJP: residuals (h, w, labels, lse)."""

    @staticmethod
    def forward(ctx, h, w, labels):
        labels = labels.to(torch.int32).contiguous()
        lse, lab = ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return lse, lab

    @staticmethod
    def backward(ctx, g_lse, g_lab):
        h, w, labels, lse = ctx.saved_tensors

        def cot(g):
            if g is None:
                return torch.zeros_like(lse)
            return g.float().contiguous()

        g_lse, g_lab = cot(g_lse), cot(g_lab)
        dh = ce_dh(h, w, labels, lse, g_lse, g_lab) if ctx.needs_input_grad[0] else None
        dw = ce_dw(h, w, labels, lse, g_lse, g_lab) if ctx.needs_input_grad[1] else None
        return dh, dw, None


def ce_lse_and_label_vh(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """h: (N, H) compute dtype; w: (V, H) VOCAB-MAJOR; labels: (N,) in
    [0, V). Returns (lse (N,) f32, label_logit (N,) f32), differentiable in
    h and w."""
    return _FusedCE.apply(h, w, labels)


def ce_stats_vh(h: torch.Tensor, w_vh: torch.Tensor, labels: torch.Tensor):
    """The JAX entry that splits a vocab which does not tile; here the
    kernels mask the last vocab tile, so it is one call over the whole
    vocab, with no pad or slice copy of the head."""
    return ce_lse_and_label_vh(h, w_vh, labels)


def ce_lse_and_label(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """For callers holding an (H, V) head: `w.T` is vocab-major. A tied
    head is `embed.T`, whose `.T` is the contiguous embedding (no copy); an
    untied (H, V) head is copied once to (V, H) for the kernels."""
    w_vh = w.T
    if w_vh.is_cuda and not w_vh.is_contiguous():
        w_vh = w_vh.contiguous()
    return ce_stats_vh(h, w_vh, labels)
