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
each wrapper launches its hand-written Hopper kernels (`csrc/fused_ce.cu`),
which never write the (N, V) logits to device memory, or raises; on a CPU
tensor it runs the plain version beside it: f32 logits from the same
operands, a chunk of rows at a time.

The forward (`ce_fwd`) is one logits sweep over (256-column vocab tile,
128-row tile) items: each item writes, per row, the max and the sum of
exp2 of its tile's columns (base 2) into a scratch of ceil(V / 256) x N
pairs (`ce_fwd_scratch_bytes`), and a second kernel folds each row's pairs
in vocab-tile order into lse; the label logit comes from the tile that
holds it. `ce_fwd_partials_plain` and `ce_lse_combine_plain` are that
decomposition in plain torch, for the CPU tests.

The backward (`ce_bwd`) walks the rows in chunks (`ce_chunk_plan`): per
chunk one coefficient sweep (`ce_coeff`: the logits on wgmma, c in
registers, out as a bf16 (rows, V_pad) scratch reused by every chunk),
then dh_chunk = c . w and dW += c^T . h_chunk on the grouped GEMM kernel's
dense entry points (`csrc/grouped_gemm.cu`), which count nothing in the
MoE layer's counters. `ce_bwd_chunked_plain` is the same plan in plain
torch, for the CPU tests.

The TPU path splits a vocab that does not tile (Qwen's 151936) into a
kernel prefix and an XLA tail merged with `logaddexp`; the CUDA kernels
mask the last tile instead, so `ce_stats_vh` is `ce_lse_and_label_vh` over
the whole vocab. Labels must lie in [0, V): the caller clamps ignored rows
and gives them zero cotangents (`loss/ce_loss.py::_fused_ce`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .bf16_grouped import _mm_f32

PLAIN_ROWS = 2048  # rows per f32 logits chunk of the plain versions
BLOCK = 128  # the kernels' row tile
VOCAB_TILE = 256  # the coefficient kernel's vocab tile: V_pad is a multiple
CHUNK_ROWS = 4096  # the backward's most rows per chunk
C_SCRATCH_BYTES = 1_250_000_000  # the bf16 c chunk's bound (4096 rows at V151936)


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


def ce_fwd_scratch_bytes(n: int, v: int) -> int:
    """The forward's f32 scratch: a (max, sum) pair per row and vocab tile."""
    return 8 * n * _ceil(v, VOCAB_TILE)


def ce_fwd_partials_plain(h, w, labels):
    """The forward kernel's per-item statistics in plain torch: part (vt, N,
    2) f32, per 256-column vocab tile t and row r the tile's max logit times
    log2(e) and the sum of exp2(logit log2(e) - that max) over its columns
    < V; and the label logit (N,) from the tile that holds the label."""
    n, v = h.shape[0], w.shape[0]
    vt = _ceil(v, VOCAB_TILE)
    part = torch.empty((vt, n, 2), dtype=torch.float32, device=h.device)
    lab = torch.empty(n, dtype=torch.float32, device=h.device)
    log2e = 1.0 / math.log(2.0)
    for t in range(vt):
        v0 = t * VOCAB_TILE
        s = _logits_plain(h, w[v0:v0 + VOCAB_TILE])
        m2 = s.amax(dim=1) * log2e
        part[t, :, 0] = m2
        part[t, :, 1] = torch.exp2(s * log2e - m2[:, None]).sum(dim=1)
        hit = (labels >= v0) & (labels < v0 + s.shape[1])
        lab[hit] = s[hit].gather(1, (labels[hit] - v0)[:, None].long())[:, 0]
    return part, lab


def ce_lse_combine_plain(part):
    """The combine kernel in plain torch: lse (N,) from part (vt, N, 2),
    folded in vocab-tile order with a running max, as the kernel folds it."""
    m = torch.full(part.shape[1:2], -1e30, dtype=torch.float32, device=part.device)
    l = torch.zeros_like(m)
    for t in range(part.shape[0]):
        mt, lt = part[t, :, 0], part[t, :, 1]
        mn = torch.maximum(m, mt)
        l = l * torch.exp2(m - mn) + lt * torch.exp2(mt - mn)
        m = mn
    return (m + torch.log2(l)) * math.log(2.0)


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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ChunkPlan:
    """The backward's row chunks, as the kernels walk them."""
    nc: int  # the most rows of a chunk: a multiple of 128 that depends on V alone
    v_pad: int  # the c chunk's columns: V rounded up to the vocab tile
    chunks: tuple  # (first row, rows) of each chunk
    scratch_bytes: int  # the bf16 c buffer: the largest chunk's rows x v_pad

    @property
    def rows(self) -> int:
        return self.chunks[0][1]


def ce_chunk_plan(n: int, v: int) -> ChunkPlan:
    """Nc is the largest multiple of 128, up to CHUNK_ROWS, whose (Nc, V_pad)
    bf16 c chunk fits C_SCRATCH_BYTES. The N rows go into ceil(N / Nc)
    chunks of one size rounded up to 128 (the last one shorter), so a small
    remainder never runs as a chunk of its own that leaves the card idle."""
    v_pad = _ceil(v, VOCAB_TILE) * VOCAB_TILE
    nc = min(CHUNK_ROWS, C_SCRATCH_BYTES // (2 * v_pad) // BLOCK * BLOCK)
    if nc < BLOCK:
        raise ValueError(f"vocab {v}: a 128-row c chunk exceeds {C_SCRATCH_BYTES} bytes")
    per = _ceil(_ceil(n, _ceil(n, nc)), BLOCK) * BLOCK
    chunks = tuple((s, min(per, n - s)) for s in range(0, n, per))
    return ChunkPlan(nc, v_pad, chunks, 2 * chunks[0][1] * v_pad)


def ce_coeff_plain(h_c, w, labels_c, lse_c, g_lse_c, g_lab_c, v_pad: int):
    """Plain version of the coefficient kernel for one chunk of rows: c
    (rows, v_pad) in w.dtype, zero in the columns >= V."""
    c = _coeff(_logits_plain(h_c, w), labels_c, lse_c, g_lse_c, g_lab_c, w.dtype)
    return torch.nn.functional.pad(c, (0, v_pad - w.shape[0]))


def ce_bwd_chunked_plain(h, w, labels, lse, g_lse, g_lab, need_dh=True, need_dw=True):
    """The kernels' backward in plain torch: per chunk of `ce_chunk_plan`,
    c from `ce_coeff_plain`, dh_chunk = c . w rounded to h.dtype, dW += c^T
    . h_chunk in f32, rounded to w.dtype at the end. Returns (dh, dw), None
    where not asked."""
    n, v = h.shape[0], w.shape[0]
    plan = ce_chunk_plan(n, v)
    dh = torch.empty(h.shape, dtype=h.dtype, device=h.device) if need_dh else None
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) if need_dw else None
    for s, rows in plan.chunks:
        sl = slice(s, s + rows)
        c = ce_coeff_plain(h[sl], w, labels[sl], lse[sl], g_lse[sl], g_lab[sl],
                           plan.v_pad)[:, :v]
        if need_dh:
            dh[sl] = _mm_f32(c, w).to(h.dtype)
        if need_dw:
            dw += _mm_f32(c.T, h[sl])
    return dh, dw.to(w.dtype) if need_dw else None


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
    """Kernel #8: (lse, label_logit), each (N,) f32: the statistics sweep,
    then the fold of its per-tile pairs (a scratch of
    `ce_fwd_scratch_bytes`)."""
    _check("ce_fwd", h, w, labels)
    if h.device.type == "cpu":
        return ce_fwd_plain(h, w, labels)
    from .cuda_lib import check, load

    n, hd = h.shape
    v = w.shape[0]
    part = torch.empty((_ceil(v, VOCAB_TILE), n, 2), dtype=torch.float32, device=h.device)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    lab = torch.empty(n, dtype=torch.float32, device=h.device)
    err = load().xt_ce_fwd_bf16(h.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(),
                                lse.data_ptr(), lab.data_ptr(), n, v, hd,
                                torch.cuda.current_stream(h.device).cuda_stream)
    check(err, "xt_ce_fwd_bf16")
    ce_fwd.launches += 1
    return lse, lab


def ce_coeff(h_c, w, labels_c, lse_c, g_lse_c, g_lab_c, v_pad: int, out=None):
    """The coefficient kernel on one chunk of rows (the chunk's own h,
    labels and row statistics): c (rows, v_pad) bf16, zero in the columns
    >= V, into `out` where given."""
    _check("ce_coeff", h_c, w, labels_c, lse_c, g_lse_c, g_lab_c)
    if h_c.device.type == "cpu":
        return ce_coeff_plain(h_c, w, labels_c, lse_c, g_lse_c, g_lab_c, v_pad)
    rows, hd = h_c.shape
    v = w.shape[0]
    if v_pad % VOCAB_TILE or v_pad < v:
        raise ValueError(f"ce_coeff kernel: v_pad {v_pad} must be a multiple of "
                         f"{VOCAB_TILE} and >= V {v}")
    if out is None:
        out = torch.empty((rows, v_pad), dtype=torch.bfloat16, device=h_c.device)
    elif (out.shape != (rows, v_pad) or out.dtype != torch.bfloat16
          or not out.is_contiguous()):
        raise ValueError(f"ce_coeff kernel: out must be contiguous bf16 {(rows, v_pad)}")
    from .cuda_lib import check, load

    err = load().xt_ce_coeff_bf16(h_c.data_ptr(), w.data_ptr(), labels_c.data_ptr(),
                                  lse_c.data_ptr(), g_lse_c.data_ptr(), g_lab_c.data_ptr(),
                                  out.data_ptr(), rows, v, hd, v_pad,
                                  torch.cuda.current_stream(h_c.device).cuda_stream)
    check(err, "xt_ce_coeff_bf16")
    ce_coeff.launches += 1
    return out


def ce_bwd(h, w, labels, lse, g_lse, g_lab, need_dh: bool = True, need_dw: bool = True,
           marks: list | None = None):
    """Kernels #9 and #10 in one backward: (dh (N, H) in h.dtype, dw (V, H)
    in w.dtype), None where not asked. Per chunk of `ce_chunk_plan` one
    coefficient sweep, then the dh and dW products that are asked for.
    `marks`, where given, receives (pass, CUDA event) after each launch
    ("coeff", "dh", "dw", "round"; "start" first): `ce_bwd_pass_ms` reads
    the device time of each pass from them."""
    _check("ce_bwd", h, w, labels, lse, g_lse, g_lab)
    if h.device.type == "cpu":
        return (ce_dh_plain(h, w, labels, lse, g_lse, g_lab) if need_dh else None,
                ce_dw_plain(h, w, labels, lse, g_lse, g_lab) if need_dw else None)
    from .cuda_lib import check, load

    lib = load()
    n, hd = h.shape
    v = w.shape[0]
    dev = h.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = ce_chunk_plan(n, v)
    c = torch.empty((plan.rows, plan.v_pad), dtype=torch.bfloat16, device=dev)
    # each chunk's row count on the device: the products' one group size
    sizes = torch.full((len(plan.chunks),), plan.rows, dtype=torch.int32, device=dev)
    sizes[-1:].fill_(plan.chunks[-1][1])
    dh = torch.empty((n, hd), dtype=torch.bfloat16, device=dev) if need_dh else None
    acc = torch.empty((v, hd), dtype=torch.float32, device=dev) if need_dw else None
    row_bytes = hd * h.element_size()

    def mark(tag):
        if marks is not None:
            marks.append((tag, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

    mark("start")
    for i, (s, rows) in enumerate(plan.chunks):
        sl = slice(s, s + rows)
        ce_coeff(h[sl], w, labels[sl], lse[sl], g_lse[sl], g_lab[sl], plan.v_pad,
                 out=c[:rows])
        mark("coeff")
        size_i = sizes.data_ptr() + 4 * i
        if need_dh:
            check(lib.xt_gemm_nn_bf16(c.data_ptr(), w.data_ptr(), size_i,
                                      dh.data_ptr() + s * row_bytes, rows, plan.v_pad, v, hd,
                                      stream), "xt_gemm_nn_bf16")
            mark("dh")
        if need_dw:
            check(lib.xt_gemm_dw_bf16(c.data_ptr(), h.data_ptr() + s * row_bytes, size_i,
                                      acc.data_ptr(), rows, plan.v_pad, v, hd, int(i > 0),
                                      stream), "xt_gemm_dw_bf16")
            mark("dw")
    dw = None
    if need_dw:
        dw = torch.empty((v, hd), dtype=torch.bfloat16, device=dev)
        check(lib.xt_ce_round_bf16(acc.data_ptr(), dw.data_ptr(), v * hd, stream),
              "xt_ce_round_bf16")
        mark("round")
        ce_dw.launches += 1
    if need_dh:
        ce_dh.launches += 1
    return dh, dw


def ce_bwd_pass_ms(marks: list) -> dict:
    """pass -> device ms summed over the launches of one or more `ce_bwd`
    calls' `marks` (synchronizes)."""
    torch.cuda.synchronize()
    out: dict = {}
    for (_, a), (tag, b) in zip(marks, marks[1:]):
        if tag != "start":
            out[tag] = out.get(tag, 0.0) + a.elapsed_time(b)
    return out


def ce_dh(h, w, labels, lse, g_lse, g_lab):
    """Kernel #9: dh (N, H) in h.dtype (`ce_bwd` with dh alone)."""
    return ce_bwd(h, w, labels, lse, g_lse, g_lab, need_dw=False)[0]


def ce_dw(h, w, labels, lse, g_lse, g_lab):
    """Kernel #10: dw (V, H) in w.dtype, the embedding layout (`ce_bwd`
    with dW alone)."""
    return ce_bwd(h, w, labels, lse, g_lse, g_lab, need_dh=False)[1]


# launches since the last reset: the forward; the coefficient kernel (one
# per row chunk); backward calls that ran the dh and the dW products
ce_fwd.launches = 0
ce_coeff.launches = 0
ce_dh.launches = 0
ce_dw.launches = 0


def reset_launches() -> None:
    ce_fwd.launches = ce_coeff.launches = ce_dh.launches = ce_dw.launches = 0


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

        dh, dw = ce_bwd(h, w, labels, lse, cot(g_lse), cot(g_lab),
                        need_dh=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1])
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
