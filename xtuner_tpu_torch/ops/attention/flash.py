"""GQA flash attention over packed rows, causal or not, forward and backward
(counterpart: `xtuner_tpu/ops/attention/flash.py`, `_flash`'s custom VJP:
`_flash_forward` with its running-max and max-free `_fwd_kernel`, and
`_flash_bwd_rule` with `_dq_kernel` and either `_dkv_grouped_kernel` or,
under `XTUNER_ATTN_BWD=two_pass`, the per-q-head `_dkv_kernel`).

`flash_attention` returns `(out, lse)` like the JAX `_flash_forward` (the
JAX public `flash_attention` returns `out` alone) and is differentiable in
q, k and v through `_FlashAttention`, whose backward computes
`delta = rowsum(do * out)` in plain PyTorch, as JAX does outside its
kernels, then runs `flash_bwd` along the dk/dv path the switch selected
when the forward ran: grouped (the default) or, for any other value of
`XTUNER_ATTN_BWD`, as in JAX, per q head and then the group sum in plain
PyTorch. Each kernel wrapper launches its hand-written Hopper kernel on a
CUDA tensor (`csrc/flash_fwd.cu`; `csrc/flash_bwd.cu`: at head dim 128 one
pass that gives dq, dk and dv together, at the other pairs a dq kernel
and a dk/dv kernel) or raises, and runs the plain PyTorch version beside
it on a CPU tensor. v, out and do have the v head dim Dv, which may
differ from q and k's D: the forward kernel takes (D, Dv) in
`KERNEL_DIMS`, the backward kernels in `BWD_KERNEL_DIMS`. At (256, 256),
Qwen3.5's gated attention, the forward walks 64-key tiles (`fwd_key_tile`;
O of 64 rows x 256 fills half a thread's registers), and the backward's
dq CTA has room for one V and two K stages.

A sliding window (`window`: key m visible to query l only if l - m <
window) and per-head sinks (`sinks`, (Hq,): a logit that joins each row's
softmax denominator and weights no value) are taken as JAX `_flash` takes
them. The window is inside the kernels: the forward's walk starts at the
first k tile that meets a q tile's window (`fwd_tile_plan`); the split
backward kernels (D != 128) start the dq walk there too, end each key
tile's q walk at the last q tile that still sees one of its keys, and
mask by the window on the tiles that straddle its edge. The one-pass
backward at 128/128 and the split one at 256/256 take no window: a CUDA
call with one raises. The
sinks are folded into out and lse after the forward kernel, in plain
PyTorch as JAX folds them in jnp (`fold_sinks`); the backward kernels take
the folded lse, so p = exp(s - lse) already carries them, and their
gradient is `-(exp(sinks - lse) * delta)` summed over batch and rows, in
plain PyTorch as in JAX's `_flash_bwd_rule`.

`flash_attention_saving_out_lse` is the attention of remat "save_out_lse"
(JAX saves only `attn_res_out` and `attn_lse`): it takes the function
that makes q, k and v, keeps only that function's inputs, out and lse,
and in the backward re-runs the function (never the flash forward).

`max_logit` is a proven bound on |scaled logit| (a 0-d f32 tensor); at or
below `MAX_FREE_BOUND` the forward runs the max-free variant. On the card
the bound stays on the device and each CTA branches on it, so no step
waits on it; `max_free_launches()` reads how many launches took that
variant. The forward's CTAs also count the k tiles they walk, and those
they walk without the per-element mask (`fwd_tiles_walked()`);
`fwd_tile_plan` says which tiles one launch should walk.

Non-causal attention (`causal=False`: key m visible to query l iff
seg[l] == seg[m] != 0, JAX `_tile_mask`), the bidirectional attention of
the vision towers (Qwen3-VL-4B's and InternViT's heads of 64, Qwen3-VL-8B's
of 72), runs in the kernels at (64, 64) and (72, 72) (`NONCAUSAL_DIMS`):
the forward's and dq's walks go from the first k tile that meets a q
tile's segment range to the last, the dk/dv walk over the same span from
the k tile's side, and a tile whose rows and keys are one document skips
the mask on the diagonal too. (72, 72) runs the 128/128 instantiations
over 72-column tensors, in place: TMA zero-fills columns 72-127 of each
tile and the stores drop them (`csrc/flash_fwd.cu`). It is a non-causal
pair only (`NONCAUSAL_ONLY_DIMS`): a causal call there raises, as no
preset needs one. Every other pair raises with `causal=False` on a CUDA
tensor (ROADMAP.md Queue 2 A1), as does a window with `causal=False`; the
plain versions take both everywhere.

Not ported yet: a window in the backward at 128/128 and 256/256 (no
preset trains with one).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ... import not_ported
from .reference import make_attention_mask

NEG_INF = -1e30
BIG_LSE = 1e30  # lse sentinel for rows that see no key (padding)
# the (D, Dv) pairs the forward takes, and the backward
KERNEL_DIMS = ((128, 128), (192, 128), (64, 64), (256, 256), (72, 72))
BWD_KERNEL_DIMS = ((128, 128), (192, 128), (64, 64), (256, 256), (72, 72))
ONE_PASS_DIMS = (128, 128)  # the backward pair that runs the one pass (no window)
NO_WINDOW_BWD_DIMS = (ONE_PASS_DIMS, (256, 256))  # backward pairs built without a window
NONCAUSAL_DIMS = ((64, 64), (72, 72))  # the pairs whose kernels take causal=False
NONCAUSAL_ONLY_DIMS = ((72, 72),)  # and those that take nothing else
# |scaled logit| bound at or below which the max-free forward is exact in
# f32 (flash.py MAX_FREE_BOUND): exp(45) is far inside the f32 range
MAX_FREE_BOUND = 45.0


def _grouped(q, k):
    b, l, hq, d = q.shape
    hkv = k.shape[2]
    return q.float().reshape(b, l, hkv, hq // hkv, d)


def _probs(q, k, segment_ids, scale, lse=None, max_free=False, window=None, causal=True):
    """(B, Hkv, rep, L, L) f32 probabilities and lse (B, Hkv, rep, L, 1)."""
    s = torch.einsum("blgrd,bmgd->bgrlm", _grouped(q, k), k.float()) * scale
    mask = make_attention_mask(segment_ids, causal=causal, window=window)[:, :, None]
    if lse is not None:  # backward: p from the saved lse (padding rows: 1e30)
        return torch.where(mask, torch.exp(s - lse[..., None]), 0.0), lse[..., None]
    if max_free:
        p = torch.where(mask, torch.exp(s), 0.0)
        denom = p.sum(dim=-1, keepdim=True)
        lse = torch.log(denom.clamp(min=1e-37))
    else:
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        lse = m + torch.log(denom.clamp(min=1e-37))
    lse = torch.where(denom > 0, lse, torch.full_like(lse, BIG_LSE))
    return p / denom.clamp(min=1e-37), lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, scale: float,
                          max_free: bool = False, window: Optional[int] = None,
                          causal: bool = True):
    """Plain version of the forward: fp32 masked softmax over the whole
    (L, L) score matrix, with the row max (running-max variant) or without
    it (`max_free`, exact when |scaled logit| <= MAX_FREE_BOUND); with a
    `window`, key m is visible to query l only if l - m < window; without
    `causal`, every key of l's document is.
    q: (B, L, Hq, D); k: (B, L, Hkv, D); v: (B, L, Hkv, Dv); segment_ids:
    (B, L). Returns out (B, L, Hq, Dv) in q.dtype, lse (B, Hq, L) fp32."""
    b, l, hq, _ = q.shape
    p, lse = _probs(q, k, segment_ids, scale, max_free=max_free, window=window, causal=causal)
    out = torch.einsum("bgrlm,bmgd->blgrd", p, v.float())
    return out.reshape(b, l, hq, v.shape[-1]).to(q.dtype), lse.reshape(b, hq, l)


def flash_dq_plain(q, k, v, segment_ids, lse, delta, do, scale, window=None,
                   causal=True):
    """Plain version of `_dq_kernel`: dq (B, L, Hq, D) in q.dtype from the
    saved lse and delta (B, Hq, L); do is (B, L, Hq, Dv); with a `window`,
    key m counts for query l only if l - m < window; without `causal`,
    every key of l's document does."""
    b, l, hq, d = q.shape
    hkv = k.shape[2]
    p, _ = _probs(q, k, segment_ids, scale, lse.reshape(b, hkv, hq // hkv, l),
                  window=window, causal=causal)
    dog = do.float().reshape(b, l, hkv, hq // hkv, v.shape[-1])
    dp = torch.einsum("blgrd,bmgd->bgrlm", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, hq // hkv, l)[..., None])
    dq = torch.einsum("bgrlm,bmgd->blgrd", ds, k.float()) * scale
    return dq.reshape(b, l, hq, d).to(q.dtype)


def flash_dkv_plain(q, k, v, segment_ids, lse, delta, do, scale, window=None,
                    causal=True):
    """Plain version of `_dkv_grouped_kernel`: dk (B, L, Hkv, D) and dv
    (B, L, Hkv, Dv) summed over each kv head's q-head group, in k.dtype /
    v.dtype."""
    b, l, hq, _ = q.shape
    hkv = k.shape[2]
    p, _ = _probs(q, k, segment_ids, scale, lse.reshape(b, hkv, hq // hkv, l),
                  window=window, causal=causal)
    dog = do.float().reshape(b, l, hkv, hq // hkv, v.shape[-1])
    dv = torch.einsum("bgrlm,blgrd->bmgd", p, dog)
    dp = torch.einsum("blgrd,bmgd->bgrlm", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, hq // hkv, l)[..., None])
    dk = torch.einsum("bgrlm,blgrd->bmgd", ds, _grouped(q, k)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dkv_two_pass_plain(q, k, v, segment_ids, lse, delta, do, scale, window=None,
                             causal=True):
    """Plain version of `_dkv_kernel`: dk_h (B, L, Hq, D) and dv_h (B, L,
    Hq, Dv) of each q head, not summed over the group, in q.dtype; dk_h
    scaled."""
    b, l, hq, d = q.shape
    hkv, dv_dim = k.shape[2], v.shape[-1]
    p, _ = _probs(q, k, segment_ids, scale, lse.reshape(b, hkv, hq // hkv, l),
                  window=window, causal=causal)
    dog = do.float().reshape(b, l, hkv, hq // hkv, dv_dim)
    dv = torch.einsum("bgrlm,blgrd->bmgrd", p, dog)
    dp = torch.einsum("blgrd,bmgd->bgrlm", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, hq // hkv, l)[..., None])
    dk = torch.einsum("bgrlm,blgrd->bmgrd", ds, _grouped(q, k)) * scale
    return dk.reshape(b, l, hq, d).to(q.dtype), dv.reshape(b, l, hq, dv_dim).to(q.dtype)


def group_sum(t_h: torch.Tensor, hkv: int, dtype) -> torch.Tensor:
    """(B, L, Hq, X) per-q-head partials -> (B, L, Hkv, X), summed over each
    kv head's q-head group (JAX `_flash_bwd_rule`'s sum after `_dkv_kernel`);
    X is D for dk, Dv for dv."""
    b, l, hq, x = t_h.shape
    return t_h.reshape(b, l, hkv, hq // hkv, x).sum(dim=3).to(dtype)


def _check_kernel_args(q, k, v, segment_ids, name="flash_attention", dims=KERNEL_DIMS):
    if not (k.device == v.device == segment_ids.device == q.device):
        raise ValueError(f"{name}: q, k, v, segment_ids on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, L, H, D) and v (B, L, Hkv, Dv)")
    b, l, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != l or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if segment_ids.shape != (b, l) or segment_ids.dtype != torch.int32:
        raise ValueError(f"{name}: segment_ids must be (B, L) int32")
    if (d, v.shape[3]) not in dims:
        raise ValueError(f"{name} kernel: (head_dim, v head_dim) {(d, v.shape[3])} not in "
                         f"{dims}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: {n} is {t.dtype}, want bfloat16")
    for n, t in (("q", q), ("k", k), ("v", v), ("segment_ids", segment_ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {n} must be contiguous and 16-byte aligned")
    if l == 0 or b == 0:
        raise ValueError(f"{name} kernel: empty input")


def _check_bwd_args(q, k, v, segment_ids, lse, delta, do, name, window=None):
    _check_kernel_args(q, k, v, segment_ids, name, BWD_KERNEL_DIMS)
    if window and (q.shape[3], v.shape[3]) in NO_WINDOW_BWD_DIMS:
        raise ValueError(f"{name} kernel: the backward at {(q.shape[3], v.shape[3])} takes no "
                         f"sliding window")
    b, l, hq, _ = q.shape
    want = (b, l, hq, v.shape[3])
    if do.shape != want or do.dtype != torch.bfloat16 or not do.is_contiguous():
        raise ValueError(f"{name} kernel: do must be a contiguous bfloat16 {want}")
    for n, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, l) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {n} must be contiguous float32 (B, Hq, L)")
        if t.device != q.device:
            raise ValueError(f"{name}: {n} on another device")


_MAX_FREE_COUNT: dict = {}  # device -> int32 count of max-free launches
_TILE_COUNT: dict = {}  # device -> int64 [k tiles walked, full ones], summed over CTAs


def _max_free_counter(device) -> torch.Tensor:
    if device not in _MAX_FREE_COUNT:
        _MAX_FREE_COUNT[device] = torch.zeros((), dtype=torch.int32, device=device)
    return _MAX_FREE_COUNT[device]


def _tile_counter(device) -> torch.Tensor:
    if device not in _TILE_COUNT:
        _TILE_COUNT[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TILE_COUNT[device]


def max_free_launches() -> int:
    """Forward launches that took the max-free variant since the last
    `reset_launches()` (reads the device counters: synchronizes)."""
    return sum(int(c.item()) for c in _MAX_FREE_COUNT.values())


def fwd_tiles_walked() -> tuple[int, int]:
    """(k tiles walked, of which full) by the forward kernel's CTAs, one
    per (q tile, q head, batch row), since the last `reset_launches()`
    (reads the device counters: synchronizes). `fwd_tile_plan` says which
    tiles one launch should walk."""
    walked = full = 0
    for c in _TILE_COUNT.values():
        w, f = c.tolist()
        walked, full = walked + w, full + f
    return walked, full


def reset_launches() -> None:
    """Zero the launch counters of the flash kernels."""
    flash_attention.launches = flash_attention.noncausal_launches = 0
    flash_attention.noncausal_by_dim = {}
    flash_bwd.launches = {"grouped": 0, "two_pass": 0}
    flash_bwd.noncausal_launches = {"grouped": 0, "two_pass": 0}
    flash_bwd.noncausal_by_dim = {}
    for c in (*_MAX_FREE_COUNT.values(), *_TILE_COUNT.values()):
        c.zero_()


KEY_TILE = 128  # key rows of a backward CTA and q/k rows of a forward tile; Lp pads L to it
TILE_ROWS = 64  # rows of one entry of the tile table (the backward's q tile)
WIDE_DIMS = (256, 256)  # the forward pair that walks 64-key tiles (O of 64 x 256 in registers)


def fwd_key_tile(d: int, dv: int) -> int:
    """Key rows of one k tile of the forward kernel at (D, Dv): 128, or 64
    at (256, 256), where a 128-key S tile would not fit beside O."""
    return TILE_ROWS if (d, dv) == WIDE_DIMS else KEY_TILE


def _tile_table(seg_p: torch.Tensor) -> torch.Tensor:
    """(B, Lp / 64, 4) int32 over 64-row tiles of the padded segment ids:
    the lowest non-zero id (int32 max if none), the highest (0 if none),
    the id if the tile holds one document and no padding (else 0), 0."""
    t = seg_p.view(seg_p.shape[0], -1, TILE_ROWS)
    hi = t.amax(-1)
    lo = t.masked_fill(t == 0, torch.iinfo(torch.int32).max).amin(-1)
    uni = torch.where(t.amin(-1) == hi, hi, torch.zeros_like(hi))
    return torch.stack([lo, hi, uni, torch.zeros_like(hi)], dim=-1).contiguous()


def fwd_tile_plan(segment_ids: torch.Tensor, window: Optional[int] = None,
                  key_tile: int = KEY_TILE,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Which k tiles the forward kernel walks for each q tile, from the
    padded segment ids and their tile table, which the kernel builds the
    same way (for counts and tests only; nothing computes attention from
    it). q tiles are KEY_TILE rows, k tiles `key_tile` rows (KEY_TILE, or
    64 at (256, 256): `fwd_key_tile`). Returns (walk, full), (B, nq, nk)
    bool over (q tile i, k tile j): walked iff the k tile starts at or
    before the q tile's last row (with `causal`), its segment range meets
    the q tile's and, with a `window`, its last key is inside the window
    of the q tile's first row; full (no per-element mask, JAX
    `_tile_full`) iff walked, the k tile ends before the q tile starts
    (with `causal`), both tiles hold one and the same document and no
    padding, and, with a window, every pair is inside it. Without
    `causal` a q tile walks from the first k tile that holds one of its
    documents to the last."""
    pad = -segment_ids.shape[1] % KEY_TILE
    t = _tile_table(torch.nn.functional.pad(segment_ids, (0, pad)))
    b = t.shape[0]
    qt = t.view(b, -1, 2, 4)
    lo, hi = qt[..., 0].amin(-1), qt[..., 1].amax(-1)
    uni = torch.where(qt[:, :, 0, 2] == qt[:, :, 1, 2], qt[:, :, 0, 2], torch.zeros_like(lo))
    kt = t.view(b, -1, key_tile // TILE_ROWS, 4)
    klo, khi = kt[..., 0].amin(-1), kt[..., 1].amax(-1)
    kuni = torch.where(kt[..., 2].amin(-1) == kt[..., 2].amax(-1), kt[:, :, 0, 2],
                       torch.zeros_like(klo))
    dev = lo.device
    q0 = KEY_TILE * torch.arange(lo.shape[1], device=dev)[None, :, None]
    k0 = key_tile * torch.arange(klo.shape[1], device=dev)[None, None, :]
    walk = (khi[:, None, :] >= lo[:, :, None]) & (klo[:, None, :] <= hi[:, :, None])
    full = walk & (kuni[:, None, :] != 0) & (kuni[:, None, :] == uni[:, :, None])
    if causal:
        walk = walk & (k0 <= q0 + KEY_TILE - 1)  # (1, i, j)
        full = full & walk & (k0 + key_tile <= q0)
    if window:
        walk = walk & (k0 + key_tile - 1 > q0 - window)  # the last key vs the first row
        full = full & (q0 + KEY_TILE - 1 - k0 < window)  # the last row vs the first key
    return walk, full


def fwd_outputs(q: torch.Tensor, v: torch.Tensor):
    """The forward kernel's outputs, on q's device: out (B, L, Hq, Dv) in
    q.dtype, lse (B, Hq, L) f32, and the scratch of the tile table (B, Lp /
    64, 4) int32 that its first launch builds."""
    b, l, hq, _ = q.shape
    out = q.new_empty((b, l, hq, v.shape[-1]))
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    tiles = torch.empty((b, -(-l // KEY_TILE) * (KEY_TILE // TILE_ROWS), 4),
                        dtype=torch.int32, device=q.device)
    return out, lse, tiles


def _check_causal(q, v, window, causal: bool, name: str) -> None:
    """A CUDA call with `causal=False` needs a pair of `NONCAUSAL_DIMS` and
    no window; a causal one a pair outside `NONCAUSAL_ONLY_DIMS`."""
    if causal:
        if (q.shape[3], v.shape[3]) in NONCAUSAL_ONLY_DIMS:
            raise not_ported(f"causal {name} at (head_dim, v head_dim) "
                             f"{(q.shape[3], v.shape[3])} (its kernels are built non-causal "
                             f"only: no preset needs it)", "train-slice")
        return
    if (q.shape[3], v.shape[3]) not in NONCAUSAL_DIMS:
        raise not_ported(f"non-causal {name} at (head_dim, v head_dim) "
                         f"{(q.shape[3], v.shape[3])} (Queue 2 A1; the kernels take "
                         f"{NONCAUSAL_DIMS})", "train-slice")
    if window:
        raise not_ported(f"non-causal {name} with a sliding window", "train-slice")


def flash_forward(q, k, v, segment_ids, scale: float,
                  max_logit: Optional[torch.Tensor] = None, window: Optional[int] = None,
                  causal: bool = True):
    """The forward kernel (#1, both variants): (out (B, L, Hq, Dv) in
    q.dtype, lse (B, Hq, L) fp32); rows that see no key get out 0 and lse
    1e30. With a `window` (> 0), key m is visible to query l only if l - m
    < window; without `causal`, every key of l's document is. On the CPU
    the variant is read from `max_logit` directly."""
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive (None: full)")
    if q.device.type == "cpu":
        max_free = max_logit is not None and float(max_logit) <= MAX_FREE_BOUND
        return flash_attention_plain(q, k, v, segment_ids, scale, max_free, window, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_args(q, k, v, segment_ids)
    _check_causal(q, v, window, causal, "flash_attention")
    bound = None
    if max_logit is not None:
        if max_logit.device != q.device or max_logit.numel() != 1:
            raise ValueError("flash_attention: max_logit must be one value on q's device")
        bound = max_logit.detach().reshape(()).to(torch.float32).contiguous()
    from ..cuda_lib import check, load

    b, l, hq, d = q.shape
    out, lse, tiles = fwd_outputs(q, v)
    err = load().xt_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), tiles.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, l, hq, k.shape[2], d, v.shape[3],
        float(scale), int(window or 0), int(causal),
        None if bound is None else bound.data_ptr(),
        _max_free_counter(q.device).data_ptr(), _tile_counter(q.device).data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_flash_fwd_bf16")
    flash_attention.launches += 1
    if not causal:
        flash_attention.noncausal_launches += 1
        flash_attention.noncausal_by_dim[d] = flash_attention.noncausal_by_dim.get(d, 0) + 1
    return out, lse


def fold_sinks(out: torch.Tensor, lse: torch.Tensor, sinks: torch.Tensor):
    """Fold per-head sink logits (Hq,) into the forward's out (B, L, Hq,
    Dv) and lse (B, Hq, L), as JAX `_flash_forward` does after its kernel:
    lse' = log(exp(lse) + exp(sink)), out' = out exp(lse - lse'). Rows that
    saw no key (out 0, lse 1e30) keep out 0 and lse 1e30."""
    if sinks.shape != (lse.shape[1],):
        raise ValueError(f"sinks {tuple(sinks.shape)}: want one per q head, "
                         f"({lse.shape[1]},)")
    lse_new = torch.logaddexp(lse, sinks.float()[None, :, None])
    scale = torch.exp(lse - lse_new).transpose(1, 2)[..., None]  # (B, L, Hq, 1)
    return (out.float() * scale).to(out.dtype), lse_new


def flash_bwd_plain(q, k, v, segment_ids, lse, delta, do, scale, two_pass=False,
                    window=None, causal=True):
    """Plain version of `flash_bwd`: `flash_dq_plain` with
    `flash_dkv_plain` (grouped) or `flash_dkv_two_pass_plain`."""
    dq = flash_dq_plain(q, k, v, segment_ids, lse, delta, do, scale, window, causal)
    dkv = flash_dkv_two_pass_plain if two_pass else flash_dkv_plain
    return (dq, *dkv(q, k, v, segment_ids, lse, delta, do, scale, window, causal))


def bwd_outputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, two_pass: bool):
    """The backward's dk and dv, on q's device: (B, L, Hkv, D) and (B, L,
    Hkv, Dv) in k's and v's dtype, or with `two_pass` (B, L, Hq, D) and
    (B, L, Hq, Dv) in q's."""
    if not two_pass:
        return torch.empty_like(k), torch.empty_like(v)
    b, l, hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, l, hq, v.shape[-1]))


def flash_bwd(q, k, v, segment_ids, lse, delta, do, scale: float, two_pass: bool = False,
              window: Optional[int] = None, causal: bool = True):
    """The backward kernels (#2 with #3, or with #4 when `two_pass`): dq
    (B, L, Hq, D) in q.dtype and dk (B, L, Hkv, D), dv (B, L, Hkv, Dv)
    summed over each kv head's q-head group, or with `two_pass` dk_h, dv_h
    (B, L, Hq, D / Dv) of each q head in q.dtype, not summed (`group_sum`
    sums them). With a `window` (> 0), key m counts for query l only if l
    - m < window; without `causal`, every key of l's document counts
    (at (64, 64) and (72, 72) only on a CUDA tensor). lse is the
    forward's, with any sinks folded in. At head
    dim 128 one pass adds dq into a zeroed f32 accumulator by bulk
    reduce-adds, so dq's summation order changes from run to run; dk and
    dv's does not; it takes no window. At (192, 128), (64, 64), (256, 256)
    and (72, 72) a dq kernel and a dk/dv kernel write every output once
    (the same bits run after run); the two launches count as one; 256/256
    takes no window."""
    if window is not None and window <= 0:
        raise ValueError(f"flash_bwd: window {window} must be positive (None: full)")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, segment_ids, lse, delta, do, scale, two_pass, window,
                               causal)
    _check_bwd_args(q, k, v, segment_ids, lse, delta, do, "flash_bwd", window)
    _check_causal(q, v, window, causal, "flash_bwd")
    from ..cuda_lib import check, load

    b, l, hq, d = q.shape
    pad = -l % KEY_TILE
    if pad:  # the kernels read lse, delta and segment ids in whole tiles
        segment_ids, lse, delta = (torch.nn.functional.pad(t, (0, pad))
                                   for t in (segment_ids, lse, delta))
    tiles = _tile_table(segment_ids)
    nq = (l + pad) // TILE_ROWS
    one_pass = (d, v.shape[3]) == ONE_PASS_DIMS
    if one_pass:
        dq = torch.zeros((b, hq, nq, 2, 4, 8, 8, 4, 2, 2), dtype=torch.float32, device=q.device)
    else:
        dq = torch.empty_like(q)
    dk, dv = bwd_outputs(q, k, v, two_pass)
    err = load().xt_flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), segment_ids.data_ptr(), tiles.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, l, l + pad, hq, k.shape[2], d, v.shape[3],
        float(scale), int(two_pass), int(window or 0), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_flash_bwd_bf16")
    kind = "two_pass" if two_pass else "grouped"
    flash_bwd.launches[kind] += 1
    if not causal:
        flash_bwd.noncausal_launches[kind] += 1
        flash_bwd.noncausal_by_dim[kind, d] = flash_bwd.noncausal_by_dim.get((kind, d), 0) + 1
    if not one_pass:
        return dq, dk, dv
    # the accumulator's blocks hold (b, h, q tile, column half, warp, j,
    # row % 8, column pair, row half, column parity): one copy puts them in
    # (B, Lp, Hq, D) order, in q.dtype
    out = torch.empty((b, nq, 4, 2, 8, hq, 2, 8, 4, 2), dtype=q.dtype, device=q.device)
    out.copy_(dq.permute(0, 2, 4, 8, 6, 1, 3, 5, 7, 9))
    out = out.view(b, l + pad, hq, d)
    return (out[:, :l].contiguous() if pad else out), dk, dv


flash_bwd.launches = {"grouped": 0, "two_pass": 0}  # launches since the last reset
flash_bwd.noncausal_launches = {"grouped": 0, "two_pass": 0}  # of which causal=False
flash_bwd.noncausal_by_dim = {}  # those by (path, head dim)


def attn_bwd() -> str:
    """The dk/dv path `XTUNER_ATTN_BWD` selects: "grouped" (the default)
    or, for any other value, as in JAX, the two-pass kernel."""
    return os.environ.get("XTUNER_ATTN_BWD", "grouped")


def flash_backward(q, k, v, segment_ids, out, lse, dout, scale: float, bwd: str,
                   window: Optional[int] = None, sinks: Optional[torch.Tensor] = None,
                   causal: bool = True):
    """dq, dk, dv and dsinks (None without sinks) from the forward's
    residuals (JAX `_flash_bwd_rule`): delta in plain PyTorch from the
    folded out, then the backward kernels on the folded lse, grouped
    (`bwd == "grouped"`) or per q head and the group sum; dsinks =
    -sum over batch and rows of exp(sinks - lse) delta, in sinks.dtype."""
    do = dout.to(q.dtype).contiguous()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    two_pass = bwd != "grouped"
    dq, dk, dv = flash_bwd(q, k, v, segment_ids, lse, delta, do, scale, two_pass, window,
                           causal)
    if two_pass:
        dk, dv = group_sum(dk, k.shape[2], k.dtype), group_sum(dv, k.shape[2], v.dtype)
    dsinks = None
    if sinks is not None:
        p_sink = torch.exp(sinks.float()[None, :, None] - lse)  # (B, Hq, L)
        dsinks = -(p_sink * delta).sum(dim=(0, 2)).to(sinks.dtype)
    return dq, dk, dv, dsinks


class _FlashAttention(torch.autograd.Function):
    """`_flash`'s custom VJP over `(q, k, v, max_logit, sinks) =
    qkv_fn(*inputs)` (sinks None or (Hq,)). The residuals are `inputs`,
    segment_ids, out and lse (sinks folded in); lse is not differentiable
    (the JAX rule ignores its cotangent too). The forward runs `qkv_fn`
    without grad and the flash forward with the `window`, then folds the
    sinks in; the backward re-runs `qkv_fn` with grad (a pass-through when
    `inputs` are q, k, v and the sinks), runs the backward kernels with the
    window and the causal flag on the saved out and lse along the dk/dv
    path read when the forward ran, and backpropagates dq, dk, dv and
    dsinks through `qkv_fn`. The flash forward never re-runs."""

    @staticmethod
    def forward(ctx, qkv_fn, segment_ids, scale, window, causal, *inputs):
        with torch.no_grad():
            q, k, v, max_logit, sinks = qkv_fn(*inputs)
            out, lse = flash_forward(q, k, v, segment_ids, scale, max_logit, window, causal)
            if sinks is not None:
                out, lse = fold_sinks(out, lse, sinks)
        ctx.save_for_backward(segment_ids, out, lse, *inputs)
        ctx.qkv_fn, ctx.scale, ctx.bwd, ctx.window = qkv_fn, scale, attn_bwd(), window
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        segment_ids, out, lse, *inputs = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        with torch.enable_grad():
            q, k, v, _, sinks = ctx.qkv_fn(*leaves)
        grads = flash_backward(q.detach(), k.detach(), v.detach(), segment_ids, out, lse,
                               dout, ctx.scale, ctx.bwd, ctx.window,
                               None if sinks is None else sinks.detach(), ctx.causal)
        made = [(t, g) for t, g in zip((q, k, v, sinks), grads)
                if t is not None and t.requires_grad]
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad([t for t, _ in made], want, [g for _, g in made],
                                       allow_unused=True))
        return (None, None, None, None, None,
                *(next(got) if t.requires_grad else None for t in leaves))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None, window=None, sinks=None,
                    max_logit: Optional[torch.Tensor] = None):
    """q, k: (B, L, Hq / Hkv, D); v: (B, L, Hkv, Dv); segment_ids (B, L)
    int32 (0 = padding); max_logit: optional proven |scaled logit| bound;
    window: a sliding window (None: full); sinks: optional (Hq,) per-head
    sink logits; causal: False for bidirectional attention within each
    document (the kernels at `NONCAUSAL_DIMS`). Returns (out (B, L, Hq,
    Dv) in q.dtype, lse (B, Hq, L) fp32, both with the sinks folded in);
    rows that see no key get out 0 and lse 1e30. Differentiable in q, k,
    v and the sinks."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(
        lambda q_, k_, v_, *s: (q_, k_, v_, max_logit, s[0] if s else None), segment_ids,
        float(scale), window, bool(causal), *((q, k, v) if sinks is None else (q, k, v, sinks)))


def flash_attention_saving_out_lse(qkv_fn, inputs, segment_ids: torch.Tensor, *,
                                   scale: float, window: Optional[int] = None):
    """Causal flash attention over `(q, k, v, max_logit, sinks) =
    qkv_fn(*inputs)` (the layer of remat "save_out_lse"): returns (out,
    lse) as `flash_attention` does, keeps only `inputs`, out and lse for
    the backward, and re-runs `qkv_fn` there. Differentiable in `inputs`."""
    return _FlashAttention.apply(qkv_fn, segment_ids, float(scale), window, True, *inputs)


# forward kernel launches (either variant) since the last reset, of those
# the non-causal ones, and those by head dim; counted by flash_forward, read
# under the public entry's name
flash_attention.launches = flash_attention.noncausal_launches = 0
flash_attention.noncausal_by_dim = {}
