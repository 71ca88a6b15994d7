"""Paged-attention decode (counterpart:
`xtuner_tpu/ops/attention/paged_decode.py`, TPU kernel `_kernel`).

`paged_decode_attn` has the signature of the JAX `paged_decode_attn` and
returns f32. On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/paged_decode.cu` (head dim 64, 128 or 256) or raises; on a CPU tensor it
runs `paged_decode_attn_plain`, the gather-based plain version beside it
(the same math as the JAX engine's gather path, `paged_generate.py:345-402`).

A sliding window (`window` > 0: chunk token i sees slot s only if seq_len +
i - s < window; None or <= 0: full, as JAX reads a traced window) and
per-head sinks (`sinks`, (Hq,): a logit in each row's softmax denominator
that weights no value) are taken as JAX's kernel takes them: the walk
starts at JAX's `_start_block`, the block of the first slot any row can
see, and the sinks join each row's softmax once, after the runs merge.

The kernel splits each (slot, kv head)'s blocks in the window into
`splits` runs of whole blocks (`paged_decode_split_plan`, from the shapes
alone, over at most `max_window_blocks` blocks with a window; each slot
cuts its own blocks evenly on the device, `paged_decode_splits`), computes
a partial softmax per run and merges the runs in order. Its work order in
plain torch, for the tests only: `paged_decode_walk` (the blocks each
split loads) and `paged_decode_split_plain` (the partials and the ordered
merge).

The current chunk's K/V must already be in the pool.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # the head dims the kernel takes
MAX_ROWS = 16  # C * (Hq / Hkv) query rows per CTA: one m16 tile
MAX_BLOCK = 256  # pool block size bound (a TMA box has at most 256 rows)
SPLIT_CTAS_PER_SM = 2  # the split plan's aim, were every table full
MAX_SPLITS = 256  # the kernel merges at most this many splits


def _window(window) -> int:
    """A window as the kernel takes it: > 0, or 0 for full attention (None
    or <= 0, as JAX reads a traced per-layer window)."""
    return int(window) if window is not None and int(window) > 0 else 0


def start_block(seq_len: int, window, bs: int) -> int:
    """JAX `_start_block`: the first block any row of the chunk can see,
    floor(max(seq_len + 1 - window, 0) / BS) with a window, else 0."""
    w = _window(window)
    return max(seq_len + 1 - w, 0) // bs if w else 0


def max_window_blocks(window, c: int, bs: int) -> int:
    """The most blocks a slot's chunk of C tokens can see through a window
    (its slots span window + C - 1, on either side of a block edge)."""
    return (_window(window) + c - 2) // bs + 2


def _softmax_sinks(logits: torch.Tensor, sinks: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last dim of (B, Hq, C, S) logits, with the per-head
    sink logits (Hq,) in the denominator (JAX's gather path)."""
    if sinks is None:
        return torch.softmax(logits, dim=-1)
    sink = sinks.float()[None, :, None, None]
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), sink)
    e = torch.exp(logits - m)
    return e / (e.sum(dim=-1, keepdim=True) + torch.exp(sink - m))


def paged_decode_attn_plain(q, pool_k, pool_v, layer: int, block_table,
                            seq_lens, *, scale: float, window=None,
                            sinks=None) -> torch.Tensor:
    """Gather every table entry's block, mask slots > seq_len + i (and with
    a window slots <= seq_len + i - window), fp32 softmax with the sinks.
    Returns (B, C, Hq, D) f32."""
    b, c, hq, d = q.shape
    _, _, bs, hkv, _ = pool_k.shape
    mb = block_table.shape[1]
    rep = hq // hkv
    idx = block_table.long()
    kk = pool_k[layer][idx].reshape(b, mb * bs, hkv, d).float()
    vv = pool_v[layer][idx].reshape(b, mb * bs, hkv, d).float()
    qg = q.float().reshape(b, c, hkv, rep, d)
    logits = torch.einsum("bcgrd,bsgd->bgrcs", qg, kk) * scale
    slot = torch.arange(mb * bs, device=q.device)
    qpos = seq_lens.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = slot[None, None, :] <= qpos[:, :, None]  # (B, C, S)
    w = _window(window)
    if w:
        valid = valid & (qpos[:, :, None] - slot[None, None, :] < w)
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    probs = _softmax_sinks(logits.reshape(b, hq, c, mb * bs), sinks)
    o = torch.einsum("bgrcs,bsgd->bcgrd", probs.reshape(b, hkv, rep, c, mb * bs), vv)
    return o.reshape(b, c, hq, d)


def paged_decode_split_plan(b: int, hkv: int, mb: int, sms: int) -> int:
    """Splits per (slot, kv head): about SPLIT_CTAS_PER_SM CTAs per SM if
    every table held MB blocks (with a window, the wrapper passes
    `max_window_blocks` as MB), at most MB (and MAX_SPLITS). From the
    shapes alone: the host never reads seq_lens."""
    return max(1, min(mb, MAX_SPLITS, -(-SPLIT_CTAS_PER_SM * sms // (b * hkv))))


def paged_decode_splits(n_blk: int, splits: int, start: int = 0) -> list[tuple[int, int]]:
    """The kernel's cut of one slot's table entries [start, n_blk) into
    runs [t0, t1) of ceil((n_blk - start) / splits) whole blocks; one
    empty run when the slot has no block there (it writes zeros)."""
    start = min(start, n_blk)
    per = max(1, -(-(n_blk - start) // splits))
    return [(t0, min(t0 + per, n_blk)) for t0 in range(start, max(n_blk, start + 1), per)]


def paged_decode_walk(block_table, seq_lens, c: int, bs: int, nb: int,
                      splits: int, window=None) -> list[list[list[tuple[int, int]]]]:
    """Per slot, per split, the (table entry, pool block) pairs the kernel's
    CTAs load, in order: entries [start_block, min(ceil((seq_len + C) /
    BS), MB)), those < 0 or >= NB skipped. The same for every kv head."""
    table = block_table.tolist()
    walks = []
    for row, n in zip(table, seq_lens.tolist()):
        n_blk = max(0, min(-(-(n + c) // bs), len(row)))
        walks.append([[(t, row[t]) for t in range(t0, t1) if 0 <= row[t] < nb]
                      for t0, t1 in paged_decode_splits(n_blk, splits,
                                                        start_block(n, window, bs))])
    return walks


def paged_decode_split_plain(q, pool_k, pool_v, layer: int, block_table, seq_lens, *,
                             scale: float, splits: int, window=None,
                             sinks=None) -> torch.Tensor:
    """The kernel's work order in plain torch (f32): per slot the runs of
    `paged_decode_walk`, each a partial softmax in base 2 (running max m,
    sum l, unnormalised O over its slots < seq_len + C, row i of the chunk
    seeing slots <= seq_len + i and, with a window, > seq_len + i -
    window), merged in run order; then each row's sink (base 2) joins the
    max and the sum once. Returns (B, C, Hq, D) f32."""
    b, c, hq, d = q.shape
    _, nb, bs, hkv, _ = pool_k.shape
    rep = hq // hkv
    w = _window(window)
    # (B, Hkv, rows, D), row r = i * rep + j: chunk token i, head g * rep + j
    qg = q.float().reshape(b, c, hkv, rep, d).permute(0, 2, 1, 3, 4).reshape(b, hkv, c * rep, d)
    sl2 = scale * math.log2(math.e)
    # per (kv head, row) the sink in base 2 (row r: head g * rep + r % rep)
    sk = None if sinks is None else \
        (sinks.float().reshape(hkv, 1, rep) * math.log2(math.e)).expand(hkv, c, rep) \
        .reshape(hkv, c * rep)
    out = torch.zeros((b, hkv, c * rep, d), dtype=torch.float32, device=q.device)
    walks = paged_decode_walk(block_table.cpu(), seq_lens.cpu(), c, bs, nb, splits, window)
    for bi, walk in enumerate(walks):
        n = int(seq_lens[bi])
        lim = n + torch.arange(c * rep, device=q.device) // rep  # last slot each row sees
        parts = []
        for run in walk:
            slots = torch.tensor([t * bs + s for t, _ in run for s in range(bs)],
                                 dtype=torch.long, device=q.device)
            blks = torch.tensor([blk for _, blk in run], dtype=torch.long, device=q.device)
            k = pool_k[layer][blks].reshape(-1, hkv, d).float()
            v = pool_v[layer][blks].reshape(-1, hkv, d).float()
            keep = slots < n + c  # right-pad past the chunk is never read
            slots, k, v = slots[keep], k[keep], v[keep]
            s = torch.einsum("grd,sgd->grs", qg[bi], k) * sl2
            valid = slots[None, None, :] <= lim[None, :, None]
            if w:
                valid = valid & (slots[None, None, :] > lim[None, :, None] - w)
            s = s.masked_fill(~valid, NEG_INF)
            m = s.amax(dim=-1) if s.shape[-1] else \
                torch.full(s.shape[:2], NEG_INF, device=q.device)
            p = torch.where(valid, torch.exp2(s - m[..., None]), 0.0)
            parts.append((m, p.sum(dim=-1), torch.einsum("grs,sgd->grd", p, v)))
        if len(parts) == 1:
            m, l, o = parts[0]
        else:
            m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
            f = [torch.exp2(pm - m) for pm, _, _ in parts]
            l = sum(pl * fi for (_, pl, _), fi in zip(parts, f))
            o = sum(po * fi[..., None] for (_, _, po), fi in zip(parts, f))
        if sk is not None:
            mn = torch.maximum(m, sk)
            f = torch.exp2(m - mn)
            o, l = o * f[..., None], l * f + torch.exp2(sk - mn)
        out[bi] = torch.where(l[..., None] > 0, o / l[..., None].clamp(min=1e-30), 0.0)
    return out.reshape(b, hkv, c, rep, d).permute(0, 2, 1, 3, 4).reshape(b, c, hq, d)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: dict = {}


def _scratch(dev: torch.device, stream: int, n_tickets: int,
             n_ws: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch for launches on `stream` of `dev`: the
    per-(slot, kv head) merge tickets (int32, zeroed once, left zero by
    every launch: the merging CTA resets its own) and the split workspace
    (f32, torch.empty: each launch writes its partials before it reads
    them). One pair per stream, so launches on two streams never draw each
    other's tickets or share a workspace; launches on one stream run in
    turn. Made once (grown when a launch needs more), not per call: the
    decode loop is host-bound."""
    t, ws = _SCRATCH.get((dev, stream), (None, None))
    if t is None or t.numel() < n_tickets:
        t = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    _SCRATCH[(dev, stream)] = (t, ws)
    return t, ws


def _check_kernel_args(q, pool_k, pool_v, layer, block_table, seq_lens, sinks):
    dev = q.device
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attn: {name} on {t.device}, q on {dev}")
    if q.dim() != 4 or pool_k.dim() != 5 or pool_v.shape != pool_k.shape:
        raise ValueError(f"paged_decode_attn: q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)}: want (B, C, Hq, D), (L, NB, BS, Hkv, D)")
    b, c, hq, d = q.shape
    n_layers, _, bs, hkv, dp = pool_k.shape
    if dp != d or d not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attn kernel: head_dim {d} (pool {dp}), want one of "
                         f"{HEAD_DIMS}")
    if hq % hkv or c * (hq // hkv) > MAX_ROWS:
        raise ValueError(f"paged_decode_attn kernel: C*Hq/Hkv = {c}*{hq}/{hkv} "
                         f"must be whole and <= {MAX_ROWS}")
    if bs % 16 or bs > MAX_BLOCK:
        raise ValueError(f"paged_decode_attn kernel: block size {bs} must be a "
                         f"multiple of 16 and <= {MAX_BLOCK}")
    if not 0 <= layer < n_layers:
        raise ValueError(f"paged_decode_attn: layer {layer} out of [0, {n_layers})")
    if block_table.dim() != 2 or block_table.shape[0] != b or block_table.dtype != torch.int32:
        raise ValueError("paged_decode_attn: block_table must be (B, MB) int32")
    if seq_lens.shape != (b,) or seq_lens.dtype != torch.int32:
        raise ValueError("paged_decode_attn: seq_lens must be (B,) int32")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"paged_decode_attn kernel: {name} is {t.dtype}, want bfloat16")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attn kernel: {name} must be contiguous "
                             f"and 16-byte aligned")
    if sinks is not None and (sinks.device != dev or sinks.shape != (hq,)):
        raise ValueError(f"paged_decode_attn: sinks must be ({hq},) on {dev}")


def paged_decode_attn(q, pool_k, pool_v, layer: int, block_table, seq_lens,
                      *, scale: float, window=None, sinks=None) -> torch.Tensor:
    """q: (B, C, Hq, D); pool_*: (L, NB, BS, Hkv, D); block_table (B, MB)
    int32; seq_lens (B,) int32 — tokens cached BEFORE this chunk (chunk
    token i sits at seq_lens+i and must already be written to the pool);
    window: None | int (<= 0: full); sinks: optional (Hq,) per-head sink
    logits. Returns (B, C, Hq, D) f32."""
    if q.device.type == "cpu":
        return paged_decode_attn_plain(q, pool_k, pool_v, layer, block_table,
                                       seq_lens, scale=scale, window=window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attn: no kernel for device {q.device}")
    if sinks is not None:
        sinks = sinks.detach().float().contiguous()
    _check_kernel_args(q, pool_k, pool_v, layer, block_table, seq_lens, sinks)
    from ..cuda_lib import check, load

    b, c, hq, d = q.shape
    n_layers, nb, bs, hkv, _ = pool_k.shape
    mb = block_table.shape[1]
    w = _window(window)
    mb_walk = min(mb, max_window_blocks(w, c, bs)) if w else mb
    splits = paged_decode_split_plan(b, hkv, mb_walk, _sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((b, c, hq, d), dtype=torch.float32, device=q.device)
    tickets, ws = _scratch(q.device, stream, b * hkv,
                           b * hkv * splits * c * (hq // hkv) * (d + 2))
    err = load().xt_paged_decode_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), b, c, hq, hkv, d, n_layers, nb, bs, mb, int(layer),
        splits, w, float(scale), stream)
    check(err, "xt_paged_decode_bf16")
    paged_decode_attn.launches += 1
    return out


paged_decode_attn.launches = 0  # kernel launches since the last reset
