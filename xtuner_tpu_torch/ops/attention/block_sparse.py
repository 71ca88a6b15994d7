"""Block-sparse flash attention over selected key blocks, the DSA kernel
(counterpart: `xtuner_tpu/ops/attention/block_sparse.py`).

`select_key_blocks` and `select_from_blockmax` pick the top-S key blocks per
q-block; `block_sparse_attention` attends each q-block to its selected
blocks only and is differentiable in q, k and v through
`_BlockSparseAttention` (JAX `_bs_attn`'s custom VJP), whose two wrappers
each launch a hand-written Hopper kernel on a CUDA tensor
(`csrc/block_sparse.cu`) or raise, and run the plain PyTorch version beside
it on a CPU tensor:

- `block_sparse_fwd` (TPU kernel #14, `_fwd_kernel`): out, lse and the
  per-slot attention mass;
- `block_sparse_bwd` (TPU kernel #15, `_bwd_kernel`): dq, dk and dv. The
  card computes `delta = rowsum(do * out)` itself, then dq over each q
  tile's slots and dk/dv directly, one key tile at a time over the q-blocks
  that selected it (an inverse of `block_idx` built on the card), and
  writes each once. JAX writes one partial block per (q-block, slot) and
  scatter-adds them outside the kernel, a TPU workaround for aliased-input
  revisits; only the plain version keeps that form here.

`fwd_walk` and `dkv_walk` are the kernels' work orders in torch (which
64-row tiles each CTA loads, and which of them skip the per-element mask);
`block_sparse_fwd_walk_plain` and `block_sparse_bwd_walk_plain` compute in
f32 in that order, tile by tile, for the CPU tests.

Layouts are JAX's at the public function: q (B, L, Hq, D), k (B, L, Hkv, D),
v (B, L, Hkv, Dv), block_idx (B, L // block, S) int32 ascending with -1 for
an empty slot. A key is visible to a query when it lies in a selected block
of the query's q-block, in the same non-padding document, at or before it.
A row that sees no key gets out 0, lse 1e30 and mass 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash import BIG_LSE, NEG_INF, _tile_table

# the kernels' tiles: q rows of a warpgroup and keys per step; a selection
# block must be a multiple of it
TILE = 64
CTA_ROWS = 128  # q rows of a forward or dq CTA: two 64-row halves; Lp pads L to it
LOG2E = 1.0 / math.log(2.0)
# (D, Dv) pairs the kernels are built for: GLM-5.2's 256/256, DeepSeek's
# 192/128, and 128/128
KERNEL_DIMS = ((256, 256), (192, 128), (128, 128))


def select_key_blocks(scores, block: int, num_sel: int, causal: bool = True):
    """Pool (B, L, L) token-level indexer scores (-inf masked) to blocks and
    pick the top-S key blocks per q-block -> (B, nq, S) int32, ascending,
    -1 = unused slot."""
    b, l, _ = scores.shape
    nq = nk = l // block
    pooled = scores.reshape(b, nq, block, nk, block)
    pooled = torch.where(torch.isfinite(pooled), pooled, float("-inf")).amax(dim=(2, 4))
    return select_from_blockmax(pooled, num_sel, causal=causal)


def select_from_blockmax(pooled, num_sel: int, causal: bool = True):
    """Top-S key blocks per q-block from (B, nq, nk) block-max scores ->
    (B, nq, S) int32, ascending with the -1 slots first. Ties go to the
    lower block index, as `jax.lax.top_k` breaks them."""
    from ..sparse_mla import topk_desc

    b, nq, nk = pooled.shape
    if causal:  # a q-block may only see k-blocks at or before it
        qb = torch.arange(nq, device=pooled.device)[:, None]
        kb = torch.arange(nk, device=pooled.device)[None, :]
        pooled = torch.where(kb <= qb, pooled, float("-inf"))
    s = min(num_sel, nk)
    top, idx = topk_desc(pooled, s)
    idx = torch.where(torch.isfinite(top), idx, -1)
    idx = torch.sort(idx, dim=-1).values
    if s < num_sel:
        idx = torch.nn.functional.pad(idx, (num_sel - s, 0), value=-1)
    return idx.to(torch.int32)


# ---------------------------------------------------------------- plain
def _gather_blocks(t, block_idx, block: int):
    """(B, L, H, X) -> the selected key blocks per q-block,
    (B, H, nq, S * block, X); an empty slot reads block 0 (masked)."""
    b, l, h, x = t.shape
    nq, s = block_idx.shape[1:]
    blocks = t.permute(0, 2, 1, 3).reshape(b, h, l // block, block, x)
    idx = block_idx.clamp(min=0).long().reshape(b, 1, nq * s, 1, 1)
    out = blocks.gather(2, idx.expand(b, h, nq * s, block, x))
    return out.reshape(b, h, nq, s * block, x)


def _visible(block_idx, segment_ids, block: int, causal: bool):
    """(B, nq, block, S * block) bool mask of the gathered keys, and their
    absolute positions (B, nq, S * block)."""
    b, l = segment_ids.shape
    nq, s = block_idx.shape[1:]
    dev = segment_ids.device
    off = torch.arange(block, device=dev)
    kpos = (block_idx.clamp(min=0).long()[..., None] * block + off).reshape(b, nq, s * block)
    kvalid = (block_idx >= 0)[..., None].expand(b, nq, s, block).reshape(b, nq, s * block)
    qpos = torch.arange(l, device=dev).reshape(nq, block)
    qseg = segment_ids.reshape(b, nq, block).long()
    kseg = segment_ids.long().gather(1, kpos.reshape(b, -1)).reshape(b, nq, s * block)
    mask = (kvalid[:, :, None, :] & (qseg[..., None] == kseg[:, :, None, :])
            & (qseg[..., None] != 0))
    if causal:
        mask = mask & (qpos[None, :, :, None] >= kpos[:, :, None, :])
    return mask, kpos


def _head_groups(hq: int, hkv: int):
    ratio = hq // hkv
    return [(h, h // ratio) for h in range(hq)]


def block_sparse_fwd_plain(q, k, v, block_idx, segment_ids, scale: float, block: int,
                           causal: bool = True):
    """Plain version of #14: f32 masked softmax over each q-block's gathered
    key blocks, one q head at a time. Returns out (B, L, Hq, Dv) in q.dtype,
    lse (B, Hq, L) f32 (1e30 where nothing is visible) and mass
    (B, L, Hq, S) f32, the share of each slot's keys in the row's softmax."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    nq, s = block_idx.shape[1:]
    mask, _ = _visible(block_idx, segment_ids, block, causal)
    out = torch.empty((b, l, hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    mass = torch.empty((b, l, hq, s), dtype=torch.float32, device=q.device)
    for h, g in _head_groups(hq, hkv):
        qh = q[:, :, h].float().reshape(b, nq, block, d)
        kh = _gather_blocks(k[:, :, g:g + 1], block_idx, block)[:, 0].float()
        vh = _gather_blocks(v[:, :, g:g + 1], block_idx, block)[:, 0].float()
        sc = torch.einsum("bqtd,bqkd->bqtk", qh, kh) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp(sc - m)
        denom = p.sum(dim=-1, keepdim=True)
        valid = denom > 0
        p = p / denom.clamp(min=1e-37)
        out[:, :, h] = torch.einsum("bqtk,bqkd->bqtd", p, vh).reshape(b, l, dv).to(q.dtype)
        lse[:, h] = torch.where(valid, m + torch.log(denom.clamp(min=1e-37)),
                                BIG_LSE).reshape(b, l)
        mass[:, :, h] = p.reshape(b, nq, block, s, block).sum(-1).reshape(b, l, s)
    return out, lse, mass


def block_sparse_bwd_plain(q, k, v, block_idx, segment_ids, out, lse, do, scale: float,
                           block: int, causal: bool = True):
    """Plain version of #15, JAX's form: p from the saved lse; dq per q-block
    over its slots; dk and dv as one partial block per (q-block, slot),
    scatter-added into (B, L, Hkv, .) and summed over the q-head group.
    Returns dq, dk, dv in the dtypes of q, k, v."""
    b, l, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    nq, s = block_idx.shape[1:]
    mask, kpos = _visible(block_idx, segment_ids, block, causal)
    delta = (do.float() * out.float()).sum(-1)  # (B, L, Hq)
    dq = torch.empty_like(q)
    dk = torch.zeros((b, l, hkv, d), dtype=torch.float32, device=q.device)
    dvv = torch.zeros((b, l, hkv, dv), dtype=torch.float32, device=q.device)
    flat = (torch.arange(b, device=q.device)[:, None] * l + kpos.reshape(b, -1)).reshape(-1)
    for h, g in _head_groups(hq, hkv):
        qh = q[:, :, h].float().reshape(b, nq, block, d)
        doh = do[:, :, h].float().reshape(b, nq, block, dv)
        kh = _gather_blocks(k[:, :, g:g + 1], block_idx, block)[:, 0].float()
        vh = _gather_blocks(v[:, :, g:g + 1], block_idx, block)[:, 0].float()
        sc = torch.einsum("bqtd,bqkd->bqtk", qh, kh) * scale
        p = torch.where(mask, torch.exp(sc - lse[:, h].reshape(b, nq, block, 1)), 0.0)
        dp = torch.einsum("bqtd,bqkd->bqtk", doh, vh)
        ds = p * (dp - delta[:, :, h].reshape(b, nq, block, 1)) * scale
        dq[:, :, h] = torch.einsum("bqtk,bqkd->bqtd", ds, kh).reshape(b, l, d).to(q.dtype)
        # one partial block per (q-block, slot), scatter-added outside
        dk_part = torch.einsum("bqtk,bqtd->bqkd", ds, qh).reshape(b * nq * s * block, d)
        dv_part = torch.einsum("bqtk,bqtd->bqkd", p, doh).reshape(b * nq * s * block, dv)
        dk[:, :, g].view(b * l, d).index_add_(0, flat, dk_part)
        dvv[:, :, g].view(b * l, dv).index_add_(0, flat, dv_part)
    return dq, dk.to(k.dtype), dvv.to(v.dtype)


# ------------------------------------------------------------ work orders
# what the kernels do with a (64-row q tile, 64-key tile) pair: not in the
# selection, skipped without a load (causality or segments rule out every
# pair), masked per element, or full (every pair visible: JAX _tile_full)
NOT_CHOSEN, SKIP, MASKED, FULL = -1, 0, 1, 2


def _walk_table(segment_ids) -> list:
    """The kernels' 64-row tile table over the ids padded to CTA_ROWS, as
    nested lists [b][tile] = [lo, hi, uni, 0]."""
    pad = -segment_ids.shape[1] % CTA_ROWS
    return _tile_table(torch.nn.functional.pad(segment_ids, (0, pad))).tolist()


def _label(kt: int, qt: int, k: list, q: list) -> int:
    if kt > qt or not (k[1] >= q[0] and k[0] <= q[1]):
        return SKIP
    if kt < qt and q[2] != 0 and k[2] == q[2]:
        return FULL
    return MASKED


def fwd_walk(block_idx, segment_ids, block: int) -> list:
    """The forward's and the dq pass's walk (csrc/block_sparse.cu
    `qwalk_next`). A CTA covers 128 q rows, halves x = 0, 1 (q tiles
    2 i + x, each with its q-block's selection); the halves' selections,
    -1 slots dropped, are merged into one ascending stream of key blocks,
    each with its slot in either half (-1 if that half did not choose it),
    and each block is cut into its 64-key tiles up to the CTA's last row.
    Returns [(b, i, kt, slot0, slot1, label0, label1)] in walk order; the
    kernel loads a tile iff one half's label is MASKED or FULL, and a half
    runs its products on it iff its own label is."""
    bsz, l = segment_ids.shape
    bpt = block // TILE
    sel, tab = block_idx.tolist(), _walk_table(segment_ids)
    items = []
    for b in range(bsz):
        for i in range(-(-l // CTA_ROWS)):
            qi = (2 * i, 2 * i + 1)
            heads = [[(sl, j) for sl, j in enumerate(sel[b][TILE * q // block]) if j >= 0]
                     if TILE * q < l else [] for q in qi]
            p = [0, 0]
            while True:
                hd = [heads[x][p[x]][1] if p[x] < len(heads[x]) else None for x in (0, 1)]
                if hd == [None, None]:
                    break
                jb = min(h for h in hd if h is not None)
                slots = [-1, -1]
                for x in (0, 1):
                    if hd[x] == jb:
                        slots[x] = heads[x][p[x]][0]
                        p[x] += 1
                for kt in range(jb * bpt, min((jb + 1) * bpt, qi[1] + 1)):
                    lab = [_label(kt, qi[x], tab[b][kt], tab[b][qi[x]]) if slots[x] >= 0
                           else NOT_CHOSEN for x in (0, 1)]
                    items.append((b, i, kt, slots[0], slots[1], lab[0], lab[1]))
    return items


def dkv_walk(block_idx, segment_ids, block: int, ratio: int) -> list:
    """The dk/dv pass's walk (csrc/block_sparse.cu `kwalk_next`): a CTA
    per 64-key tile kt and kv head; for each q head r of the group, the
    q-blocks that chose kt's block (ascending), and their q tiles from
    kt's on. Returns [(b, kt, r, qt, label)] in walk order; the kernel
    loads and runs an item iff its label is MASKED or FULL."""
    bsz, l = segment_ids.shape
    nq, bpt = l // block, block // TILE
    sel, tab = block_idx.tolist(), _walk_table(segment_ids)
    items = []
    for b in range(bsz):
        for kt in range(l // TILE):
            chose = [i for i in range(nq) if kt // bpt in sel[b][i]]
            for r in range(ratio):
                for i in chose:
                    for qt in range(max(i * bpt, kt), (i + 1) * bpt):
                        items.append((b, kt, r, qt, _label(kt, qt, tab[b][kt], tab[b][qt])))
    return items


def _tile_visible(segment_ids, b: int, qt: int, kt: int):
    """(64, 64) bool: the causal same-document pairs of q tile qt and key
    tile kt of row b (the selection is the walk's to honour)."""
    qs = segment_ids[b, TILE * qt:TILE * qt + TILE].long()
    ks = segment_ids[b, TILE * kt:TILE * kt + TILE].long()
    qp = torch.arange(TILE * qt, TILE * qt + TILE, device=segment_ids.device)
    kp = torch.arange(TILE * kt, TILE * kt + TILE, device=segment_ids.device)
    return (qs[:, None] == ks[None, :]) & (qs[:, None] != 0) & (qp[:, None] >= kp[None, :])


def block_sparse_fwd_walk_plain(q, k, v, block_idx, segment_ids, scale: float, block: int):
    """#14 as the kernel computes it, in f32: `fwd_walk`'s tiles in order,
    per 64-row half an online softmax in base 2 (the alpha rescale of O,
    the row sum and the current slot's exp-sum, carried in the running-max
    frame and logged when the slot changes). Returns (out, lse, mass) as
    `block_sparse_fwd_plain` does."""
    b_, l, hq, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    s = block_idx.shape[-1]
    rep = hq // hkv
    c = scale * LOG2E
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=2) for t in (k, v))
    out = torch.zeros((b_, l, hq, dv), device=q.device)
    lse = torch.full((b_, hq, l), BIG_LSE, device=q.device)
    mass = torch.zeros((b_, l, hq, s), device=q.device)
    state: dict = {}

    def flush(st):
        if st["cur"] >= 0:
            st["logs"][..., st["cur"]] = torch.where(
                st["ss"] > 0, st["m"] + torch.log2(st["ss"].clamp(min=1e-37)), float("-inf"))

    for b, i, kt, s0, s1, l0, l1 in fwd_walk(block_idx, segment_ids, block):
        for x, slot, lab in ((0, s0, l0), (1, s1, l1)):
            if lab < MASKED:
                continue
            qt = 2 * i + x
            rows, keys = slice(TILE * qt, TILE * qt + TILE), slice(TILE * kt, TILE * kt + TILE)
            st = state.setdefault((b, qt), {
                "m": torch.full((hq, TILE), NEG_INF, device=q.device),
                "l": torch.zeros((hq, TILE), device=q.device),
                "ss": torch.zeros((hq, TILE), device=q.device),
                "o": torch.zeros((hq, TILE, dv), device=q.device),
                "logs": torch.full((hq, TILE, s), float("-inf"), device=q.device), "cur": -1})
            sc = torch.einsum("lhd,mhd->hlm", qf[b, rows], kf[b, keys]) * c
            if lab == MASKED:
                sc = sc.masked_fill(~_tile_visible(segment_ids, b, qt, kt), float("-inf"))
            if slot != st["cur"]:
                flush(st)
                st["cur"], st["ss"] = slot, torch.zeros_like(st["ss"])
            mx = torch.maximum(st["m"], sc.amax(-1))
            alpha = torch.exp2(st["m"] - mx)
            p = torch.exp2(sc - mx[..., None])
            st["l"] = st["l"] * alpha + p.sum(-1)
            st["ss"] = st["ss"] * alpha + p.sum(-1)
            st["o"] = st["o"] * alpha[..., None] + torch.einsum("hlm,mhd->hld", p, vf[b, keys])
            st["m"] = mx
    for (b, qt), st in state.items():
        flush(st)
        rows = slice(TILE * qt, TILE * qt + TILE)
        valid = st["l"] > 0
        lse2 = st["m"] + torch.log2(torch.where(valid, st["l"], 1.0))
        out[b, rows] = torch.where(valid[..., None], st["o"] / st["l"].clamp(min=1e-37)[..., None],
                                   0.0).transpose(0, 1)
        lse[b, :, rows] = torch.where(valid, lse2 / LOG2E, BIG_LSE)
        mass[b, rows] = torch.where(valid[..., None], torch.exp2(st["logs"] - lse2[..., None]),
                                    0.0).transpose(0, 1)
    return out.to(q.dtype), lse, mass


def block_sparse_bwd_walk_plain(q, k, v, block_idx, segment_ids, out, lse, do, scale: float,
                                block: int):
    """#15 as the kernels compute it, in f32: delta = rowsum(do * out); dq
    over `fwd_walk`'s tiles (per half: p from the saved lse, dp = do v^T,
    ds = p (dp - delta), dq += ds k); dk and dv over `dkv_walk`'s items
    (per key tile and kv head: the group's q heads and the q tiles of the
    q-blocks that chose it; dv += p^T do, dk += ds^T q). Returns dq, dk,
    dv in the dtypes of q, k, v."""
    b_, l, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    rep = hq // hkv
    c = scale * LOG2E
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=2) for t in (k, v))
    delta = (dof * out.float()).sum(-1)  # (B, L, Hq)
    lse2 = lse.transpose(1, 2) * LOG2E  # (B, L, Hq)
    dq = torch.zeros((b_, l, hq, d), device=q.device)
    dk = torch.zeros((b_, l, hkv, d), device=q.device)
    dvv = torch.zeros((b_, l, hkv, dv), device=q.device)
    for b, i, kt, s0, s1, l0, l1 in fwd_walk(block_idx, segment_ids, block):
        keys = slice(TILE * kt, TILE * kt + TILE)
        for x, lab in ((0, l0), (1, l1)):
            if lab < MASKED:
                continue
            qt = 2 * i + x
            rows = slice(TILE * qt, TILE * qt + TILE)
            sc = torch.einsum("lhd,mhd->hlm", qf[b, rows], kf[b, keys])
            p = torch.exp2(sc * c - lse2[b, rows].T[..., None])
            if lab == MASKED:
                p = p.masked_fill(~_tile_visible(segment_ids, b, qt, kt), 0.0)
            dp = torch.einsum("lhd,mhd->hlm", dof[b, rows], vf[b, keys])
            ds = p * (dp - delta[b, rows].T[..., None])
            dq[b, rows] += torch.einsum("hlm,mhd->lhd", ds, kf[b, keys])
    heads = torch.arange(hkv, device=q.device) * rep
    for b, kt, r, qt, lab in dkv_walk(block_idx, segment_ids, block, rep):
        if lab < MASKED:
            continue
        keys, rows = slice(TILE * kt, TILE * kt + TILE), slice(TILE * qt, TILE * qt + TILE)
        hs = heads + r  # this step's q head of every group
        qh, doh = qf[b, rows][:, hs], dof[b, rows][:, hs]  # (64, Hkv, .)
        st = torch.einsum("khd,qhd->hkq", k.float()[b, keys], qh)
        pt = torch.exp2(st * c - lse2[b, rows][:, hs].T[:, None, :])
        if lab == MASKED:
            pt = pt.masked_fill(~_tile_visible(segment_ids, b, qt, kt).T, 0.0)
        dpt = torch.einsum("khd,qhd->hkq", v.float()[b, keys], doh)
        dst = pt * (dpt - delta[b, rows][:, hs].T[:, None, :])
        dvv[b, keys] += torch.einsum("hkq,qhd->khd", pt, doh)
        dk[b, keys] += torch.einsum("hkq,qhd->khd", dst, qh)
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dvv.to(v.dtype)


# ---------------------------------------------------------------- kernels
def _check_kernel_args(q, k, v, block_idx, segment_ids, block: int, causal: bool, name: str):
    if not (k.device == v.device == segment_ids.device == block_idx.device == q.device):
        raise ValueError(f"{name}: inputs on different devices")
    b, l, hq, d = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:2] != (b, l) or v.shape[:3] != k.shape[:3] \
            or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not fit (B, L, Hq, D), (B, L, Hkv, D), (B, L, Hkv, Dv)")
    if (d, v.shape[3]) not in KERNEL_DIMS:
        raise ValueError(f"{name} kernel: (D, Dv) = {(d, v.shape[3])} not in {KERNEL_DIMS}")
    if not causal:
        raise ValueError(f"{name} kernel: causal only")
    if block % TILE or l % block:
        raise ValueError(f"{name} kernel: block {block} must be a multiple of {TILE} "
                         f"and divide L {l}")
    if block_idx.dim() != 3 or block_idx.shape[:2] != (b, l // block) \
            or block_idx.dtype != torch.int32:
        raise ValueError(f"{name}: block_idx must be (B, L // block, S) int32")
    if segment_ids.shape != (b, l) or segment_ids.dtype != torch.int32:
        raise ValueError(f"{name}: segment_ids must be (B, L) int32")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: {n} is {t.dtype}, want bfloat16")
    for n, t in (("q", q), ("k", k), ("v", v), ("block_idx", block_idx),
                 ("segment_ids", segment_ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {n} must be contiguous and 16-byte aligned")


def block_sparse_fwd(q, k, v, block_idx, segment_ids, scale: float, block: int,
                     causal: bool = True):
    """The forward kernel (#14): (out (B, L, Hq, Dv) in q.dtype, lse
    (B, Hq, L) f32, mass (B, L, Hq, S) f32)."""
    if q.device.type == "cpu":
        return block_sparse_fwd_plain(q, k, v, block_idx, segment_ids, scale, block, causal)
    _check_kernel_args(q, k, v, block_idx, segment_ids, block, causal, "block_sparse_fwd")
    from ..cuda_lib import check, load

    b, l, hq, _ = q.shape
    s = block_idx.shape[-1]
    out = torch.empty((b, l, hq, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    mass = torch.empty((b, l, hq, s), dtype=torch.float32, device=q.device)
    tiles = _table_scratch(b, l, q.device)
    err = load().xt_block_sparse_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
        segment_ids.data_ptr(), tiles.data_ptr(), out.data_ptr(), lse.data_ptr(),
        mass.data_ptr(), b, l, hq, k.shape[2], q.shape[-1], v.shape[-1], block, s,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_block_sparse_fwd_bf16")
    block_sparse_fwd.launches += 1
    return out, lse, mass


def block_sparse_bwd(q, k, v, block_idx, segment_ids, out, lse, do, scale: float,
                     block: int, causal: bool = True):
    """The backward kernel (#15): dq, dk, dv in the dtypes of q, k, v. On
    the card one call launches the tile table, delta, the inverse table,
    the dq kernel and the dk/dv kernel, and counts once."""
    if q.device.type == "cpu":
        return block_sparse_bwd_plain(q, k, v, block_idx, segment_ids, out, lse, do, scale,
                                      block, causal)
    _check_kernel_args(q, k, v, block_idx, segment_ids, block, causal, "block_sparse_bwd")
    b, l, hq, _ = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    for name, t in (("out", out), ("do", do)):
        if t.shape != (b, l, hq, dv) or t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"block_sparse_bwd kernel: {name} must be a contiguous bfloat16 "
                             f"{(b, l, hq, dv)} on {q.device}")
    if lse.shape != (b, hq, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("block_sparse_bwd kernel: lse must be contiguous float32 (B, Hq, L)")
    from ..cuda_lib import check, load

    nq, s = block_idx.shape[1:]
    delta = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvo = torch.empty_like(v)
    # inverse of block_idx: per (row, key block) the q-blocks that chose it
    inv_count = torch.empty((b, nq), dtype=torch.int32, device=q.device)
    inv_list = torch.empty((b, nq, nq), dtype=torch.int32, device=q.device)
    tiles = _table_scratch(b, l, q.device)
    err = load().xt_block_sparse_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
        segment_ids.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), tiles.data_ptr(), inv_count.data_ptr(), inv_list.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dvo.data_ptr(), b, l, hq, hkv, q.shape[-1], dv, block,
        s, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "xt_block_sparse_bwd_bf16")
    block_sparse_bwd.launches += 1
    return dq, dk, dvo


def _table_scratch(b: int, l: int, device) -> torch.Tensor:
    """The kernels' tile table, (B, Lp / 64, 4) int32 (Lp: L rounded up to
    CTA_ROWS), which they build on the card."""
    return torch.empty((b, -(-l // CTA_ROWS) * (CTA_ROWS // TILE), 4), dtype=torch.int32,
                       device=device)


block_sparse_fwd.launches = 0  # kernel launches since the last reset
block_sparse_bwd.launches = 0


def reset_launches() -> None:
    block_sparse_fwd.launches = block_sparse_bwd.launches = 0


class _BlockSparseAttention(torch.autograd.Function):
    """`_bs_attn`'s custom VJP: residuals (q, k, v, block_idx, segment_ids,
    out, lse); `mass` carries no gradient (the distillation target is
    stop-gradient in JAX too)."""

    @staticmethod
    def forward(ctx, q, k, v, block_idx, segment_ids, scale, block, causal):
        out, lse, mass = block_sparse_fwd(q, k, v, block_idx, segment_ids, scale, block,
                                          causal)
        ctx.save_for_backward(q, k, v, block_idx, segment_ids, out, lse)
        ctx.args = (scale, block, causal)
        ctx.mark_non_differentiable(mass)
        return out, mass

    @staticmethod
    def backward(ctx, dout, _dmass):
        q, k, v, block_idx, segment_ids, out, lse = ctx.saved_tensors
        do = dout.to(out.dtype).contiguous()
        dq, dk, dv = block_sparse_bwd(q, k, v, block_idx, segment_ids, out, lse, do,
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q, k, v, block_idx, segment_ids, *, scale: Optional[float] = None,
                           causal: bool = True, block: int = 256,
                           return_block_mass: bool = False):
    """q: (B, L, Hq, D); k: (B, L, Hkv, D); v: (B, L, Hkv, Dv); block_idx
    (B, L // block, S) ascending k-block ids per q-block (-1 = unused).
    Returns out (B, L, Hq, Dv); with return_block_mass also the (B, L, Hq, S)
    per-slot attention mass (no gradient)."""
    b, l, hq, d = q.shape
    if l % block:
        raise ValueError(f"L ({l}) must be a multiple of block ({block})")
    scale = scale if scale is not None else d ** -0.5
    out, mass = _BlockSparseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                            block_idx.to(torch.int32).contiguous(),
                                            segment_ids.to(torch.int32).contiguous(),
                                            float(scale), block, causal)
    return (out, mass) if return_block_mass else out
