"""Paged-KV serving engine with continuous batching (counterpart:
`xtuner_tpu/model/paged_generate.py`).

The same engine as the JAX one, for dense and MoE models with MHA
attention (gpt-oss's sinks and per-layer sliding windows, Qwen3.5's output
gate included) and for the hybrid GatedDeltaNet models (`model/hybrid.py`,
Qwen3.5):

- one batched C=1 decode step over `max_batch` slots with per-slot
  sequence lengths and block tables; continuous admission as slots free up;
- MoE layers through the routed experts of `module/moe_layer.py` (the
  grouped GEMM kernel on a card) and the shared expert; with
  `record_routing`, each finished request's `routed_experts`, an (N, nL,
  K) int array: per generated token the expert ids of every MoE layer, the
  first from the prompt's last position (JAX `_finish`);
- whole-prompt prefill, right-padded to a 64-token bucket, through the
  dense `_forward_cached` (flash attention), then a scatter of the prompt
  KV into pool blocks;
- GRPO group prompt sharing: siblings reference the leader's block-aligned
  prefix and copy only the ragged tail block;
- hybrid models: the pool holds only the full-attention sub-layers
  (`_full_base`: pattern slot i's period j is pool layer base_i + j); each
  GatedDeltaNet sub-layer keeps a per-slot state instead, S (n_periods,
  max_batch, Hv, dk, dv) f32 and the conv buffer (n_periods, max_batch,
  K-1, conv channels) in the compute dtype. The prefill (`model.
  forward_cached`, right-padded: pad tokens never reach a state, and the
  conv buffer ends at the last real token) writes the post-prompt state
  into the slot and keeps it as the group's snapshot, which a GRPO sibling
  copies into its own slot (the state is not paged: sharing blocks alone
  would leave it at zero). A decode step runs each linear sub-layer as one
  `gdn_cached_forward` step on the slots' states; inactive slots update
  theirs too, harmlessly: the next admit overwrites them. With
  `record_routing` the hybrid's `routed_experts` has one row per generated
  token, the first from the prompt's last position, as for every other
  model (JAX's hybrid prefill returns no routing, so its rows sit one token
  late: ROADMAP.md, known faults in the reference);
- greedy, temperature, top-k and top-p sampling from a `torch.Generator`.

PyTorch runs eagerly, so the JAX jitted programs become plain methods and
the `lax.scan` over layers a Python loop. The pool is updated in place where
the JAX engine donates it. On a card, decode attention always runs the
hand-written paged-decode kernel (the JAX engine keeps its Pallas kernel
opt-in) and prefill attention the flash-forward kernel, each with the
layer's window and the sinks. The engine lays each MoE stack's gate and
up weights out as one gate|up buffer in `params` (`fuse_gate_up`: the
same values), so no step concatenates them.

Not ported yet, each raising NotImplementedError with its ROADMAP.md item:
chunked prefill, the prefix cache, int8 KV, MTP speculation, penalties /
min_tokens / logit_bias, top_logprobs, MLA's compressed-KV and DSA decode
([serve-rest]).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import not_ported
from ..module.attention import MHAConfig, apply_gate, project_qkv
from ..module.gated_deltanet import gdn_cached_forward
from ..module.kv_cache import PagedKVCache, paged_write
from ..module.mlp import linear
from ..module.moe_layer import fuse_gate_up
from ..module.params import cast_tree
from ..module.rope import _rope_dim, rope_cos_sin, text_rope_scaling
from ..ops.attention.paged_decode import paged_decode_attn
from ..ops.rms_norm import rms_norm
from .generate import (GenerateConfig, _forward_cached, _stacks, categorical,
                       init_cache, layer_slices, layer_windows, lm_logits, mlp_or_moe,
                       penalties_active)
from .hybrid import n_periods


def paged_eligible(model_cfg) -> bool:
    """MHA models, and hybrid GDN models whose full layers are MHA (the
    JAX engine also pages MLA/DSA)."""
    return isinstance(model_cfg.attention, MHAConfig)


def _check_ported(cfg, gen_cfg: GenerateConfig) -> None:
    if not paged_eligible(cfg):
        raise not_ported("MLA/DSA attention", "serve-rest")
    for flag, what in (
            (gen_cfg.prefill_chunk, "chunked prefill (prefill_chunk > 0)"),
            (gen_cfg.prefix_cache, "the prefix cache (prefix_cache=True)"),
            (gen_cfg.kv_cache_dtype != "bf16", "int8 KV (kv_cache_dtype)"),
            (gen_cfg.mtp_speculative, "MTP speculative decode"),
            (penalties_active(gen_cfg) or gen_cfg.min_tokens or gen_cfg.logit_bias,
             "penalties / min_tokens / logit_bias"),
            (gen_cfg.top_logprobs, "top_logprobs")):
        if flag:
            raise not_ported(what, "serve-rest")


# ---------------------------------------------------------------- sampling
# Per-request numeric sampling params ride as per-slot rows; only coarse
# class bits (greedy vs sampled, top-k/top-p in use) pick the code path.
ROW_PARAM_DEFAULTS = {"temperature": 1.0, "top_p": 1.0, "top_k": 0}


def _row_params(gen_cfg, reqs_or_none, b) -> dict:
    """(B,)-array dict: per-request overrides falling back to gen_cfg."""
    out = {}
    for k, dflt in ROW_PARAM_DEFAULTS.items():
        base = getattr(gen_cfg, k, dflt)
        vals = [base if r is None else r.get(k, base)
                for r in (reqs_or_none or [None] * b)]
        out[k] = np.asarray(vals, np.int64 if isinstance(dflt, int) else np.float32)
    return out


def _sample_rows(logits: torch.Tensor, generator: torch.Generator, row: dict,
                 cls: dict) -> torch.Tensor:
    """Row-wise sampling: logits (B, V) f32 -> (B,) int64 ids.

    row: dict of (B,) numpy arrays (ROW_PARAM_DEFAULTS keys); cls: class
    bits (do_sample, use_filter)."""
    greedy = torch.argmax(logits, dim=-1)
    if not cls["do_sample"]:
        return greedy
    dev = logits.device
    temp = torch.as_tensor(row["temperature"], device=dev)
    filt = logits / temp.clamp(min=1e-6)[:, None]
    if cls["use_filter"]:
        v = filt.shape[-1]
        srt = torch.sort(filt, dim=-1, descending=True).values
        top_k = torch.as_tensor(row["top_k"], device=dev)
        k_idx = (torch.where(top_k > 0, top_k, v) - 1).clamp(0, v - 1)
        kth = srt.gather(1, k_idx[:, None])
        filt = filt.masked_fill(filt < kth, float("-inf"))
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        top_p = torch.as_tensor(row["top_p"], device=dev)
        cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=v - 1)
        cutoff = srt.gather(1, cutoff_idx[:, None])
        filt = filt.masked_fill(filt < cutoff, float("-inf"))
    sampled = categorical(filt, generator)
    # per-row greedy: temperature 0 rows argmax the unscaled logits
    return torch.where(temp <= 0.0, greedy, sampled)


# ------------------------------------------------------------------ layers
def _paged_layer_decode(lp, cfg, x, cos, sin, pool_k, pool_v, layer: int,
                        block_table, seq_lens, compute_dtype, window=None):
    """One decoder layer, C-token decode chunk against the paged pool.

    x: (B, C, H); seq_lens: (B,) int32 tokens already cached (chunk token i
    is written at seq_lens+i, attending slots <= seq_lens+i, and with a
    window > 0 only those after seq_lens+i-window). The chunk's K/V is
    written into the pool IN PLACE before attention reads it. Returns (x,
    pool_k, pool_v, the MoE layer's (B, C, K) expert ids or None)."""
    lp = cast_tree(lp, compute_dtype)
    attn = cfg.attention
    b, c, _ = x.shape
    zc = cfg.rms_norm_type == "zero_centered"
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
    q, k, v, gate = project_qkv(lp["attn"], attn, h, cos, sin)
    for i in range(c):
        paged_write(pool_k, layer, block_table, seq_lens + i, k[:, i])
        paged_write(pool_v, layer, block_table, seq_lens + i, v[:, i])
    o = paged_decode_attn(q.to(pool_k.dtype), pool_k, pool_v, layer, block_table,
                          seq_lens, scale=attn.head_dim ** -0.5, window=window,
                          sinks=lp["attn"].get("sinks"))
    o = apply_gate(o.reshape(b, c, -1).to(compute_dtype), gate)
    x = x + linear(o, lp["attn"]["o_proj"])
    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
    return _paged_mlp(lp, cfg, x, h, compute_dtype, pool_k, pool_v)


def _paged_mlp(lp, cfg, x, h, compute_dtype, pool_k, pool_v):
    """Decode-layer MLP or MoE tail (JAX `_paged_mlp`); x, h: (B, C, H), h
    post-attn normed. Returns (x, pool_k, pool_v, (B, C, K) expert ids or
    None)."""
    h, routing = mlp_or_moe(lp, cfg, h, compute_dtype)
    return x + h, pool_k, pool_v, routing


def _paged_gdn_decode(lp, cfg, x, state, conv, compute_dtype):
    """One hybrid GatedDeltaNet sub-layer at decode (JAX
    `_paged_gdn_sublayer`): x (B, C, H); state (B, Hv, dk, dv) f32 and conv
    (B, K-1, ch), the slots' views, updated IN PLACE. Returns (x, the MoE
    layer's (B, C, K) expert ids or None)."""
    lp = cast_tree(lp, compute_dtype)
    zc = cfg.rms_norm_type == "zero_centered"
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, zc)
    o, s_new, conv_new = gdn_cached_forward(lp["attn"], cfg.linear_attention, h, state, conv)
    state.copy_(s_new)
    conv.copy_(conv_new)
    x = x + o
    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps, zc)
    h, routing = mlp_or_moe(lp, cfg, h, compute_dtype)
    return x + h, routing


def _scatter_blocks(pool: torch.Tensor, layer0: int, block_table: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """values: (n_layers, MB, BS, H, D) -> pool[layer0+l, block_table[m]],
    written IN PLACE (the JAX engine donates the pool)."""
    n = values.shape[0]
    layers = torch.arange(layer0, layer0 + n, device=pool.device)[:, None]
    pool[layers, block_table.long()[None, :]] = values.to(pool.dtype)
    return pool


def _pack_blocks(c: torch.Tensor, n_blocks: int, bs: int) -> torch.Tensor:
    """Dense prefill cache (n, 1, P, H, D) -> (n, n_blocks, bs, H, D),
    zero-padded past P."""
    n, _, p = c.shape[:3]
    cp = torch.nn.functional.pad(c[:, 0], (0, 0, 0, 0, 0, n_blocks * bs - p))
    return cp.reshape(n, n_blocks, bs, *c.shape[3:])


# ------------------------------------------------------------------ engine
@dataclass
class _Slot:
    req: Optional[dict] = None
    seq_id: int = -1
    remaining: int = 0
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)
    routings: list = field(default_factory=list)  # per token (nL, K) expert ids
    done: bool = True  # free


class PagedGenerator:
    """Continuous-batching serving engine over a paged KV pool.

    requests: dicts {"prompt_ids": list[int], "max_new_tokens"?: int,
    "group"?: hashable, "temperature"/"top_p"/"top_k"?} — same-`group`
    requests share prompt blocks. `generate(requests)` returns per-request
    dicts with generated token ids, logprobs and finish_reason (and, for an
    MoE model with `record_routing`, routed_experts (N, nL, K)).
    `rng` is a `torch.Generator` on the params' device. Each MoE stack's
    gate and up weights in `params` become views of one gate|up buffer
    (`module/moe_layer.py::fuse_gate_up`, the same values).
    """

    PREFILL_BUCKET = 64

    def __init__(self, model, params, gen_cfg: GenerateConfig, *,
                 max_batch: int = 8, block_size: int = 128,
                 num_blocks: Optional[int] = None,
                 compute_dtype=torch.bfloat16, pad_token_id: int = 0,
                 record_routing: bool = False,
                 rng: Optional[torch.Generator] = None):
        cfg = model.cfg
        _check_ported(cfg, gen_cfg)
        self.model, self.params, self.gen_cfg = model, params, gen_cfg
        self.record_routing = record_routing
        self.device = params["embed"]["w"].device
        self.compute_dtype = compute_dtype
        self.pad_token_id = pad_token_id
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks = -(-gen_cfg.max_length // block_size)
        if num_blocks is None:
            num_blocks = self.max_blocks * max_batch + 1  # worst case, all unshared
        # per-layer parameter views (the scan's xs) in forward order, as
        # (kind, pattern key, period, params, pool layer, window (0: full)):
        # kind "full" pages its K/V at the pool layer, "linear" (a hybrid's
        # GDN sub-layer) keeps the per-slot state gdn_state[key][:, period]
        self._layers = []
        self.gdn_state: dict = {}
        self._full_base: dict[int, int] = {}
        self.is_hybrid = bool(getattr(cfg, "layer_types_pattern", None))
        if self.is_hybrid:
            n, la = n_periods(cfg), cfg.linear_attention
            win = int(cfg.sliding_window or 0) if cfg.use_sliding_window else 0
            slices = []
            for i, kind in enumerate(cfg.layer_types_pattern):
                stack = params["pattern"][f"p{i}"]
                if "experts" in stack:
                    fuse_gate_up(stack["experts"])
                slices.append(layer_slices(stack, n))
                if kind == "linear":
                    self.gdn_state[f"p{i}"] = (
                        torch.zeros((n, max_batch, la.num_v_heads, la.head_k_dim,
                                     la.head_v_dim), dtype=torch.float32, device=self.device),
                        torch.zeros((n, max_batch, la.conv_kernel_size - 1,
                                     la.conv_channels), dtype=compute_dtype, device=self.device))
                else:
                    self._full_base[i] = n * len(self._full_base)
            self._layers = [(kind, f"p{i}", j, slices[i][j], self._full_base.get(i, 0) + j, win)
                            for j in range(n) for i, kind in enumerate(cfg.layer_types_pattern)]
            n_pool = n * len(self._full_base)
        else:
            for name, stack in _stacks(model, params):
                n = stack["input_norm"].shape[0]
                if "experts" in stack:
                    fuse_gate_up(stack["experts"])
                base = len(self._layers)
                wins = layer_windows(cfg, name, n)
                self._layers += [("full", None, i, lp, base + i, wins[i])
                                 for i, lp in enumerate(layer_slices(stack, n))]
            n_pool = len(self._layers)
        attn = cfg.attention
        self.cache = PagedKVCache(n_pool, num_blocks, block_size,
                                  attn.num_key_value_heads, attn.head_dim,
                                  dtype=compute_dtype, device=self.device)
        # block 0 is the TRASH block: inactive decode slots have all-zero
        # block tables, so their (masked-out) writes land here instead of a
        # live sequence's block; never handed out by the allocator
        self.cache.allocator.refcount[0] = 1
        self.slots = [_Slot() for _ in range(max_batch)]
        self.cls = {
            "do_sample": bool(gen_cfg.do_sample and gen_cfg.temperature != 0.0),
            "use_filter": gen_cfg.top_k > 0 or gen_cfg.top_p < 1.0,
        }
        self._next_seq = 0
        self._rng = rng if rng is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        # group -> (seq_id, last logits, routing, a hybrid's state snapshot)
        self._group_leader: dict = {}

    # ---------------- device steps ----------------
    def _decode_step(self, tok, seq_lens, block_table, active, row):
        """One batched C=1 decode step -> (new_tok (B,), logprob (B,),
        routing (B, nL_moe, K) with `record_routing`, else None)."""
        model, cfg, dtype = self.model, self.model.cfg, self.compute_dtype
        params = self.params
        x = params["embed"]["w"][tok][:, None].to(dtype)
        cos, sin = rope_cos_sin(seq_lens[:, None], _rope_dim(cfg.attention),
                                cfg.rope_theta, text_rope_scaling(cfg.rope_scaling_cfg),
                                cfg.max_position_embeddings)
        pool_k, pool_v = self.cache.pool_k, self.cache.pool_v
        routings = []
        for kind, key, j, lp, layer, win in self._layers:
            if kind == "linear":
                state, conv = self.gdn_state[key]
                x, routing = _paged_gdn_decode(lp, cfg, x, state[j], conv[j], dtype)
            else:
                x, pool_k, pool_v, routing = _paged_layer_decode(
                    lp, cfg, x, cos, sin, pool_k, pool_v, layer, block_table,
                    seq_lens, dtype, win)
            if self.record_routing and routing is not None:
                routings.append(routing[:, -1])
        x = rms_norm(x, params["final_norm"].float(), cfg.rms_norm_eps,
                     cfg.rms_norm_type == "zero_centered")[:, -1]
        logits = lm_logits(x.to(dtype), model.lm_head_weight(params).to(dtype))
        new_tok = _sample_rows(logits, self._rng, row, self.cls)
        lp = torch.log_softmax(logits, dim=-1).gather(1, new_tok[:, None])[:, 0]
        new_tok = torch.where(active, new_tok, self.pad_token_id)
        return new_tok, lp, torch.stack(routings, dim=1) if routings else None

    def _prefill(self, p_bucket: int, prompt, positions, kv_mask, table,
                 last_idx: int, row, slot_idx: int):
        """Dense prefill over a (1, P_bucket) right-padded prompt, then
        scatter the prompt KV into pool blocks (right-pad KV lands past
        seq_len: decode never attends it and the first decoded tokens
        overwrite it); a hybrid's linear sub-layers write their post-prompt
        state into slot `slot_idx`. Returns (tok (1,), logprob (1,), last
        logits (1, V), the last position's (nL_moe, K) expert ids with
        `record_routing`, else None, and the hybrid's state snapshot {key:
        (S (n, Hv, dk, dv), conv (n, K-1, ch))}, else {})."""
        model, dtype, bs = self.model, self.compute_dtype, self.block_size
        n_blocks = -(-p_bucket // bs)
        snap: dict = {}
        if self.is_hybrid:
            caches = model.init_decode_cache(1, p_bucket, dtype, self.device)
            logits, caches, routing = model.forward_cached(
                self.params, prompt, positions, caches, 0, dtype, kv_mask,
                self.record_routing,
                n_valid=torch.full((1,), last_idx + 1, dtype=torch.int64, device=self.device))
            full = []
            for key, (c0, c1) in caches.items():
                if key in self.gdn_state:
                    snap[key] = (c0[:, 0], c1[:, 0])
                    self._set_state(slot_idx, snap[key], key)
                else:
                    full.append((self._full_base[int(key[1:])], c0, c1))
        else:
            caches = init_cache(model, 1, p_bucket, dtype, self.device)
            logits, caches, routing = _forward_cached(model, self.params, prompt, positions,
                                                      caches, 0, dtype, kv_mask,
                                                      self.record_routing)
            full, li = [], 0
            for ck, cv in caches:
                full.append((li, ck, cv))
                li += ck.shape[0]
        for li, ck, cv in full:
            _scatter_blocks(self.cache.pool_k, li, table[:n_blocks],
                            _pack_blocks(ck, n_blocks, bs))
            _scatter_blocks(self.cache.pool_v, li, table[:n_blocks],
                            _pack_blocks(cv, n_blocks, bs))
        last = logits[:, last_idx]
        tok = _sample_rows(last, self._rng, row, self.cls)
        lp = torch.log_softmax(last, dim=-1).gather(1, tok[:, None])[:, 0]
        rout = None if routing is None else routing[0, last_idx]
        return tok, lp, last, rout, snap

    def _set_state(self, slot_idx: int, snap, key: str) -> None:
        """Write one linear slot's post-prompt (S, conv) into slot_idx."""
        state, conv = self.gdn_state[key]
        state[:, slot_idx] = snap[0]
        conv[:, slot_idx] = snap[1].to(conv.dtype)

    # ---------------- host loop ----------------
    def _admit(self, slot_idx: int, req: dict) -> None:
        """Prefill one request into a free slot (prefix-shared if its group
        leader already cached the prompt)."""
        prompt = list(req["prompt_ids"])
        p_len = len(prompt)
        budget = int(req.get("max_new_tokens", self.gen_cfg.max_new_tokens))
        if p_len + budget > self.max_blocks * self.block_size:
            raise ValueError(
                f"request needs {p_len + budget} tokens > max_length "
                f"{self.max_blocks * self.block_size}; raise gen_cfg.max_length")
        seq_id = self._next_seq
        self._next_seq += 1
        group = req.get("group")
        slot = self.slots[slot_idx]
        row1 = _row_params(self.gen_cfg, [req], 1)

        leader = self._group_leader.get(group) if group is not None else None
        shared = (leader is not None and leader[0] in self.cache.tables
                  and self.cache.seq_lens[leader[0]] == p_len)
        if shared:
            leader_seq, leader_logits, rout, snap = leader
            # share the block-aligned prefix, copy the ragged tail block
            self.cache.share_prefix(leader_seq, seq_id)
            aligned = self.cache.seq_lens[seq_id]
            if aligned < p_len:
                self.cache.extend(seq_id, p_len - aligned)
                src = self.cache.tables[leader_seq][aligned // self.block_size]
                dst = self.cache.tables[seq_id][aligned // self.block_size]
                self.cache.pool_k[:, dst] = self.cache.pool_k[:, src]
                self.cache.pool_v[:, dst] = self.cache.pool_v[:, src]
                self.cache.seq_lens[seq_id] = p_len
            # the GDN state is not paged: the leader's post-prompt snapshot
            for key, s in snap.items():
                self._set_state(slot_idx, s, key)
            # the sibling samples its OWN first token from the leader's
            # last-position logits (no re-prefill)
            tok_a = _sample_rows(leader_logits, self._rng, row1, self.cls)
            lp_a = torch.log_softmax(leader_logits, dim=-1).gather(1, tok_a[:, None])[:, 0]
        else:
            pb = -(-p_len // self.PREFILL_BUCKET) * self.PREFILL_BUCKET
            # reserve blocks for the BUCKET, then trim the book-kept length
            # back to the true prompt length
            self.cache.add_sequence(seq_id, pb)
            self.cache.seq_lens[seq_id] = p_len
            table = np.zeros((self.max_blocks,), np.int32)
            ids = self.cache.tables[seq_id]
            table[:len(ids)] = ids
            padded = np.full((pb,), self.pad_token_id, np.int64)
            padded[:p_len] = prompt
            dev = self.device
            positions = torch.clamp(torch.arange(pb, device=dev), max=p_len - 1)[None]
            kv_mask = (torch.arange(pb, device=dev) < p_len)[None]
            tok_a, lp_a, last, rout, snap = self._prefill(
                pb, torch.from_numpy(padded[None]).to(dev), positions, kv_mask,
                torch.from_numpy(table).to(dev), p_len - 1, row1, slot_idx)
            if rout is not None:
                rout = rout.cpu().numpy()
            if group is not None:
                self._group_leader[group] = (seq_id, last, rout, snap)
        slot.req = req
        slot.seq_id = seq_id
        slot.remaining = budget - 1  # the sampled first token
        slot.tokens = [int(tok_a[0])]
        slot.logprobs = [float(lp_a[0])]
        slot.routings = [rout] if rout is not None else []
        slot.done = False

    def _finish(self, slot: _Slot, reason: str) -> dict:
        req = slot.req
        out = {"request": req, "token_ids": slot.tokens,
               "logprobs": slot.logprobs, "finish_reason": reason}
        if slot.routings:
            out["routed_experts"] = np.stack(slot.routings)  # (N, nL, K)
        self.cache.release(slot.seq_id)
        group = (req or {}).get("group")
        leader = self._group_leader.get(group) if group is not None else None
        if leader is not None and leader[0] == slot.seq_id:
            del self._group_leader[group]
        slot.req, slot.done, slot.seq_id = None, True, -1
        return out

    @property
    def eos_id(self) -> int:
        return (self.gen_cfg.eos_token_id
                if self.gen_cfg.eos_token_id is not None
                else self.model.cfg.eos_token_id)

    def has_live_slots(self) -> bool:
        return any(not s.done for s in self.slots)

    def check_block_conservation(self) -> None:
        """Pool-wide conservation invariant: every reference the allocator
        holds is owned by exactly one of (a) the reserved trash block 0,
        (b) a live sequence's block table. A surplus means leaked blocks; a
        deficit a double-free."""
        tables = sum(len(t) for t in self.cache.tables.values())
        held = 1 + tables
        total = int(self.cache.allocator.refcount.sum())
        if total != held:
            raise AssertionError(
                f"paged-pool block conservation violated: allocator holds "
                f"{total} refs but owners account for {held} "
                f"(trash=1, live tables={tables})")

    def generate(self, requests: list[dict]) -> list[dict]:
        """Run all requests to completion with continuous batching; returns
        outputs in request order."""
        queue = [dict(r, _idx=i) for i, r in enumerate(requests)]
        results: dict[int, dict] = {}
        while queue or self.has_live_slots():
            self.tick(queue, results)
        self.check_block_conservation()
        return [results[i] for i in range(len(requests))]

    def tick(self, queue: list[dict], results: dict[int, dict]) -> None:
        """One continuous-batching round: admit queued requests into free
        slots, harvest finished slots into `results` (keyed by the request's
        `_idx`), run ONE decode step over the live slots."""
        eos = self.eos_id
        for i, s in enumerate(self.slots):
            if s.done and queue:
                self._admit(i, queue.pop(0))
        for s in self.slots:
            if s.done:
                continue
            last, ridx = s.tokens[-1], s.req["_idx"]
            if last == eos or last in self.gen_cfg.stop_token_ids:
                results[ridx] = self._finish(s, "stop")
            elif any(len(s.tokens) >= len(seq) and s.tokens[-len(seq):] == seq
                     for seq in s.req.get("_stop_seqs", ())):
                # multi-token stop sequences (token-level match)
                results[ridx] = self._finish(s, "stop")
            elif s.remaining <= 0:
                results[ridx] = self._finish(s, "length")
        active_idx = [i for i, s in enumerate(self.slots) if not s.done]
        if not active_idx:
            return

        b = self.max_batch
        tok = np.full((b,), self.pad_token_id, np.int64)
        lens = np.zeros((b,), np.int32)
        table = np.zeros((b, self.max_blocks), np.int32)
        active = np.zeros((b,), bool)
        for i in active_idx:
            s = self.slots[i]
            tok[i] = s.tokens[-1]
            lens[i] = self.cache.seq_lens[s.seq_id]
            active[i] = True
            # allocate room for the token this step will write
            self.cache.extend(s.seq_id, 1)
            ids = self.cache.tables[s.seq_id]
            table[i, :len(ids)] = ids
        row = _row_params(self.gen_cfg, [s.req for s in self.slots], b)
        dev = self.device
        new_tok, lp, rout = self._decode_step(
            torch.from_numpy(tok).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(active).to(dev), row)
        new_tok, lp = new_tok.cpu().numpy(), lp.cpu().numpy()
        rout = None if rout is None else rout.cpu().numpy()
        for i in active_idx:
            s = self.slots[i]
            s.tokens.append(int(new_tok[i]))
            s.logprobs.append(float(lp[i]))
            if rout is not None:
                s.routings.append(rout[i])
            s.remaining -= 1
