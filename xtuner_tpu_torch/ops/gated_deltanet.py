"""Gated delta rule (linear attention) recurrence (counterpart:
`xtuner_tpu/ops/gated_deltanet.py`, which reaches no `pallas_call`: JAX
computes it in plain jnp, and so does the port in plain torch, with an f32
state on the card as on the CPU).

State recurrence per head (S: (d_k, d_v) fast-weight matrix):

    S_t = a_t (I - b_t k_t k_t^T) S_{t-1} + b_t k_t v_t^T
    o_t = S_t^T q_t

with a_t in (0, 1] the forget gate and b_t in (0, 1) the delta learning
rate. Packed documents reset the state at segment starts.

- `gated_delta_rule_scan`: the exact sequential recurrence (the oracle).
- `gated_delta_rule_step`: one decode token.
- `gated_delta_rule_chunked`: JAX's chunk-parallel WY form, (C x C) and
  (C x d) products per chunk and a loop over L / C chunks. It also takes
  an `initial_state` and returns the final state (`return_state`), which
  JAX's version does not: the serving prefill runs it in place of the
  scan (one Python step per chunk, not per token). A tail padded to the
  chunk gets a = 1 and b = 0, so the final state is the state after the
  last real token; JAX pads with zeros, which changes no output row.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LOG_GATE_MIN = -30.0  # log(0) stand-in: exp(-30) ~ 1e-13, keeps ratios finite


def _doc_start_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, L) bool: True where a new document begins."""
    prev = torch.cat([torch.zeros_like(segment_ids[:, :1]), segment_ids[:, :-1]], dim=1)
    return (segment_ids != prev) & (segment_ids != 0)


def _delta_update(S, k_t, v_t, a_t, b_t):
    """S (B, H, dk, dv) -> a (S - b k (S^T k)^T) + b k v^T, all f32."""
    sk = torch.einsum("bhkv,bhk->bhv", S, k_t)
    S = a_t[..., None, None] * (S - b_t[..., None, None] * torch.einsum("bhk,bhv->bhkv", k_t, sk))
    return S + b_t[..., None, None] * torch.einsum("bhk,bhv->bhkv", k_t, v_t)


def gated_delta_rule_scan(q, k, v, alpha, beta, segment_ids=None,
                          initial_state: Optional[torch.Tensor] = None,
                          return_state: bool = False):
    """q, k: (B, L, H, dk); v: (B, L, H, dv); alpha, beta: (B, L, H).
    Returns o (B, L, H, dv) f32, and with `return_state` also the final
    (B, H, dk, dv) f32 state."""
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    q, k, v, alpha, beta = (x.float() for x in (q, k, v, alpha, beta))
    reset = (_doc_start_mask(segment_ids) if segment_ids is not None
             else torch.zeros((b, l), dtype=torch.bool, device=q.device))
    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    outs = []
    for t in range(l):
        S = torch.where(reset[:, t, None, None, None], 0.0, S)
        S = _delta_update(S, k[:, t], v[:, t], alpha[:, t], beta[:, t])
        outs.append(torch.einsum("bhkv,bhk->bhv", S, q[:, t]))
    o = torch.stack(outs, dim=1)
    return (o, S) if return_state else o


def gated_delta_rule_step(S, q_t, k_t, v_t, a_t, b_t):
    """One decode token. S: (B, H, dk, dv) f32; q_t, k_t: (B, H, dk); v_t:
    (B, H, dv); a_t, b_t: (B, H). Returns (S', o_t (B, H, dv) f32)."""
    q_t, k_t, v_t, a_t, b_t = (x.float() for x in (q_t, k_t, v_t, a_t, b_t))
    S = _delta_update(S.float(), k_t, v_t, a_t, b_t)
    return S, torch.einsum("bhkv,bhk->bhv", S, q_t)


def gated_delta_rule_chunked(q, k, v, alpha, beta, segment_ids=None, chunk: int = 64,
                             initial_state: Optional[torch.Tensor] = None,
                             return_state: bool = False):
    """Chunk-parallel gated delta rule; the scan's signature and result.

    Factoring the decay out (S_hat_t = S_t / A_t, A_t = prod a_s) reduces
    the gated rule to the plain delta rule, whose chunk unroll is S_C =
    S_0 + W^T R with R = (I + strict_tril(K W^T))^{-1} (V - K S_0);
    re-scaling every row by its decay keeps all terms as bounded ratios
    exp(c_t - c_s), s <= t."""
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    pad = -l % chunk
    q, k, v = (x.float() for x in (q, k, v))
    alpha = alpha.float().clamp(0.0, 1.0)
    beta = beta.float()
    if segment_ids is not None:
        alpha = torch.where(_doc_start_mask(segment_ids)[..., None], 0.0, alpha)
    if pad:  # a = 1, b = 0 past L: the state passes through unchanged
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        alpha = F.pad(alpha, (0, 0, 0, pad), value=1.0)
        beta = F.pad(beta, (0, 0, 0, pad))
    n = (l + pad) // chunk

    def rsh(x):  # (B, L, H, ...) -> (B H, N, C, ...)
        if x.dim() == 3:
            return x.reshape(b, n, chunk, h).permute(0, 3, 1, 2).reshape(b * h, n, chunk)
        return x.reshape(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4).reshape(
            b * h, n, chunk, x.shape[-1])

    qc, kc, vc, ac, bc = rsh(q), rsh(k), rsh(v), rsh(alpha), rsh(beta)
    log_a = torch.log(ac.clamp(min=0.0)).clamp(min=LOG_GATE_MIN)
    c = torch.cumsum(log_a, dim=-1)  # inclusive cumulative log decay (Z, N, C)
    c_end = c[..., -1]
    dev = q.device
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    strict = torch.tril(torch.ones((chunk, chunk), device=dev), -1)
    incl = torch.tril(torch.ones((chunk, chunk), device=dev))
    ratio = torch.exp((c[..., :, None] - c[..., None, :]).clamp(LOG_GATE_MIN, 0.0))
    # M~[t, s] = b_s (k_t . k_s) A_t / A_s, s < t
    m = torch.einsum("znck,znsk->zncs", kc, kc) * ratio * bc[..., None, :] * strict
    t_inv = torch.linalg.solve_triangular(eye + m, eye.expand_as(m), upper=False)
    a_incl = torch.exp(c)  # A_t
    attn = torch.einsum("znck,znsk->zncs", qc, kc) * ratio * bc[..., None, :] * incl

    S = (torch.zeros((b * h, dk, dv), dtype=torch.float32, device=dev) if initial_state is None
         else initial_state.float().reshape(b * h, dk, dv))
    outs = []
    for i in range(n):
        # S: the chunk-entry state. Scaled residuals R~_t = A_t r_t:
        #   R~ = T~ (V - diag(A) K S);  o_t = A_t q_t^T S + sum_{s<=t} attn[t, s] R~_s
        #   S' = A_C S + sum_t (A_C / A_t) b_t k_t R~_t^T
        a_b, c_b, ce_b = a_incl[:, i], c[:, i], c_end[:, i]
        kd = kc[:, i] * a_b[..., None]
        r = torch.einsum("zcs,zsd->zcd", t_inv[:, i],
                         vc[:, i] - torch.einsum("zck,zkd->zcd", kd, S))
        outs.append(torch.einsum("zck,zkd->zcd", qc[:, i] * a_b[..., None], S)
                    + torch.einsum("zcs,zsd->zcd", attn[:, i], r))
        decay_to_end = torch.exp((ce_b[:, None] - c_b).clamp(LOG_GATE_MIN, 0.0))
        carry_k = kc[:, i] * (bc[:, i] * decay_to_end)[..., None]
        S = torch.exp(ce_b)[:, None, None] * S + torch.einsum("zck,zcd->zkd", carry_k, r)
    o = torch.stack(outs, dim=1).reshape(b, h, n * chunk, dv).permute(0, 2, 1, 3)[:, :l]
    return (o, S.reshape(b, h, dk, dv)) if return_state else o
