"""Sliding-window causal GQA attention, plain torch (counterpart of
`voxtral_tpu/ops/attention.py`).

- `windowed_attention`: full [S, Skv] score matrix with a causal+window
  mask (key kj visible from query qi iff kj <= qi and kj >= qi - (window-1)).
  The batch encoder and the decoder prefill use it.
- `ring_decode_attention`: queries against a circular KV buffer whose slots
  are masked by logical position.

On the TPU these are XLA, outside any Pallas kernel, so the port keeps them
as torch.matmul. Numerics follow the JAX oracle: scores are f32 from
operands widened to f32 (exact for bf16), probabilities are normalised in
f32 and then cast to V's dtype for the PV product, which accumulates in f32.
"""

from __future__ import annotations

import torch

_NEG_INF = float("-inf")


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [S, H, hd], k: [Skv, Hkv, hd] -> scores [H, S, Skv] (f32)."""
    s, h, hd = q.shape
    skv, hkv, _ = k.shape
    group = h // hkv
    qg = q.reshape(s, hkv, group, hd).permute(1, 2, 0, 3).float()  # [n,g,s,d]
    kt = k.to(q.dtype).permute(1, 2, 0).float()                    # [n,d,t]
    scores = torch.matmul(qg, kt[:, None])                         # [n,g,s,t]
    return scores.reshape(h, s, skv)


def _gqa_output(probs: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """probs: [H, S, Skv] f32, v: [Skv, Hkv, hd] -> [S, H, hd]."""
    h, s, skv = probs.shape
    _, hkv, hd = v.shape
    group = h // hkv
    p = probs.reshape(hkv, group, s, skv).to(v.dtype).float()
    vt = v.permute(1, 0, 2).float()                                # [n,t,d]
    out = torch.matmul(p, vt[:, None])                             # [n,g,s,d]
    return out.permute(2, 0, 1, 3).reshape(s, h, hd).to(out_dtype)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """scores: [H, S, Skv] f32; mask: [S, Skv] bool (True = attend)."""
    scores = torch.where(mask[None], scores, _NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    # Guard fully-masked rows (cannot happen for valid schedules)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(scores - m)
    e = torch.where(mask[None], e, 0.0)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, q_start=0, kv_start=0) -> torch.Tensor:
    """Materialized-mask sliding-window causal attention.

    q: [S, H, hd] at absolute positions q_start + i
    k, v: [Skv, Hkv, hd] at absolute positions kv_start + j
    Returns [S, H, hd] in q.dtype.
    """
    s, h, hd = q.shape
    skv = k.shape[0]
    scale = 1.0 / (hd ** 0.5)
    scores = _gqa_scores(q, k) * scale
    qi = q_start + torch.arange(s, device=q.device)[:, None]
    kj = kv_start + torch.arange(skv, device=q.device)[None, :]
    mask = (kj <= qi) & (kj >= qi - (window - 1))
    probs = _masked_softmax(scores, mask)
    return _gqa_output(probs, v, q.dtype)


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, *, slot_pos: torch.Tensor,
                          q_pos, window: int, extra_kv=None) -> torch.Tensor:
    """Attention for S queries against a circular KV buffer.

    q: [S, H, hd] at absolute positions q_pos ([S] or a scalar when S == 1);
    k_ring/v_ring: [R, Hkv, hd]; slot_pos: [R] logical positions per slot
    (negative = invalid). extra_kv: optional ([Sx, Hkv, hd], [Sx, Hkv, hd],
    kv_pos [Sx]) of additional columns, masked like ring slots, sharing one
    softmax with them.
    """
    if q.dim() == 2:
        q = q[None]
    s = q.shape[0]
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32,
                            device=q.device).reshape(-1)
    if q_pos.shape[0] == 1 and s > 1:
        q_pos = q_pos[0] + torch.arange(s, dtype=torch.int32, device=q.device)
    qi = q_pos[:, None]                              # [S, 1]
    kj = slot_pos[None, :]                           # [1, R]
    mask = (kj >= 0) & (kj <= qi) & (kj >= qi - (window - 1))
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = _gqa_scores(q, k_ring) * scale          # [H, S, R]
    if extra_kv is None:
        probs = _masked_softmax(scores, mask)
        return _gqa_output(probs, v_ring, q.dtype)
    xk, xv, x_pos = extra_kv
    scores_x = _gqa_scores(q, xk) * scale            # [H, S, Sx]
    kj_x = x_pos[None, :]
    mask_x = (kj_x >= 0) & (kj_x <= qi) & (kj_x >= qi - (window - 1))
    probs = _masked_softmax(torch.cat([scores, scores_x], dim=-1),
                            torch.cat([mask, mask_x], dim=-1))
    r = k_ring.shape[0]
    out = _gqa_output(probs[:, :, :r], v_ring, torch.float32)
    out_x = _gqa_output(probs[:, :, r:], xv, torch.float32)
    return (out + out_x).to(q.dtype)
