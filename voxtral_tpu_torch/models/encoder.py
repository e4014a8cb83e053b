"""Causal Whisper-style audio encoder (counterpart of
`voxtral_tpu/models/encoder.py`): conv stem, batch forward, and the
incremental forward over a circular KV ring.

MHA 32 heads x 64, biases on wq/wv/wo/w2 but NOT wk/w1/w3, interleaved RoPE
theta=1e6, sliding window 750, RMSNorm, SwiGLU, exact (erf) GELU in the
conv stem.

The incremental encoder keeps the decoder's ring rules (models/decoder.py):
one lockstep cursor shared by all streams with a [B, P] slot->position
table, fold-pending-before-read, and an Sp-slot overflow margin
(P = R + Sp, writes at ctr % R, R >= window + Sp). kv_dtype "int8" and
"int4" store int8 codes (int4: two per byte, halves packing) with
per-(slot, head) f32 scales; the pending block is quantized at chunk end,
so the fold is a pure copy, while attention inside the chunk still sees the
chunk's float K/V as extra columns. The fold writes the rings IN PLACE: a
state passed to encoder_incremental must not be used again afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.ops import (
    apply_rope, causal_conv1d, rms_norm, rope_angles, windowed_attention,
)
from voxtral_tpu_torch.ops.linear import linear
from voxtral_tpu_torch.ops.ring_attention import ring_attention
from voxtral_tpu_torch.quant import quantize_kv, quantize_kv_int4
from voxtral_tpu_torch.utils import resolve_device


def conv_stem(enc_params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel: [mel_bins, F] -> [F//2 (ceil), enc_dim] post-conv activations."""
    h = F.gelu(causal_conv1d(mel, enc_params["conv0_w"], enc_params["conv0_b"], stride=1))
    h = F.gelu(causal_conv1d(h, enc_params["conv1_w"], enc_params["conv1_b"], stride=2))
    return h.t()


def _attn_block(lp: dict, x_norm: torch.Tensor, cfg, cos, sin):
    """Shared QKV+RoPE computation. x_norm: [..., S, D] -> q [..., S, H, hd],
    k, v (leading batch dims preserved)."""
    e = cfg
    hs = (*x_norm.shape[:-1], e.heads, e.head_dim)
    q = linear(x_norm, lp["wq"], lp["wq_b"]).reshape(hs)
    k = linear(x_norm, lp["wk"]).reshape(hs)
    v = linear(x_norm, lp["wv"], lp["wv_b"]).reshape(hs)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def encoder_forward(enc_params: dict, cfg: VoxtralConfig, h: torch.Tensor,
                    pos_start: int = 0) -> torch.Tensor:
    """Batch transformer over post-conv activations h: [S, D] -> [S, D]."""
    e = cfg.encoder
    s = h.shape[0]
    positions = pos_start + torch.arange(s, device=h.device)
    cos, sin = rope_angles(positions, e.head_dim, e.rope_theta)

    for lp in enc_params["layers"]:
        x = rms_norm(h, lp["attn_norm"], e.norm_eps)
        q, k, v = _attn_block(lp, x, e, cos, sin)
        attn = windowed_attention(q, k, v, window=e.window)
        h = h + linear(attn.reshape(s, e.attn_dim), lp["wo"], lp["wo_b"])
        x = rms_norm(h, lp["ffn_norm"], e.norm_eps)
        h = h + linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]),
                       lp["w2"], lp["w2_b"])
    return rms_norm(h, enc_params["norm"], e.norm_eps)


SLOT_INVALID = -(1 << 30)


class EncoderState(NamedTuple):
    """Batched incremental encoder KV ring (leading axis B = streams).
    Rings store heads merged into the last axis ([B, P, H*hd], int4:
    [B, P, H*hd/2] bytes). Scalars are 0-dim int32 tensors on the state's
    device."""
    k_ring: tuple        # L x [B, P, H*hd]
    v_ring: tuple        # L x [B, P, H*hd]
    k_scale: tuple | None  # L x [B, H, P] f32 (int8/int4 mode only)
    v_scale: tuple | None
    slot_pos: torch.Tensor  # [B, P] int32 logical position per slot
    pending_k: tuple       # L x [B, Sp, H*hd] (ring dtype and width)
    pending_v: tuple       # L x [B, Sp, H*hd]
    pending_ks: tuple | None  # L x [B, H, Sp] f32 (int8/int4 mode only)
    pending_vs: tuple | None
    pending_sp: torch.Tensor  # [B, Sp] int32
    pending_adv: torch.Tensor  # [] int32
    write_ctr: torch.Tensor  # [] int32 shared lockstep cursor
    next_pos: torch.Tensor  # [B] int32: positions processed per stream


def init_encoder_state(cfg: VoxtralConfig, ring_size: int = 1280,
                       batch: int = 1, dtype=None,
                       pending_size: int = 128,
                       kv_dtype: str = "float",
                       device="cuda") -> EncoderState:
    e = cfg.encoder
    dt = dtype or cfg.compute_dtype
    dev = resolve_device(device)
    if kv_dtype not in ("float", "int8", "int4"):
        raise ValueError(f"encoder kv_dtype must be float, int8 or int4, "
                         f"got {kv_dtype!r}")
    # Folding a pending block of Sp columns stomps Sp slots past the cursor;
    # those must all be out-of-window, so Sp <= ring - window.
    pending_size = min(pending_size, ring_size - e.window)
    # pad the ring (cursor modulus) so the physical slot axis is a multiple
    # of 32 rows, as the JAX package does
    phys = ring_size + pending_size
    if phys % 32:
        ring_size += 32 - phys % 32
        phys = ring_size + pending_size
    quant = kv_dtype in ("int8", "int4")
    ring_dt = torch.int8 if quant else dt
    kw = e.attn_dim // 2 if kv_dtype == "int4" else e.attn_dim
    i32 = torch.int32

    def zeros(n):
        return tuple(torch.zeros((batch, n, kw), dtype=ring_dt, device=dev)
                     for _ in range(e.layers))

    def ones(n):
        return tuple(torch.ones((batch, e.heads, n), dtype=torch.float32,
                                device=dev) for _ in range(e.layers))

    return EncoderState(
        k_ring=zeros(phys), v_ring=zeros(phys),
        k_scale=ones(phys) if quant else None,
        v_scale=ones(phys) if quant else None,
        slot_pos=torch.full((batch, phys), SLOT_INVALID, dtype=i32, device=dev),
        pending_k=zeros(pending_size), pending_v=zeros(pending_size),
        pending_ks=ones(pending_size) if quant else None,
        pending_vs=ones(pending_size) if quant else None,
        pending_sp=torch.full((batch, pending_size), SLOT_INVALID, dtype=i32,
                              device=dev),
        pending_adv=torch.zeros((), dtype=i32, device=dev),
        write_ctr=torch.zeros((), dtype=i32, device=dev),
        next_pos=torch.zeros((batch,), dtype=i32, device=dev))


def reset_encoder_streams(state: EncoderState, mask: torch.Tensor,
                          reset_write_ctr: bool = False) -> EncoderState:
    """Per-stream encoder reset: invalidate the slot tables, positions to 0.
    reset_write_ctr only when ALL streams reset (B=1 streaming)."""
    zero = torch.zeros_like(state.write_ctr)
    return state._replace(
        slot_pos=torch.where(mask[:, None], SLOT_INVALID, state.slot_pos),
        pending_sp=torch.where(mask[:, None], SLOT_INVALID, state.pending_sp),
        pending_adv=zero if reset_write_ctr else state.pending_adv,
        write_ctr=zero if reset_write_ctr else state.write_ctr,
        next_pos=torch.where(mask, 0, state.next_pos))


def encoder_incremental(enc_params: dict, cfg: VoxtralConfig,
                        state: EncoderState, h_chunk: torch.Tensor,
                        n_valid=None):
    """Process a chunk of S post-conv positions per stream with the KV ring.

    h_chunk: [B, S, D] (rows >= n_valid are padding and masked out of
    state); n_valid: None, an int or a [B] int tensor. Returns (new_state,
    out [B, S, D]); rows >= n_valid are garbage. The rings of `state` are
    updated in place; no host sync."""
    e = cfg.encoder
    b, s, _ = h_chunk.shape
    dev = h_chunk.device
    i32 = torch.int32
    sp_cap = state.pending_sp.shape[1]
    phys = state.k_ring[0].shape[1]
    ring = phys - sp_cap          # logical ring = cursor modulus
    if s + e.window > ring:
        raise ValueError(
            f"chunk {s} + window {e.window} exceeds ring {ring}; "
            "older in-window keys would be overwritten")
    if s > sp_cap:
        raise ValueError(f"chunk {s} exceeds pending capacity {sp_cap}")
    if n_valid is None:
        n_valid = s
    if isinstance(n_valid, int):
        n_valid = torch.full((b,), n_valid, dtype=i32, device=dev)
    n_valid = n_valid.to(i32).expand(b)
    rows = torch.arange(s, dtype=i32, device=dev)
    positions = state.next_pos[:, None] + rows[None, :]          # [B, S]
    cos, sin = rope_angles(positions, e.head_dim, e.rope_theta)
    chunk_pos = torch.where(rows[None, :] < n_valid[:, None], positions,
                            SLOT_INVALID).to(i32)                # [B, S]

    # Fold the previous chunk's pending KV into the rings BEFORE any ring
    # read, in place at ctr % ring (the overflow margin guarantees no wrap).
    # The pending block is in the ring's own dtype, so the fold is a copy.
    quant = state.k_scale is not None
    slot0 = torch.remainder(state.write_ctr, ring)
    idx = slot0.long() + torch.arange(sp_cap, device=dev)
    for rings, pend in ((state.k_ring, state.pending_k),
                        (state.v_ring, state.pending_v)):
        for r, p in zip(rings, pend):
            r.index_copy_(1, idx, p)
    if quant:
        for scales, pend in ((state.k_scale, state.pending_ks),
                             (state.v_scale, state.pending_vs)):
            for sc, ps in zip(scales, pend):
                sc.index_copy_(2, idx, ps)
    rsp = state.slot_pos.index_copy(1, idx, state.pending_sp)
    base = state.write_ctr + state.pending_adv
    # Valid ring slots form a prefix: the kernel reads only slots below it.
    nv_slots = torch.clamp(state.write_ctr + sp_cap, max=phys).to(i32)

    h = h_chunk
    float_dt = h_chunk.dtype
    int4 = quant and state.k_ring[0].shape[-1] * 2 == e.attn_dim
    qkv = quantize_kv_int4 if int4 else quantize_kv
    chunk_k, chunk_v, chunk_ks, chunk_vs = [], [], [], []
    for l, lp in enumerate(enc_params["layers"]):
        x = rms_norm(h, lp["attn_norm"], e.norm_eps)
        q, k, v = _attn_block(lp, x, e, cos, sin)
        kd = k.reshape(b, s, e.attn_dim).to(float_dt)
        vd = v.reshape(b, s, e.attn_dim).to(float_dt)
        if quant:
            # quantize the chunk's K/V now, so the pending block is in the
            # ring's dtype; attention below still sees the float kd/vd
            qk, qks = qkv(kd, e.heads, e.head_dim)
            qv, qvs = qkv(vd, e.heads, e.head_dim)
            chunk_k.append(qk)
            chunk_v.append(qv)
            chunk_ks.append(qks)
            chunk_vs.append(qvs)
        else:
            chunk_k.append(kd)
            chunk_v.append(vd)
        attn = ring_attention(
            q.reshape(b, s, e.attn_dim), state.k_ring[l], state.v_ring[l], rsp,
            positions, window=e.window, heads=e.heads, kv_heads=e.heads,
            head_dim=e.head_dim,
            k_scale=state.k_scale[l] if quant else None,
            v_scale=state.v_scale[l] if quant else None,
            extra_kv=(kd, vd, chunk_pos), n_valid_slots=nv_slots)
        h = h + linear(attn.reshape(b, s, e.attn_dim), lp["wo"], lp["wo_b"])
        x = rms_norm(h, lp["ffn_norm"], e.norm_eps)
        h = h + linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]),
                       lp["w2"], lp["w2_b"])
    out = rms_norm(h, enc_params["norm"], e.norm_eps)

    pad = sp_cap - s                   # park the chunk as the pending block
    pk = tuple(F.pad(c, (0, 0, 0, pad)) for c in chunk_k)
    pv = tuple(F.pad(c, (0, 0, 0, pad)) for c in chunk_v)
    psp = F.pad(chunk_pos, (0, pad), value=SLOT_INVALID)
    pks = pvs = None
    if quant:
        pks = tuple(F.pad(c, (0, pad), value=1.0) for c in chunk_ks)
        pvs = tuple(F.pad(c, (0, pad), value=1.0) for c in chunk_vs)
    # The cursor advances by the longest valid prefix: trailing padding
    # columns are re-written by the next chunk.
    adv = torch.clamp(n_valid, max=s)
    new_state = EncoderState(
        k_ring=state.k_ring, v_ring=state.v_ring, k_scale=state.k_scale,
        v_scale=state.v_scale, slot_pos=rsp, pending_k=pk, pending_v=pv,
        pending_ks=pks, pending_vs=pvs, pending_sp=psp,
        pending_adv=torch.amax(adv).to(i32), write_ctr=base.to(i32),
        next_pos=(state.next_pos + adv).to(i32))
    return new_state, out
