"""Ministral-3 text decoder with a fixed-shape circular KV cache and batched
greedy decode (counterpart of `voxtral_tpu/models/decoder.py`).

GQA 32Q/8KV x 128, SwiGLU 9216, no biases, interleaved RoPE theta=1e6,
sliding window 8192, tied embeddings (f32 logits), per-layer ada_rms_norm
time conditioning applied after ffn_norm: h_norm * (1 + ada_scale).

The ring rules of the JAX package decide which slots are valid, and so the
tokens; the port keeps them:
- LOCKSTEP ring cursor: one write cursor shared by all streams, with a
  per-stream [B, P] table mapping slots to logical positions (attention
  masks by logical position).
- FOLD BEFORE READ: a chunk's KV accumulates in small per-layer [B, N, K]
  buffers during the decode loop (attention sees ring + chunk-so-far as
  extra masked columns) and is parked as a PENDING block; the next
  decode_scan folds it into the rings before any ring read.
- The fold never wraps: the physical ring carries an Np-slot overflow
  margin (P = R + Np; writes land at ctr % R).

Differences in form: the scan is a Python loop over tokens whose greedy
feedback stays on the device (no .item()/.cpu() per token; EOS is the
`done` mask, so the loop always runs N steps). The fold and the prefill
write the rings IN PLACE (`index_copy_` at a device-side offset): a state
passed to decode_scan/decoder_prefill must not be used again afterwards.
Without `collect_topk` the greedy head is one fused logits + argmax
(ops/logits_argmax.py), which gives jnp.argmax's token without the [B, V]
logits.

Weights may be float or Q8 (`quant.Quantized`, through `linear`,
`embed_lookup` and the greedy head); no code here forks on it.

kv_dtype="int8": rings are int8 codes with per-(slot, kv-head) f32 scale
tables [B, Hkv, P]; the pending block stays float and is quantized at fold
time (quant.py:quantize_kv), the prefill quantizes as it writes. The ring
attention applies the scales to score and probability columns.

Lockstep caveat (as in the JAX package): the shared cursor advances by the
longest active prefix over the batch, so a stream that idles while
siblings decode has its slots recycled sooner.

Tensor parallelism (`tp`, a `parallel.TensorParallel`): the rank holds its
heads' columns of wq/wk/wv, rows of wo, columns of w1/w3, rows of w2, its
vocab rows of the tied table and rings of its kv heads for its own streams;
wo and w2's partial products are all-reduced over the model group, the
token embedding and the greedy head work on the vocab shard
(ops/linear.py, ops/logits_argmax.py), and the cursor's advance is a max
over the data group. With `tp=None` every path is the single-device one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.ops import add_rms_norm, apply_rope, rms_norm, rope_angles
from voxtral_tpu_torch.ops.attention import windowed_attention
from voxtral_tpu_torch.ops.linear import embed_logits, embed_lookup, linear, row_linear
from voxtral_tpu_torch.ops.logits_argmax import logits_argmax
from voxtral_tpu_torch.ops.ring_attention import ring_attention
from voxtral_tpu_torch.quant import Quantized, dequantize, quantize_kv
from voxtral_tpu_torch.utils import resolve_device

SLOT_INVALID = -(1 << 30)


def alt_candidates(logits: torch.Tensor, tok: torch.Tensor, n_special: int,
                   k: int):
    """Alt-token candidates with full-vocab-scan semantics (voxtral.c:955-1010):
    top-k over logits with the specials and the emitted token masked out.

    logits: [B, V] f32; tok: [B]. Returns (vals [B, k] f32 (-inf once
    candidates run out), idx [B, k] int32, best_logit [B] f32)."""
    iota = torch.arange(logits.shape[1], device=logits.device)[None, :]
    masked = torch.where((iota < n_special) | (iota == tok[:, None]),
                         float("-inf"), logits)
    vals, idxs = torch.topk(masked, k, dim=1)
    best = torch.gather(logits, 1, tok[:, None].long())[:, 0]
    return vals, idxs.to(torch.int32), best


def time_conditioning(delay_tokens: float, dim: int, theta: float = 10000.0,
                      device="cpu") -> torch.Tensor:
    """Sinusoidal embedding of the transcription delay
    (python_simple_implementation.py:344-349). Returns [dim] f32, computed
    in f32 in the JAX order."""
    half = dim // 2
    inv_freq = torch.exp(-math.log(theta)
                         * torch.arange(half, dtype=torch.float32, device=device)
                         / half)
    emb = float(delay_tokens) * inv_freq
    return torch.cat([torch.cos(emb), torch.sin(emb)])


def ada_scales(dec_params: dict, t_cond: torch.Tensor) -> torch.Tensor:
    """Per-layer ada scales [L, D], computed once per delay setting
    (voxtral.c:57-79). Q8 ada weights (a Q8 file's) are dequantized."""
    tc = t_cond.float()

    def f32w(w):
        return dequantize(w) if isinstance(w, Quantized) else w.float()

    rows = [F.gelu(tc @ f32w(lp["ada_down"])) @ f32w(lp["ada_up"])
            for lp in dec_params["layers"]]
    return torch.stack(rows)


class DecodeState(NamedTuple):
    """Batched decoder stream state (leading axis B = concurrent streams).

    k_ring/v_ring: tuples of L per-layer [B, P, Hkv*hd] circular buffers
    (P = R + Np). pending_*: the most recent chunk's KV, not yet folded into
    the rings; write_ctr is the ring slot where pending column 0 lands;
    pending_adv is how far the cursor advances after the fold. Scalars are
    0-dim int32 tensors on the state's device. k_scale/v_scale: int8 rings
    only, None for float rings."""
    k_ring: tuple          # L x [B, P, Hkv*hd]
    v_ring: tuple          # L x [B, P, Hkv*hd]
    k_scale: tuple | None  # L x [B, Hkv, P] f32 (int8 mode only)
    v_scale: tuple | None
    slot_pos: torch.Tensor    # [B, P] int32 logical position per slot
    pending_k: tuple          # L x [B, Np, Hkv*hd]
    pending_v: tuple          # L x [B, Np, Hkv*hd]
    pending_sp: torch.Tensor  # [B, Np] int32 (SLOT_INVALID = empty column)
    pending_adv: torch.Tensor  # [] int32
    write_ctr: torch.Tensor   # [] int32
    pos: torch.Tensor         # [B] int32 next decode position
    prev_token: torch.Tensor  # [B] int32
    done: torch.Tensor        # [B] bool (EOS seen)


def init_decode_state(cfg: VoxtralConfig, batch: int = 1, dtype=None,
                      ring_size: int | None = None,
                      pending_size: int = 64,
                      kv_dtype: str = "float",
                      device="cuda") -> DecodeState:
    """ring_size (the cursor modulus R) defaults to window + pending_size so
    pending folds can never clobber an in-window slot. kv_dtype: "float" or
    "int8" (int4 rings are encoder-only, as in the JAX package)."""
    if kv_dtype not in ("float", "int8"):
        raise ValueError(
            f"decoder kv_dtype must be 'float' or 'int8', got {kv_dtype!r} "
            "(int4 rings are encoder-only: pass enc_kv_dtype='int4')")
    dev = resolve_device(device)
    d = cfg.decoder
    dt = dtype or cfg.compute_dtype
    ring = ring_size or (d.window + pending_size)
    if pending_size > ring:
        raise ValueError(f"pending_size {pending_size} > ring {ring}")
    # 32-row-aligned physical slot axis (as the JAX package, for int8 tiles)
    phys = ring + pending_size
    if phys % 32:
        ring += 32 - phys % 32
        phys = ring + pending_size
    i32 = torch.int32
    int8 = kv_dtype == "int8"

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scales():
        return tuple(torch.ones((batch, d.kv_heads, phys), dtype=torch.float32,
                                device=dev) for _ in range(d.layers))

    ring_dt = torch.int8 if int8 else dt
    return DecodeState(
        k_ring=tuple(zeros(batch, phys, d.kv_dim, dtype=ring_dt)
                     for _ in range(d.layers)),
        v_ring=tuple(zeros(batch, phys, d.kv_dim, dtype=ring_dt)
                     for _ in range(d.layers)),
        k_scale=scales() if int8 else None,
        v_scale=scales() if int8 else None,
        slot_pos=torch.full((batch, phys), SLOT_INVALID, dtype=i32, device=dev),
        pending_k=tuple(zeros(batch, pending_size, d.kv_dim)
                        for _ in range(d.layers)),
        pending_v=tuple(zeros(batch, pending_size, d.kv_dim)
                        for _ in range(d.layers)),
        pending_sp=torch.full((batch, pending_size), SLOT_INVALID, dtype=i32,
                              device=dev),
        pending_adv=torch.zeros((), dtype=i32, device=dev),
        write_ctr=torch.zeros((), dtype=i32, device=dev),
        pos=torch.zeros((batch,), dtype=i32, device=dev),
        prev_token=torch.full((batch,), 1, dtype=i32, device=dev),   # BOS
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
    )


def init_decode_state_(state: DecodeState) -> DecodeState:
    """init_decode_state's values written into `state`'s own tensors (every
    tensor keeps its storage). Returns `state`."""
    for t in (*state.k_ring, *state.v_ring, *state.pending_k, *state.pending_v,
              state.pending_adv, state.write_ctr, state.pos, state.done):
        t.zero_()
    for t in (*(state.k_scale or ()), *(state.v_scale or ())):
        t.fill_(1.0)
    state.slot_pos.fill_(SLOT_INVALID)
    state.pending_sp.fill_(SLOT_INVALID)
    state.prev_token.fill_(1)                                        # BOS
    return state


def reset_streams(state: DecodeState, mask: torch.Tensor, bos_token: int = 1,
                  reset_write_ctr: bool = False) -> DecodeState:
    """Per-stream decoder reset: pos := 0 and the slot tables invalidated —
    ring contents need no clearing. mask: [B] bool, True = reset that stream.
    reset_write_ctr: only valid when every stream resets."""
    zero = torch.zeros_like(state.write_ctr)
    return state._replace(
        slot_pos=torch.where(mask[:, None], SLOT_INVALID, state.slot_pos),
        pending_sp=torch.where(mask[:, None], SLOT_INVALID, state.pending_sp),
        pending_adv=zero if reset_write_ctr else state.pending_adv,
        write_ctr=zero if reset_write_ctr else state.write_ctr,
        pos=torch.where(mask, 0, state.pos),
        prev_token=torch.where(mask, bos_token, state.prev_token),
        done=torch.where(mask, False, state.done))


def retained_window(state: DecodeState, window: int) -> torch.Tensor:
    """Per-stream count of in-window KV entries actually present (ring +
    pending): the checkable form of the lockstep-lag caveat. A stream
    advancing every step retains min(pos, window, ring); a stream that idles
    while siblings decode has its oldest slots recycled by the shared cursor
    and this count shrinks below its nominal window. Returns [B] int32."""
    lo = state.pos[:, None] - window
    hi = state.pos[:, None]

    def count(sp):
        return ((sp >= lo) & (sp < hi)).sum(dim=1)

    return (count(state.slot_pos) + count(state.pending_sp)).to(torch.int32)


def _write_slots(rings, scales, vals, idx, kv_heads, head_dim):
    """Write `vals` (L x [B, N, K] float) into slots `idx` of each ring, in
    place; int8 rings (scales not None) take quantize_kv's codes and
    scales."""
    for l, (r, x) in enumerate(zip(rings, vals)):
        if scales is None:
            r.index_copy_(1, idx, x.to(r.dtype))
        else:
            qv, qs = quantize_kv(x, kv_heads, head_dim)
            r.index_copy_(1, idx, qv)
            scales[l].index_copy_(2, idx, qs)


def _fold_pending(state: DecodeState, kv_heads: int, head_dim: int):
    """Fold the pending chunk into the rings — one in-place copy per ring at
    slot ctr % R, issued before any ring read (the overflow margin
    guarantees it never wraps). The slot offset stays on the device. Int8
    rings: the float pending is quantized here; its scales land in the scale
    tables at the same slots. Returns (k_rings, v_rings, k_scales, v_scales,
    slot_pos, base) with base = cursor for the next chunk."""
    np_ = state.pending_sp.shape[1]
    ring = state.k_ring[0].shape[1] - np_
    slot = torch.remainder(state.write_ctr, ring)
    idx = slot.long() + torch.arange(np_, device=slot.device)
    _write_slots(state.k_ring, state.k_scale, state.pending_k, idx, kv_heads,
                 head_dim)
    _write_slots(state.v_ring, state.v_scale, state.pending_v, idx, kv_heads,
                 head_dim)
    sp = state.slot_pos.index_copy(1, idx, state.pending_sp)
    return (state.k_ring, state.v_ring, state.k_scale, state.v_scale, sp,
            state.write_ctr + state.pending_adv)


def _layer_matmuls(lp, x, cfg):
    d = cfg
    s = x.shape[0]
    q = linear(x, lp["wq"]).reshape(s, d.heads, d.head_dim)
    k = linear(x, lp["wk"]).reshape(s, d.kv_heads, d.head_dim)
    v = linear(x, lp["wv"]).reshape(s, d.kv_heads, d.head_dim)
    return q, k, v


def decoder_prefill(dec_params: dict, cfg: VoxtralConfig, state: DecodeState,
                    embeds: torch.Tensor, t_ada: torch.Tensor,
                    n_valid: torch.Tensor | None = None, tp=None) -> DecodeState:
    """Multi-token prefill from position 0 on a FRESH/reset state
    (write_ctr == 0). embeds: [B, S, D]; t_ada: [L, D] ada scales; n_valid:
    [B] (rows beyond are padding).

    Produces no logits: the first sampled token comes from the first
    decode_scan step. Writes the rings directly (in place) and leaves an
    empty pending block."""
    d = (cfg if tp is None else tp.local(cfg)).decoder
    b, s, _ = embeds.shape
    dev = embeds.device
    n_valid_given = n_valid is not None
    if n_valid is None:
        n_valid = torch.full((b,), s, dtype=torch.int32, device=dev)
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    cos, sin = rope_angles(positions, d.head_dim, d.rope_theta)
    # as decode_scan: the ada row cast to the activation dtype, then 1 added
    ada_rows = [1.0 + t_ada[l].to(cfg.compute_dtype) for l in range(d.layers)]

    def one_stream(emb):
        """[S, D] -> per-layer (k, v) [S, Hkv*hd] lists; attention is over
        the prefix itself (fresh cache), so ring reads are not needed."""
        h, ffn = emb, None
        ks, vs = [], []
        for l, lp in enumerate(dec_params["layers"]):
            if ffn is None:
                x = rms_norm(h, lp["attn_norm"], d.norm_eps)
            else:
                h, x = add_rms_norm(h, ffn, lp["attn_norm"], d.norm_eps)
            q, k, v = _layer_matmuls(lp, x, d)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            attn = windowed_attention(q, k, v, window=d.window)
            h, x = add_rms_norm(h, row_linear(attn.reshape(s, d.q_dim), lp["wo"], tp=tp),
                                lp["ffn_norm"], d.norm_eps, ada_rows[l])
            ffn = row_linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]), lp["w2"],
                             tp=tp)
            ks.append(k.reshape(s, d.kv_dim))
            vs.append(v.reshape(s, d.kv_dim))
        return ks, vs

    per_stream = [one_stream(e) for e in embeds.to(cfg.compute_dtype)]
    k_all = [torch.stack([ks[l] for ks, _ in per_stream]) for l in range(d.layers)]
    v_all = [torch.stack([vs[l] for _, vs in per_stream]) for l in range(d.layers)]
    row_pos = torch.where(positions[None, :] < n_valid[:, None],
                          positions[None, :], SLOT_INVALID).to(torch.int32)
    np_ = state.pending_sp.shape[1]
    ring = state.k_ring[0].shape[1] - np_   # logical ring (cursor modulus)
    if s > ring and n_valid_given:
        raise ValueError(
            f"prefill longer than the ring ({s} > {ring}) cannot carry "
            "per-stream n_valid padding")
    if s > ring:
        # Only the last `ring` positions survive; slot j holds position
        # p = j (mod ring), i.e. the kept rows rolled by s % ring.
        shift = s % ring
        k_all = [torch.roll(k[:, s - ring:], shift, dims=1) for k in k_all]
        v_all = [torch.roll(v[:, s - ring:], shift, dims=1) for v in v_all]
        row_pos = torch.roll(row_pos[:, s - ring:], shift, dims=1)

    n = row_pos.shape[1]                    # slots 0..min(S, ring)-1
    idx = torch.arange(n, device=dev)
    _write_slots(state.k_ring, state.k_scale, k_all, idx, d.kv_heads, d.head_dim)
    _write_slots(state.v_ring, state.v_scale, v_all, idx, d.kv_heads, d.head_dim)
    slot_pos = state.slot_pos.clone()
    slot_pos[:, :n] = row_pos
    return state._replace(
        slot_pos=slot_pos,
        pending_sp=torch.full_like(state.pending_sp, SLOT_INVALID),
        pending_adv=torch.zeros_like(state.pending_adv),
        write_ctr=torch.full_like(state.write_ctr, s),
        pos=n_valid.to(torch.int32))


def decode_scan(dec_params: dict, cfg: VoxtralConfig, state: DecodeState,
                frames: torch.Tensor, n_valid: torch.Tensor, t_ada: torch.Tensor,
                *, collect_topk: int = 0, stop_at_eos: bool = True,
                forced_tokens: torch.Tensor | None = None, tp=None):
    """Greedy-decode up to N tokens per stream.

    frames: [B, N, D] adapter outputs for positions state.pos + i
    n_valid: [B] int32 number of real frames per stream (rest is padding)
    forced_tokens: optional [B, N] int32; entries >= 0 override the greedy
    choice as the feedback/emitted token.
    Returns (new_state, tokens [B, N] int32 (-1 where inactive), aux dict
    with top-k/logit info and the packed wire when collect_topk > 0).

    Inactive steps (i >= n_valid or done) contribute SLOT_INVALID chunk
    columns and emit -1; pos/prev_token stay frozen. The rings of `state`
    are updated in place. With `tp`, the state, the frames and the tokens
    are this rank's streams.
    """
    d = (cfg if tp is None else tp.local(cfg)).decoder
    b, n, _ = frames.shape
    np_ = state.pending_sp.shape[1]
    if n > np_:
        # A chunk larger than the pending block decodes as sequential
        # segments.
        toks, auxes = [], []
        for s0 in range(0, n, np_):
            s1 = min(s0 + np_, n)
            seg_nv = torch.clamp(n_valid - s0, 0, s1 - s0).to(torch.int32)
            seg_forced = None if forced_tokens is None \
                else forced_tokens[:, s0:s1]
            state, t, a = decode_scan(
                dec_params, cfg, state, frames[:, s0:s1], seg_nv, t_ada,
                collect_topk=collect_topk, stop_at_eos=stop_at_eos,
                forced_tokens=seg_forced, tp=tp)
            toks.append(t)
            auxes.append(a)
        aux_out = {k: torch.cat([a[k] for a in auxes], dim=1)
                   for k in auxes[0]}
        return state, torch.cat(toks, dim=1), aux_out

    embed = dec_params["embed"]
    eos = cfg.streaming.eos
    dev = frames.device
    i32 = torch.int32

    # Fold the previous chunk's KV into the rings BEFORE any ring read.
    k_rings, v_rings, k_ss, v_ss, ring_sp, base = _fold_pending(
        state, d.kv_heads, d.head_dim)
    # Slots touched so far form a prefix; the kernel reads only it.
    phys = state.slot_pos.shape[1]
    nv_slots = torch.clamp(state.write_ctr + np_, max=phys).to(i32)

    rdt = state.pending_k[0].dtype             # chunk KV stays float
    chunk_k = [torch.zeros((b, n, d.kv_dim), dtype=rdt, device=dev)
               for _ in range(d.layers)]
    chunk_v = [torch.zeros((b, n, d.kv_dim), dtype=rdt, device=dev)
               for _ in range(d.layers)]
    chunk_pos = torch.full((b, n), SLOT_INVALID, dtype=i32, device=dev)
    pos, prev, done = state.pos, state.prev_token, state.done
    # as the JAX package: cast the ada row to the activation dtype, then add 1
    ada_rows = [1.0 + t_ada[l].to(cfg.compute_dtype) for l in range(d.layers)]
    invalid = torch.full_like(pos, SLOT_INVALID)
    neg_one = torch.full_like(pos, -1)
    toks, tops = [], []

    for i in range(n):
        active = n_valid > i
        if stop_at_eos:
            active = active & ~done
        tok_emb = embed_lookup(embed, prev, tp=tp)                # [B, D]
        h = ((frames[:, i].float() + tok_emb)[:, None, :]
             .to(cfg.compute_dtype))                              # [B, 1, D]
        cos, sin = rope_angles(pos[:, None], d.head_dim, d.rope_theta)
        chunk_pos[:, i] = torch.where(active, pos, invalid)
        ffn = None              # the previous layer's FFN output, added at the next norm
        for l in range(d.layers):
            lp = dec_params["layers"][l]
            if ffn is None:
                x = rms_norm(h, lp["attn_norm"], d.norm_eps)
            else:
                h, x = add_rms_norm(h, ffn, lp["attn_norm"], d.norm_eps)
            q = linear(x, lp["wq"]).reshape(b, 1, d.heads, d.head_dim)
            k = linear(x, lp["wk"]).reshape(b, 1, d.kv_heads, d.head_dim)
            v = linear(x, lp["wv"]).reshape(b, 1, d.kv_heads, d.head_dim)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            chunk_k[l][:, i] = k.reshape(b, d.kv_dim)
            chunk_v[l][:, i] = v.reshape(b, d.kv_dim)
            attn = ring_attention(
                q.reshape(b, 1, d.q_dim), k_rings[l], v_rings[l], ring_sp,
                pos[:, None], window=d.window, heads=d.heads,
                kv_heads=d.kv_heads, head_dim=d.head_dim,
                k_scale=None if k_ss is None else k_ss[l],
                v_scale=None if v_ss is None else v_ss[l],
                extra_kv=(chunk_k[l], chunk_v[l], chunk_pos),
                n_valid_slots=nv_slots)                           # [B, 1, Qd]
            h, x = add_rms_norm(h, row_linear(attn, lp["wo"], tp=tp), lp["ffn_norm"],
                                d.norm_eps, ada_rows[l])
            ffn = row_linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]), lp["w2"],
                             tp=tp)

        _, hn = add_rms_norm(h[:, 0], ffn[:, 0], dec_params["norm"], d.norm_eps)
        if collect_topk > 0:
            logits = embed_logits(hn, embed, tp)                  # [B, V]
            tok = torch.argmax(logits, dim=-1).to(i32)
        else:                       # fused logits + argmax (K3 on the card)
            tok = logits_argmax(hn, embed, tp)
        if forced_tokens is not None:
            forced_i = forced_tokens[:, i]
            tok = torch.where(forced_i >= 0, forced_i, tok)
        prev = torch.where(active, tok, prev)
        pos = torch.where(active, pos + 1, pos)
        if stop_at_eos:
            done = done | (active & (tok == eos))
        toks.append(torch.where(active, tok, neg_one))
        if collect_topk > 0:
            tops.append(alt_candidates(logits, tok, cfg.streaming.n_special,
                                       collect_topk))

    # Park this chunk as the new pending block (padded to Np). The cursor
    # advances by the longest ACTIVE prefix, not the padded chunk length.
    if n < np_:
        pk = tuple(F.pad(c, (0, 0, 0, np_ - n)) for c in chunk_k)
        pv = tuple(F.pad(c, (0, 0, 0, np_ - n)) for c in chunk_v)
        psp = F.pad(chunk_pos, (0, np_ - n), value=SLOT_INVALID)
    else:
        pk, pv, psp = tuple(chunk_k), tuple(chunk_v), chunk_pos
    n_act = torch.amax(torch.clamp(n_valid, max=n)).to(i32)
    if tp is not None:
        n_act = tp.data_max(n_act)
    new_state = state._replace(
        k_ring=k_rings, v_ring=v_rings, k_scale=k_ss, v_scale=v_ss,
        slot_pos=ring_sp,
        pending_k=pk, pending_v=pv, pending_sp=psp,
        pending_adv=n_act, write_ctr=base,
        pos=pos, prev_token=prev, done=done)
    tokens = torch.stack(toks, dim=1)                              # [B, N]
    aux_out = {}
    if collect_topk > 0:
        vals = torch.stack([t[0] for t in tops], dim=1)            # [B, N, k]
        idxs = torch.stack([t[1] for t in tops], dim=1)
        best = torch.stack([t[2] for t in tops], dim=1)            # [B, N]
        aux_out = {"topk_vals": vals, "topk_idx": idxs, "best_logit": best}
        # One-transfer wire form: int32 columns ride as f32 bit patterns.
        aux_out["packed"] = torch.cat([
            tokens.view(torch.float32)[:, :, None],
            best[:, :, None].float(),
            vals.float(),
            idxs.view(torch.float32),
        ], dim=-1)                                                 # [B, N, 2k+2]
    return new_state, tokens, aux_out
