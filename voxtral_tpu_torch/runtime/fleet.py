"""Fleet step: the multi-stream serving hot path (counterpart of
`voxtral_tpu/runtime/fleet.py`).

One step advances B concurrent streams by one fixed-size audio chunk:
device log-mel (PCM entry points) -> batched conv stem (tail-carried) ->
batched ring-cache encoder -> adapter -> decode of the chunk's tokens.

Chunk contract: T mel frames per stream per step, T % 8 == 0 (T mel ->
T conv0 -> T/2 encoder positions -> T/8 decoder tokens).

The JAX entry points donate the state (`donate_argnums=(2,)`). Here the
encoder and decoder rings (and their scale tables) are updated IN PLACE: a
FleetState passed to a step must not be used again afterwards; use the
state the step returns. The other fields are new tensors. Everything runs
on the device of the state and params; a step makes no host sync (no
`.item()`, no host copies), so its launches queue ahead of the card.

Tensor and data parallelism: every entry point takes `tp`, this rank's
`parallel.TensorParallel`, with params from `parallel.shard_params`. The
state is built rank-local by `init_fleet_state(..., tp=tp)` (B / n_data
streams, heads / n_model), a step takes the rank's own streams' audio and
returns their tokens; the collectives are the model code's (models/*.py).
`fleet_reset_slots` and `age_fleet_state` need no `tp`: they touch only the
per-stream tables of the state they are given.

`copy_state` writes one state's values into another's own tensors, and
`fleet_reset_slots_` resets slots that way (`init_fleet_state_` the whole
state): a captured step
(runtime/step_graph.py) reads and writes the same state tensors on every
replay, so whatever changes the state between steps must land in them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from voxtral_tpu_torch.audio.mel import _frame_index, _mel_tables, _power_mel
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    SLOT_INVALID, DecodeState, decode_scan, decoder_prefill, init_decode_state,
    init_decode_state_, reset_streams,
)
from voxtral_tpu_torch.models.encoder import (
    EncoderState, encoder_incremental, init_encoder_state, init_encoder_state_,
    reset_encoder_streams,
)
from voxtral_tpu_torch.ops.linear import embed_lookup
from voxtral_tpu_torch.utils import resolve_device

_I32 = torch.int32


class FleetState(NamedTuple):
    pcm_tail: torch.Tensor    # [B, window-hop=240] f32 (device-mel path)
    mel_tail: torch.Tensor    # [B, mel_bins, 2] f32
    conv0_tail: torch.Tensor  # [B, enc_dim, 2] f32
    encoder: EncoderState     # batched
    decode: DecodeState       # batched


def init_fleet_state(cfg: VoxtralConfig, batch: int, *, enc_ring: int = 1280,
                     dec_ring: int | None = None, dtype=None,
                     max_mel_chunk: int = 320, kv_dtype: str = "float",
                     enc_kv_dtype: str | None = None,
                     device="cuda", tp=None) -> FleetState:
    """max_mel_chunk: the largest mel chunk any step will see (bootstrap
    included); it sizes the pending KV blocks (mel/2 encoder positions,
    mel/8 decoder tokens). kv_dtype: "float" or "int8" rings; enc_kv_dtype
    overrides the encoder rings ("int4" packs them to nibbles). With `tp`,
    `batch` is the whole fleet's and the state this rank's share."""
    dev = resolve_device(device)
    if tp is not None:
        batch, cfg = tp.local_batch(batch), tp.local(cfg)
    dt = dtype or cfg.compute_dtype
    e = cfg.encoder
    a = cfg.audio
    dec = init_decode_state(cfg, batch=batch, dtype=dt, ring_size=dec_ring,
                            pending_size=max_mel_chunk // 8,
                            kv_dtype=kv_dtype, device=dev)
    enc = init_encoder_state(cfg, ring_size=enc_ring, batch=batch, dtype=dt,
                             pending_size=max_mel_chunk // 2,
                             kv_dtype=enc_kv_dtype or kv_dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return FleetState(
        pcm_tail=torch.zeros((batch, a.window_size - a.hop_length), **f32),
        mel_tail=torch.zeros((batch, a.mel_bins, 2), **f32),
        conv0_tail=torch.zeros((batch, e.dim, 2), **f32),
        encoder=enc, decode=dec)


def init_fleet_state_(state: FleetState) -> FleetState:
    """init_fleet_state's values written into `state`'s own tensors (every
    tensor keeps its storage). Returns `state`."""
    for t in (state.pcm_tail, state.mel_tail, state.conv0_tail):
        t.zero_()
    init_encoder_state_(state.encoder)
    init_decode_state_(state.decode)
    return state


def _batched_causal_conv(x, w, b, stride, discard):
    """x: [B, C_in, 2+T] (tail included) -> [B, C_out, T'] with the first
    `discard` outputs (zero-pad contaminated) dropped, + exact GELU.
    w: [K, C_in, C_out]. f32 throughout, as K strided slices through f32
    matmul (never a cuDNN TF32 convolution)."""
    k = w.shape[0]
    xp = F.pad(x.float(), (k - stride, 0))
    out_len = (xp.shape[2] - k) // stride + 1
    wf = w.float()
    y = None
    for i in range(k):
        tap = xp[:, :, i:i + stride * (out_len - 1) + 1:stride]  # [B, C_in, T']
        yi = torch.matmul(wf[i].t(), tap)                        # [B, C_out, T']
        y = yi if y is None else y + yi
    y = y + b.float()[None, :, None]
    return F.gelu(y)[:, :, discard:]


def _conv_stem_with_tails(cfg, enc_p, state: FleetState, mel):
    """mel [B, mel_bins, T] -> (h [B, T/2, D], conv0 activations y)."""
    x0 = torch.cat([state.mel_tail, mel], dim=2)
    y = _batched_causal_conv(x0, enc_p["conv0_w"], enc_p["conv0_b"], 1, 2)
    x1 = torch.cat([state.conv0_tail, y], dim=2)
    c = _batched_causal_conv(x1, enc_p["conv1_w"], enc_p["conv1_b"], 2, 1)
    return c.transpose(1, 2).to(cfg.compute_dtype), y


def _adapter(params, cfg, enc_out, tp):
    """[B, S, enc_dim] -> [B, S/ds, dec_dim]: the adapter on every stream."""
    b, s, d = enc_out.shape
    out = adapter_forward(params["adapter"], cfg, enc_out.reshape(b * s, d), tp)
    return out.reshape(b, s // cfg.downsample, -1)


def _full(b, value, like):
    return torch.full((b,), value, dtype=_I32, device=like.device)


def _fleet_step_inner(params, cfg: VoxtralConfig, state: FleetState, mel,
                      t_ada, *, stop_at_eos: bool = False,
                      collect_topk: int = 0, tp=None):
    b, _, t = mel.shape
    if t % 8:
        raise ValueError(f"mel chunk {t} is not a multiple of 8")
    enc_p = params["encoder"]
    h, y = _conv_stem_with_tails(cfg, enc_p, state, mel)       # [B, T/2, D]
    enc_state, enc_out = encoder_incremental(enc_p, cfg, state.encoder, h, tp=tp)
    frames = _adapter(params, cfg, enc_out, tp)                # [B, T/8, Dd]
    dec, tokens, aux = decode_scan(
        params["decoder"], cfg, state.decode, frames, _full(b, t // 8, mel),
        t_ada, collect_topk=collect_topk, stop_at_eos=stop_at_eos, tp=tp)
    new_state = FleetState(pcm_tail=state.pcm_tail, mel_tail=mel[:, :, -2:],
                           conv0_tail=y[:, :, -2:], encoder=enc_state,
                           decode=dec)
    return new_state, tokens, aux


def _prompt_prefill(params, cfg, dec: DecodeState, frames, t_ada,
                    prompt_ids=None, tp=None) -> DecodeState:
    """Prefill the prompt on frames [B, P-1, Dd]; prompt_ids [P] (default:
    BOS + STREAMING_PAD * (P-1), built on the device)."""
    b, n, _ = frames.shape
    st = cfg.streaming
    if prompt_ids is None:
        prompt_ids = torch.full((n + 1,), st.streaming_pad, dtype=_I32,
                                device=frames.device)
        prompt_ids[0] = st.bos
    embed = params["decoder"]["embed"]
    prefix = frames.float() + embed_lookup(embed, prompt_ids[:-1], tp=tp)[None]
    dec = decoder_prefill(params["decoder"], cfg, dec, prefix, t_ada, tp=tp)
    return dec._replace(
        prev_token=prompt_ids[-1:].to(_I32).expand(b).contiguous(),
        done=torch.zeros((b,), dtype=torch.bool, device=frames.device))


def _fleet_bootstrap_inner(params, cfg: VoxtralConfig, state: FleetState,
                           mel, t_ada, *, stop_at_eos: bool = False, tp=None):
    """First chunk of a fresh fleet: encode mel [B, mel_bins, T0]
    (T0 >= 8 * prompt_len, T0 % 8 == 0), prefill the 39-token prompt on the
    first frames, then decode the remainder. Returns (state, tokens
    [B, T0//8 - (prompt_len-1)], aux)."""
    b, _, t = mel.shape
    lp = cfg.streaming.prompt_len
    if t % 8 or t // 8 < lp:
        raise ValueError(f"bootstrap mel {t}: needs T0 % 8 == 0 and "
                         f"T0 >= {8 * lp}")
    enc_p = params["encoder"]
    h, y = _conv_stem_with_tails(cfg, enc_p, state, mel)
    # The encoder runs in pending-capacity sub-chunks, so the pending block
    # stays sized for the steady chunk.
    sp_cap = state.encoder.pending_sp.shape[1]
    enc_state, outs = state.encoder, []
    for s0 in range(0, h.shape[1], sp_cap):
        enc_state, o = encoder_incremental(enc_p, cfg, enc_state,
                                           h[:, s0:s0 + sp_cap], tp=tp)
        outs.append(o)
    frames = _adapter(params, cfg, torch.cat(outs, dim=1), tp)
    dec = _prompt_prefill(params, cfg, state.decode, frames[:, :lp - 1], t_ada, tp=tp)
    rest = frames[:, lp - 1:]
    dec, tokens, aux = decode_scan(
        params["decoder"], cfg, dec, rest, _full(b, rest.shape[1], mel), t_ada,
        stop_at_eos=stop_at_eos, tp=tp)
    new_state = FleetState(pcm_tail=state.pcm_tail, mel_tail=mel[:, :, -2:],
                           conv0_tail=y[:, :, -2:], encoder=enc_state,
                           decode=dec)
    return new_state, tokens, aux


@torch.no_grad()
def fleet_step(params, cfg: VoxtralConfig, state: FleetState, mel, t_ada, *,
               stop_at_eos: bool = False, collect_topk: int = 0, tp=None):
    """mel: [B, mel_bins, T] f32 (T % 8 == 0). Returns (state, tokens
    [B, T//8], aux). See fleet_step_pcm for the raw-audio variant."""
    return _fleet_step_inner(params, cfg, state, mel, t_ada,
                             stop_at_eos=stop_at_eos, collect_topk=collect_topk, tp=tp)


@torch.no_grad()
def fleet_bootstrap(params, cfg: VoxtralConfig, state: FleetState, mel, t_ada,
                    *, stop_at_eos: bool = False, tp=None):
    return _fleet_bootstrap_inner(params, cfg, state, mel, t_ada,
                                  stop_at_eos=stop_at_eos, tp=tp)


@torch.no_grad()
def fleet_prefill(params, cfg: VoxtralConfig, state: FleetState, frames,
                  prompt_ids, t_ada, tp=None) -> FleetState:
    """Batched prompt prefill: frames [B, P-1, Dd], prompt_ids [P] int."""
    dec = _prompt_prefill(params, cfg, state.decode, frames, t_ada, prompt_ids, tp)
    return state._replace(decode=dec)


# ---------------------------------------------------------------------------
# Device-side mel: raw PCM in, log-mel as three f32 products
# ---------------------------------------------------------------------------

def pcm_stream_skew(cfg: VoxtralConfig) -> int:
    """The PCM fleet path consumes the padded sample stream minus its first
    (window - hop) - window//2 = 40 samples (always zeros). The zero
    pcm_tail then stands in for the 200-sample reflect pad, and device frame
    t covers the same samples as batch_log_mel frame t."""
    a = cfg.audio
    return (a.window_size - a.hop_length) - a.window_size // 2


def pcm_stream(padded: np.ndarray, cfg: VoxtralConfig):
    """Padded audio (pad_audio_offline output) -> the stream to feed
    fleet_*_pcm. Drops the zero skew prefix (see pcm_stream_skew)."""
    return padded[..., pcm_stream_skew(cfg):]


def _device_log_mel(cfg: VoxtralConfig, pcm_tail, pcm):
    """pcm_tail: [B, window-hop], pcm: [B, T*hop] f32 -> (mel [B, mel_bins,
    T], new_tail). Frame t covers concat(tail, pcm)[t*hop : t*hop+window]:
    the math of audio/mel.py:batch_log_mel (windowed framing, DFT as f32
    products, Slaney filters). The products run one stream at a time: a
    product over all B x T frames rounds a row apart as B changes (cuBLAS
    picks its kernel by shape), and a stream's tokens would then follow the
    fleet's size, a data rank's share of it included."""
    a = cfg.audio
    t = pcm.shape[1] // a.hop_length
    dev = str(pcm.device)
    hann, cosm, sinm, filt = _mel_tables(a, dev)
    x = torch.cat([pcm_tail, pcm], dim=1)                       # [B, lap + T*hop]
    frames = x[:, _frame_index(a, t, dev)] * hann[None, None]   # [B, T, window]
    mel = torch.stack([_power_mel(f, cosm, sinm, filt) for f in frames])   # [B, T, mel]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.clamp(log_spec, min=a.log_mel_max - 8.0)
    mel_out = ((log_spec + 4.0) / 4.0).transpose(1, 2)          # [B, mel, T]
    lap = a.window_size - a.hop_length
    return mel_out.float(), x[:, -lap:]


@torch.no_grad()
def fleet_step_pcm(params, cfg: VoxtralConfig, state: FleetState, pcm, t_ada,
                   *, stop_at_eos: bool = False, collect_topk: int = 0, tp=None):
    """End-to-end step from raw audio: pcm [B, T*160] f32 (T % 8 == 0 mel
    frames worth of samples). The host feeds left-pad zeros first and the
    right pad on finish, as for the JAX package."""
    mel, tail = _device_log_mel(cfg, state.pcm_tail, pcm)
    return _fleet_step_inner(params, cfg, state._replace(pcm_tail=tail), mel,
                             t_ada, stop_at_eos=stop_at_eos,
                             collect_topk=collect_topk, tp=tp)


@torch.no_grad()
def fleet_bootstrap_pcm(params, cfg: VoxtralConfig, state: FleetState, pcm,
                        t_ada, *, stop_at_eos: bool = False, tp=None):
    mel, tail = _device_log_mel(cfg, state.pcm_tail, pcm)
    return _fleet_bootstrap_inner(params, cfg, state._replace(pcm_tail=tail),
                                  mel, t_ada, stop_at_eos=stop_at_eos, tp=tp)


def pack_wire(pcm: np.ndarray, active: np.ndarray,
              forced: np.ndarray) -> np.ndarray:
    """Host-side single-upload wire row: [pcm | active | forced] per stream.
    f32 wire: active as 0/1, forced as exact float ints (|id| < 2^24).
    s16 wire: active as 0/1, forced split into lo/hi int16 halves."""
    if pcm.dtype == np.int16:
        lo = (forced & 0xffff).astype(np.int16)
        hi = (forced >> 16).astype(np.int16)
        return np.concatenate(
            [pcm, active[:, None].astype(np.int16), lo, hi], axis=1)
    return np.concatenate(
        [pcm, active[:, None].astype(np.float32), forced.astype(np.float32)],
        axis=1)


def _unpack_wire(cfg: VoxtralConfig, wire):
    """Inverse of pack_wire, on the device (exact)."""
    hop = cfg.audio.hop_length
    s16 = wire.dtype == torch.int16
    w = wire.shape[1]
    # w = n*8*hop + 1 + n (f32) or n*8*hop + 1 + 2n (s16)
    n = (w - 1) // (8 * hop + (2 if s16 else 1))
    n_samp = n * 8 * hop
    pcm = wire[:, :n_samp]
    active = wire[:, n_samp] != 0
    rest = wire[:, n_samp + 1:]
    if s16:
        lo = rest[:, :n].to(_I32)
        hi = rest[:, n:].to(_I32)
        forced = hi * 65536 | (lo & 0xffff)
    else:
        forced = rest.to(_I32)
    return pcm, active, forced


@torch.no_grad()
def fleet_step_masked(params, cfg: VoxtralConfig, state: FleetState, pcm,
                      active, forced_tokens, t_ada, *,
                      stop_at_eos: bool = False, collect_topk: int = 0,
                      wire_packed: bool = False, tp=None):
    """Serving step with per-stream participation.

    pcm: [B, T*hop] f32 or int16 (rows of inactive streams are ignored);
    active: [B] bool — an inactive stream's tails, cursors and positions
    are untouched this step (its ring slots may still recycle under the
    shared lockstep cursor); forced_tokens: [B, T//8] int32, >= 0 forces
    the emitted/fed-back token (prompt replay for per-stream starts and
    watchdog restarts).

    wire_packed: pcm is a pack_wire row block carrying active/forced too
    (one upload); the active/forced args are ignored placeholders."""
    if wire_packed:
        pcm, active, forced_tokens = _unpack_wire(cfg, pcm)
    b, n_samp = pcm.shape
    t = n_samp // cfg.audio.hop_length
    n = t // 8
    if pcm.dtype == torch.int16:
        # s16 wire: int16 -> f32 is exact, * 2^-15 scales the exponent only
        pcm = pcm.float() * (1.0 / 32768.0)
    mel, new_tail = _device_log_mel(cfg, state.pcm_tail, pcm)
    act = active[:, None]
    pcm_tail = torch.where(act, new_tail, state.pcm_tail)

    enc_p = params["encoder"]
    h, y = _conv_stem_with_tails(cfg, enc_p, state, mel)
    mel_tail = torch.where(act[:, :, None], mel[:, :, -2:], state.mel_tail)
    conv0_tail = torch.where(act[:, :, None], y[:, :, -2:], state.conv0_tail)

    zero = torch.zeros((), dtype=_I32, device=pcm.device)
    n_enc = torch.where(active, t // 2, zero)
    enc_state, enc_out = encoder_incremental(enc_p, cfg, state.encoder, h,
                                             n_valid=n_enc, tp=tp)
    frames = _adapter(params, cfg, enc_out, tp)
    n_dec = torch.where(active, n, zero)
    dec, tokens, aux = decode_scan(
        params["decoder"], cfg, state.decode, frames, n_dec, t_ada,
        collect_topk=collect_topk, stop_at_eos=stop_at_eos,
        forced_tokens=forced_tokens, tp=tp)
    new_state = FleetState(pcm_tail=pcm_tail, mel_tail=mel_tail,
                           conv0_tail=conv0_tail, encoder=enc_state,
                           decode=dec)
    return new_state, tokens, aux


def age_fleet_state(cfg: VoxtralConfig, state: FleetState,
                    decoder_positions: int) -> FleetState:
    """Fleet state as if every stream had already processed
    `decoder_positions` decode positions (4x that many encoder positions),
    far enough that both rings have wrapped: every slot holds a valid
    logical position, so the attention reads the whole ring. Ring contents
    stay as they are (attention cost depends on validity, not values).
    Benchmarking and profiling helper; it copies tables from the host."""

    def age(s, pos0, next_field, extra):
        phys = s.slot_pos.shape[1]
        ring = phys - s.pending_sp.shape[1]
        if pos0 < phys:
            raise ValueError(f"{pos0} positions do not wrap a ring of {phys}")
        b = s.slot_pos.shape[0]
        dev = s.slot_pos.device
        j = np.arange(phys)
        # slot j holds position p = j (mod ring), p in [pos0 - ring, pos0);
        # overflow slots keep their pre-wrap (older, out-of-window) entries
        p = pos0 - ring + (j - pos0 % ring) % ring
        p[ring:] -= ring
        return s._replace(
            slot_pos=torch.from_numpy(np.tile(p, (b, 1)).astype(np.int32)).to(dev),
            write_ctr=torch.full((), pos0, dtype=_I32, device=dev),
            pending_sp=torch.full_like(s.pending_sp, SLOT_INVALID),
            pending_adv=torch.zeros((), dtype=_I32, device=dev),
            **{next_field: torch.full((b,), pos0, dtype=_I32, device=dev)},
            **extra(b, dev))

    enc = age(state.encoder, decoder_positions * 4, "next_pos",
              lambda b, dev: {})
    dec = age(state.decode, decoder_positions, "pos",
              lambda b, dev: dict(prev_token=torch.full((b,), 1000, dtype=_I32,
                                                        device=dev)))
    return state._replace(encoder=enc, decode=dec)


def fleet_reset_slots(cfg: VoxtralConfig, state: FleetState, mask, *,
                      full: bool) -> FleetState:
    """Per-slot reset inside a live fleet (attach / watchdog restart).
    Decoder-only unless `full`, which also clears the audio-side state.
    mask: [B] bool on the state's device."""
    dec = reset_streams(state.decode, mask, cfg.streaming.bos)
    if not full:
        return state._replace(decode=dec)
    m3 = mask[:, None, None]
    return state._replace(
        decode=dec,
        encoder=reset_encoder_streams(state.encoder, mask),
        pcm_tail=torch.where(mask[:, None], 0.0, state.pcm_tail),
        mel_tail=torch.where(m3, 0.0, state.mel_tail),
        conv0_tail=torch.where(m3, 0.0, state.conv0_tail))


def fleet_reset_slots_(cfg: VoxtralConfig, state: FleetState, mask, *,
                       full: bool) -> FleetState:
    """fleet_reset_slots written into `state`'s own tensors (every tensor
    keeps its storage). Returns `state`."""
    copy_state(state, fleet_reset_slots(cfg, state, mask, full=full))
    return state


def state_leaves(state) -> list:
    """The tensors of a FleetState (or of its encoder or decode part) in
    field order, None where a field is None (the scale tables of float
    rings)."""
    out = []
    for x in state:
        if x is None or isinstance(x, torch.Tensor):
            out.append(x)
        else:                           # a nested state or a tuple of layers
            out.extend(state_leaves(x))
    return out


def copy_state(dst, src) -> None:
    """Copy every tensor of state `src` into the same field of `dst`, in
    place: the same shapes and dtypes, fields `src` shares with `dst`
    skipped. A `src` tensor that shares storage with another tensor of
    `dst` is cloned first, so no copy reads a tensor an earlier copy
    wrote."""
    dl, sl = state_leaves(dst), state_leaves(src)
    if len(dl) != len(sl):
        raise ValueError(f"states of {len(dl)} and {len(sl)} tensors")
    storages = {d.untyped_storage().data_ptr() for d in dl if d is not None}
    pairs = []
    for d, s in zip(dl, sl):
        if (d is None) != (s is None):
            raise ValueError("states differ in which fields are None")
        if d is None or s is d:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"state field {tuple(s.shape)} {s.dtype} does not fit "
                             f"{tuple(d.shape)} {d.dtype}")
        if s.untyped_storage().data_ptr() in storages:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)
