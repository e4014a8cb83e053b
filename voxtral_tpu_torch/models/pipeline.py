"""Offline (batch) transcription pipeline: audio -> greedy token ids
(counterpart of `voxtral_tpu/models/pipeline.py`).

The ground-truth schedule (python_simple_implementation.py:725-861):
streaming-format padding, host log-mel (drop-odd-frame), batch encoder,
adapter, 39-token prompt (BOS + STREAMING_PAD*38), prefill of 38 positions,
then greedy decode within the audio span with EOS stop. Everything after the
host mel runs on `device`; the tokens come back to the host once. Profiler
ranges "encoder" (stem, encoder, adapter), "prefill" and "decode_scan" mark
the stages for torch.profiler.

The JAX package compiles the request as one program per audio length, the
decode a `lax.scan`. Here the request runs as programs of a
`runtime.step_graph.DecodeGraphs` over one B = 1 DecodeState: the encoder
half (conv stem, encoder, adapter) on the mel padded at the end to a rung
of the `encoder_rows` ladder, the prefill, and the decode in calls of the
pending block's 64 steps, the ragged last call padded to the smallest
`DECODE_BUCKETS` width that holds it (the bucketed stream's rule). So a
length costs at most one new encoder program and four decode programs.
On CUDA they are captured as CUDA graphs and replayed (`step_graphs=False`:
the same programs eagerly). Each request leases an owner from the
process's program cache (`runtime.step_graph.lease`, the counterpart of
jit's), keyed by every tensor of the weights: its resident state is reset
in place, and it goes back to the cache when the request ends.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from voxtral_tpu_torch.audio.mel import batch_log_mel, pad_audio_offline
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    ada_scales, decoder_prefill, init_decode_state, init_decode_state_, time_conditioning,
)
from voxtral_tpu_torch.models.encoder import conv_stem, encoder_forward
from voxtral_tpu_torch.ops.linear import embed_lookup
from voxtral_tpu_torch.utils import resolve_device

# Decode steps a decode_scan call runs: at most the pending block's 64, a
# shorter call padded up to the next width (the bucketed stream's buckets).
DECODE_BUCKETS = (8, 16, 32, 64)
# The encoder rows of an offline request's encoder program: the real rows
# rounded up to a ladder of ENCODER_RUNGS rungs an octave, ENCODER_MIN_ROWS
# at least. Above that the padding stays under 1/ENCODER_RUNGS of the real
# rows, and every length has a rung.
ENCODER_RUNGS = 8
ENCODER_MIN_ROWS = 64


def bucket(n: int, buckets) -> int:
    """The smallest of `buckets` that holds n (the largest if none does)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def encoder_rows(n: int) -> int:
    """The ladder's rung for n encoder rows: n rounded up to a multiple of
    2**floor(log2 n) / ENCODER_RUNGS, and at least ENCODER_MIN_ROWS."""
    if n <= ENCODER_MIN_ROWS:
        return ENCODER_MIN_ROWS
    step = (1 << (n.bit_length() - 1)) // ENCODER_RUNGS
    return -(-n // step) * step


def encoder_mel(mel: torch.Tensor, downsample: int):
    """mel [mel_bins, F] (F even) with zero frames added at the end, so that
    the encoder half runs a rung of rows. The conv stem gives F/2 rows,
    and the program drops the front F/2 % downsample of them: the padded
    length leaves the same remainder, and the rows after it are the rung.
    The stem, the encoder's attention and RoPE are causal, so the padding
    reaches no real row. Returns (padded mel, the real adapter rows)."""
    rows = mel.shape[1] // 2
    trunc = rows % downsample
    frames = 2 * (trunc + encoder_rows(rows - trunc))
    return F.pad(mel, (0, frames - mel.shape[1])), (rows - trunc) // downsample


def encode(params, cfg: VoxtralConfig, mel: torch.Tensor) -> torch.Tensor:
    """The request's encoder half (the JAX request program's): conv stem,
    the front rows past a multiple of the downsample dropped, encoder,
    adapter. mel [mel_bins, F] -> adapter rows [F/2 // downsample, D]."""
    h = conv_stem(params["encoder"], mel)
    trunc = h.shape[0] % cfg.downsample
    if trunc:
        h = h[trunc:]
    enc = encoder_forward(params["encoder"], cfg, h.to(cfg.compute_dtype))
    return adapter_forward(params["adapter"], cfg, enc)


def decode_calls(n: int) -> list:
    """The decode_scan calls of an n-step decode, as (real steps, padded
    steps): full calls of DECODE_BUCKETS[-1] steps, then the rest padded to
    its bucket."""
    top = DECODE_BUCKETS[-1]
    return [(min(top, n - s0), bucket(min(top, n - s0), DECODE_BUCKETS))
            for s0 in range(0, n, top)]


def prefill_prompt(dec_params, cfg: VoxtralConfig, state, frames, prompt_ids, prev_token,
                   t_ada):
    """The prompt's prefill (the JAX stream's `_prefill`): adapter rows
    `frames` [lp-1, D] plus the embeddings of `prompt_ids` [lp-1] prefilled
    on a fresh or reset B = 1 state; `prev_token` [1] int32 is fed back
    first, `done` is cleared. Returns the new state."""
    prefix = frames.float() + embed_lookup(dec_params["embed"], prompt_ids)
    state = decoder_prefill(dec_params, cfg, state, prefix[None], t_ada)
    return state._replace(prev_token=prev_token.to(torch.int32),
                          done=torch.zeros_like(state.done))


def prompt_token_ids(cfg: VoxtralConfig, delay_tokens: int) -> np.ndarray:
    st = cfg.streaming
    ids = [st.bos] + [st.streaming_pad] * (st.n_left_pad_tokens + delay_tokens)
    return np.asarray(ids, dtype=np.int32)


def _pipeline(params, cfg: VoxtralConfig, mel: torch.Tensor, delay_tokens: int,
              collect_topk: int, graphs):
    """mel: [mel_bins, F] (F even) on the device; graphs: a DecodeGraphs
    over a fresh B = 1 state. Returns (tokens [N], aux)."""
    from voxtral_tpu_torch.runtime.step_graph import program_key
    dev = mel.device
    dec = params["decoder"]
    with record_function("encoder"):
        mel, n_audio = encoder_mel(mel, cfg.downsample)
        (adapter,) = graphs.call(program_key("encoder", dec, (mel,)),
                                 lambda m: (graphs.state, encode(params, cfg, m)), (mel,))
        # the real rows, copied out of the graphs' pool before the prefill
        adapter = adapter[:n_audio].clone()                     # [n_audio, D]

    prompt = torch.from_numpy(prompt_token_ids(cfg, delay_tokens)).to(dev)
    lp = prompt.shape[0]
    t_cond = time_conditioning(delay_tokens, cfg.decoder.dim, device=dev)
    t_ada = ada_scales(dec, t_cond)

    with record_function("prefill"):
        graphs.prefill(dec, cfg, adapter[:lp - 1], prompt[:lp - 1], prompt[lp - 1:lp], t_ada)

    frames = adapter[lp - 1:]
    toks, auxes, s0 = [], [], 0
    with record_function("decode_scan"):
        for m, nb in decode_calls(frames.shape[0]):
            fpad = torch.zeros((1, nb, frames.shape[1]), dtype=frames.dtype, device=dev)
            fpad[0, :m] = frames[s0:s0 + m]
            tokens, aux = graphs.scan(
                dec, cfg, fpad, torch.full((1,), m, dtype=torch.int32, device=dev), t_ada,
                collect_topk=collect_topk)
            # the real steps, copied out of the graphs' pool before the next call
            toks.append(tokens[:, :m].clone())
            auxes.append({k: v[:, :m].clone() for k, v in aux.items()})
            s0 += m
    aux = {k: torch.cat([a[k] for a in auxes], dim=1) for k in auxes[0]}
    return torch.cat(toks, dim=1)[0], aux


def _request_state(cfg: VoxtralConfig):
    return lambda device: init_decode_state(cfg, batch=1, device=device)


def request_graphs(params, cfg: VoxtralConfig):
    """A cached DecodeGraphs that replays `params`' offline requests on the
    card, with its resident B = 1 DecodeState (None before the first
    request). Bucketed streams of the same weights lease from the same
    owners."""
    # runtime imports this module, so it is imported here
    from voxtral_tpu_torch.runtime.step_graph import DecodeGraphs, cached
    owners = cached(DecodeGraphs, params, cfg, _request_state(cfg))
    return owners[0] if owners else None


def _request_graphs(params, cfg: VoxtralConfig, device, capture: bool):
    """A DecodeGraphs over a fresh B = 1 state: eager over a new state, or
    an owner leased from the program cache, its state reset in place."""
    from voxtral_tpu_torch.runtime.step_graph import DecodeGraphs, lease
    if not capture:
        return DecodeGraphs(init_decode_state(cfg, batch=1, device=device), capture=False)
    return lease(DecodeGraphs, params, cfg, _request_state(cfg), init_decode_state_)


@torch.inference_mode()
def transcribe_tokens_batch(params, cfg: VoxtralConfig, audio: np.ndarray,
                            delay_tokens: int | None = None,
                            collect_topk: int = 0, device="cuda",
                            step_graphs: bool | None = None):
    """audio: [N] float32 @16 kHz. Returns (token_ids list[int] (EOS removed),
    aux dict of device tensors). Token ids include control tokens, as in the
    reference's raw `generated` list. `params` must already be on `device`.
    step_graphs: replay the request's programs as CUDA graphs (None: on
    CUDA; False: the same programs eagerly; True: raises off CUDA). The
    graphs are cached by the tensors of `params` they read: a tree with any
    other tensor gets graphs of its own, and values written into the same
    tensors between requests are read."""
    # runtime imports this module, so it is imported here
    from voxtral_tpu_torch.runtime.step_graph import release, wants_capture
    dev = resolve_device(device)
    embed = params["decoder"]["embed"]
    if embed.device.type != dev.type:
        raise ValueError(f"params are on {embed.device}, device is {dev}")
    capture = wants_capture(step_graphs, dev)
    if delay_tokens is None:
        delay_tokens = cfg.streaming.delay_tokens
    padded = pad_audio_offline(audio, cfg.audio, cfg.streaming,
                               delay_tokens=delay_tokens)
    mel = batch_log_mel(padded, cfg.audio)
    if mel.shape[1] % 2:
        mel = mel[:, 1:]
    graphs = _request_graphs(params, cfg, embed.device, capture)
    try:
        tokens, aux = _pipeline(params, cfg, torch.from_numpy(mel).to(embed.device),
                                delay_tokens, collect_topk, graphs)
    finally:
        if graphs.capture:
            release(graphs)
    out = []
    for t in tokens.cpu().tolist():
        if t < 0:
            break
        out.append(int(t))
        if t == cfg.streaming.eos:
            break
    if out and out[-1] == cfg.streaming.eos:
        out = out[:-1]
    return out, aux
