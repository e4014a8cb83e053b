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
decode a `lax.scan`. Here the encoder runs eagerly, and the prefill and the
decode run as programs of a `runtime.step_graph.DecodeGraphs` over one
B = 1 DecodeState: the decode in calls of the pending block's 64 steps, the
ragged last call padded to the smallest `DECODE_BUCKETS` width that holds
it (the bucketed stream's rule), so every audio length needs at most four
decode programs and one prefill program. On CUDA they are captured as CUDA
graphs and replayed (`step_graphs=False`: eager); the owner and its
resident state are kept per set of weights and freed with them (the
counterpart of jit's program cache), and each request resets the state in
place.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
from torch.profiler import record_function

from voxtral_tpu_torch.audio.mel import batch_log_mel, pad_audio_offline
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    ada_scales, decoder_prefill, init_decode_state, init_decode_state_, time_conditioning,
)
from voxtral_tpu_torch.models.encoder import conv_stem, encoder_forward
from voxtral_tpu_torch.ops.linear import embed_lookup
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.utils import resolve_device

# Decode steps a decode_scan call runs: at most the pending block's 64, a
# shorter call padded up to the next width (the bucketed stream's buckets).
DECODE_BUCKETS = (8, 16, 32, 64)


def bucket(n: int, buckets) -> int:
    """The smallest of `buckets` that holds n (the largest if none does)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


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
    dev = mel.device
    with record_function("encoder"):
        h = conv_stem(params["encoder"], mel)
        trunc = h.shape[0] % cfg.downsample
        if trunc:
            h = h[trunc:]
        h = h.to(cfg.compute_dtype)
        enc = encoder_forward(params["encoder"], cfg, h)
        adapter = adapter_forward(params["adapter"], cfg, enc)   # [n_audio, D]

    prompt = torch.from_numpy(prompt_token_ids(cfg, delay_tokens)).to(dev)
    lp = prompt.shape[0]
    t_cond = time_conditioning(delay_tokens, cfg.decoder.dim, device=dev)
    dec = params["decoder"]
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


# (id of the weights' embedding table, cfg, device) -> the DecodeGraphs that
# replays their requests; an entry goes when the table does
_GRAPHS: dict = {}


def _anchor(params) -> torch.Tensor:
    embed = params["decoder"]["embed"]
    return embed.q if isinstance(embed, Quantized) else embed


def request_graphs(params, cfg: VoxtralConfig):
    """The DecodeGraphs that replays `params`' offline requests on the card,
    with its resident B = 1 DecodeState (None before the first request)."""
    anchor = _anchor(params)
    return _GRAPHS.get((id(anchor), cfg, anchor.device))


def _request_graphs(params, cfg: VoxtralConfig, device, capture: bool):
    """A DecodeGraphs over a fresh B = 1 state: eager over a new state, or
    the weights' cached owner with its state reset in place."""
    # runtime imports this module, so it is imported here
    from voxtral_tpu_torch.runtime.step_graph import DecodeGraphs
    if not capture:
        return DecodeGraphs(init_decode_state(cfg, batch=1, device=device), capture=False)
    anchor = _anchor(params)
    key = (id(anchor), cfg, anchor.device)
    graphs = _GRAPHS.get(key)
    if graphs is None:
        graphs = _GRAPHS[key] = DecodeGraphs(init_decode_state(cfg, batch=1, device=device))
        weakref.finalize(anchor, _GRAPHS.pop, key, None)
    else:
        init_decode_state_(graphs.state)
    return graphs


@torch.inference_mode()
def transcribe_tokens_batch(params, cfg: VoxtralConfig, audio: np.ndarray,
                            delay_tokens: int | None = None,
                            collect_topk: int = 0, device="cuda",
                            step_graphs: bool | None = None):
    """audio: [N] float32 @16 kHz. Returns (token_ids list[int] (EOS removed),
    aux dict of device tensors). Token ids include control tokens, as in the
    reference's raw `generated` list. `params` must already be on `device`.
    step_graphs: replay the prefill and decode as CUDA graphs (None: on
    CUDA; False: eager; True: raises off CUDA). The graphs read `params`'
    tensors: replace a tensor of the tree, not its values, between
    requests."""
    dev = resolve_device(device)
    embed = params["decoder"]["embed"]
    if embed.device.type != dev.type:
        raise ValueError(f"params are on {embed.device}, device is {dev}")
    if step_graphs and dev.type != "cuda":
        raise ValueError(f"step_graphs=True needs CUDA (device {dev})")
    if delay_tokens is None:
        delay_tokens = cfg.streaming.delay_tokens
    padded = pad_audio_offline(audio, cfg.audio, cfg.streaming,
                               delay_tokens=delay_tokens)
    mel = batch_log_mel(padded, cfg.audio)
    if mel.shape[1] % 2:
        mel = mel[:, 1:]
    graphs = _request_graphs(params, cfg, embed.device,
                             step_graphs is not False and dev.type == "cuda")
    tokens, aux = _pipeline(params, cfg, torch.from_numpy(mel).to(embed.device),
                            delay_tokens, collect_topk, graphs)
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
