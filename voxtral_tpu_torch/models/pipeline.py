"""Offline (batch) transcription pipeline: audio -> greedy token ids
(counterpart of `voxtral_tpu/models/pipeline.py`).

The ground-truth schedule (python_simple_implementation.py:725-861):
streaming-format padding, host log-mel (drop-odd-frame), batch encoder,
adapter, 39-token prompt (BOS + STREAMING_PAD*38), prefill of 38 positions,
then greedy decode within the audio span with EOS stop. Everything after the
host mel runs on `device`; the tokens come back to the host once. Profiler
ranges "encoder" (stem, encoder, adapter), "prefill" and "decode_scan" mark
the stages for torch.profiler.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from voxtral_tpu_torch.audio.mel import batch_log_mel, pad_audio_offline
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    ada_scales, decode_scan, decoder_prefill, init_decode_state,
    time_conditioning,
)
from voxtral_tpu_torch.models.encoder import conv_stem, encoder_forward
from voxtral_tpu_torch.ops.linear import embed_lookup
from voxtral_tpu_torch.utils import resolve_device


def prompt_token_ids(cfg: VoxtralConfig, delay_tokens: int) -> np.ndarray:
    st = cfg.streaming
    ids = [st.bos] + [st.streaming_pad] * (st.n_left_pad_tokens + delay_tokens)
    return np.asarray(ids, dtype=np.int32)


def _pipeline(params, cfg: VoxtralConfig, mel: torch.Tensor, delay_tokens: int,
              collect_topk: int = 0):
    """mel: [mel_bins, F] (F even) on the device. Returns (tokens [N], aux)."""
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
    t_ada = ada_scales(params["decoder"], t_cond)

    embed = params["decoder"]["embed"]
    with record_function("prefill"):
        prefix = (adapter[:lp - 1].float()
                  + embed_lookup(embed, prompt[:lp - 1]))
        state = init_decode_state(cfg, batch=1, device=dev)
        state = decoder_prefill(params["decoder"], cfg, state, prefix[None],
                                t_ada)
    state = state._replace(prev_token=prompt[lp - 1:lp].to(torch.int32))

    frames = adapter[lp - 1:]
    n = frames.shape[0]
    with record_function("decode_scan"):
        state, tokens, aux = decode_scan(
            params["decoder"], cfg, state, frames[None],
            torch.full((1,), n, dtype=torch.int32, device=dev), t_ada,
            collect_topk=collect_topk)
    return tokens[0], aux


@torch.inference_mode()
def transcribe_tokens_batch(params, cfg: VoxtralConfig, audio: np.ndarray,
                            delay_tokens: int | None = None,
                            collect_topk: int = 0, device="cuda"):
    """audio: [N] float32 @16 kHz. Returns (token_ids list[int] (EOS removed),
    aux dict of device tensors). Token ids include control tokens, as in the
    reference's raw `generated` list. `params` must already be on `device`."""
    dev = resolve_device(device)
    embed = params["decoder"]["embed"]
    if embed.device.type != dev.type:
        raise ValueError(f"params are on {embed.device}, device is {dev}")
    if delay_tokens is None:
        delay_tokens = cfg.streaming.delay_tokens
    padded = pad_audio_offline(audio, cfg.audio, cfg.streaming,
                               delay_tokens=delay_tokens)
    mel = batch_log_mel(padded, cfg.audio)
    if mel.shape[1] % 2:
        mel = mel[:, 1:]
    tokens, aux = _pipeline(params, cfg, torch.from_numpy(mel).to(embed.device),
                            delay_tokens, collect_topk)
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
