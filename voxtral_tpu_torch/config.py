"""Model/audio configuration for the PyTorch/CUDA port of Voxtral Realtime 4B.

A copy of `voxtral_tpu/config.py` with torch dtypes: the port imports
neither jax nor the JAX package. Field names, defaults and helpers are the
same, so a config built here describes the same model as its JAX twin.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 16000
    mel_bins: int = 128
    hop_length: int = 160
    window_size: int = 400          # STFT window (25 ms)
    frame_rate: float = 12.5        # decoder tokens per second of audio
    log_mel_max: float = 1.5        # global_log_mel_max from params.json

    @property
    def freq_bins(self) -> int:
        return self.window_size // 2 + 1  # 201

    @property
    def raw_audio_per_token(self) -> int:
        # 1280 samples of 16 kHz audio per decoder position (80 ms)
        return int(self.sample_rate // self.frame_rate)

    @property
    def mel_frames_per_token(self) -> int:
        return self.raw_audio_per_token // self.hop_length  # 8


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    dim: int = 1280
    layers: int = 32
    heads: int = 32
    head_dim: int = 64
    hidden: int = 5120
    window: int = 750               # sliding attention window
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    conv_kernel: int = 3

    @property
    def attn_dim(self) -> int:
        return self.heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    dim: int = 3072
    layers: int = 26
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    hidden: int = 9216
    window: int = 8192              # sliding attention window == KV ring size
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    vocab_size: int = 131072
    ada_dim: int = 32               # ada_rms_norm_t_cond bottleneck

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Streaming schedule constants (reference: python_simple_implementation.py:69-99)."""
    n_left_pad_tokens: int = 32
    delay_tokens: int = 6           # default 480 ms transcription delay
    extra_right_pad_tokens: int = 10
    # Special token ids (tekken.json; voxtral_tokenizer.c:4-14)
    bos: int = 1
    eos: int = 2
    streaming_pad: int = 32
    n_special: int = 1000

    @property
    def n_right_pad_tokens(self) -> int:
        return self.delay_tokens + 1 + self.extra_right_pad_tokens  # 17

    @property
    def prompt_len(self) -> int:
        # BOS + STREAMING_PAD * (left_pad + delay) == 39 by default
        return 1 + self.n_left_pad_tokens + self.delay_tokens


@dataclasses.dataclass(frozen=True)
class VoxtralConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    streaming: StreamingConfig = dataclasses.field(default_factory=StreamingConfig)
    downsample: int = 4             # encoder frames per decoder position
    adapter_hidden: int = 3072      # audio_language_projection.0 output dim
    # dtypes: "parity" mode is f32 everywhere; "fast" is bf16 params with
    # f32 accumulation at norms/rope/softmax/logits.
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def adapter_in(self) -> int:
        return self.encoder.dim * self.downsample

    def with_dtype(self, param_dtype, compute_dtype=None) -> "VoxtralConfig":
        return dataclasses.replace(
            self, param_dtype=param_dtype,
            compute_dtype=compute_dtype if compute_dtype is not None else param_dtype)

    def num_audio_tokens(self, audio_len: int) -> int:
        """Token count for a raw sample count (python_simple_implementation.py:91-96)."""
        hop = self.audio.hop_length
        if audio_len % hop != 0:
            frames = math.ceil(audio_len / hop - 1)
        else:
            frames = audio_len // hop
        return math.ceil(frames / self.audio.mel_frames_per_token)


def voxtral_4b(param_dtype=torch.float32, compute_dtype=None) -> VoxtralConfig:
    """The flagship Voxtral Realtime 4B (Ministral-3 decoder) config."""
    cfg = VoxtralConfig()
    return cfg.with_dtype(param_dtype, compute_dtype)


def tiny_config(vocab_size: int = 256, dec_window: int = 32,
                enc_window: int = 24) -> VoxtralConfig:
    """A structurally identical miniature config for fast parity tests.

    Every architectural wrinkle of the 4B model is preserved: MHA encoder with
    bias-on-q/v/o-but-not-k, GQA decoder, SwiGLU, interleaved RoPE, ada norm,
    4x downsample, tied embeddings, sliding windows small enough that tests
    exercise ring compaction.
    """
    return VoxtralConfig(
        encoder=EncoderConfig(dim=64, layers=2, heads=4, head_dim=16,
                              hidden=128, window=enc_window),
        decoder=DecoderConfig(dim=64, layers=2, heads=4, kv_heads=2,
                              head_dim=16, hidden=128, window=dec_window,
                              vocab_size=vocab_size, ada_dim=8),
        # n_special shrunk below the tiny vocab so text-token classification
        # paths are exercised (full model: 1000 specials of 131072)
        streaming=StreamingConfig(n_special=100),
        downsample=4,
        adapter_hidden=64,
    )
