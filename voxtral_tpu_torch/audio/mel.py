"""Log-mel spectrogram frontend (Slaney filters, Whisper-style framing), host
numpy version.

A copy of the batch part of `voxtral_tpu/audio/mel.py` (the port keeps its
own: the JAX module imports the JAX package's config). Semantics match the
ground-truth pipeline (python_simple_implementation.py:102-157):

- STFT: periodic Hann window 400, hop 160, center=True with reflect padding,
  onesided 201 bins, power spectrum, LAST FRAME DROPPED.
- mel = SlaneyFilters.T @ power; log10 clamped to >= 1e-10; floored at
  (global_log_mel_max - 8); then (x + 4) / 4.
"""

from __future__ import annotations

import functools

import numpy as np

from voxtral_tpu_torch.config import AudioConfig, StreamingConfig


# ---------------------------------------------------------------------------
# Slaney mel filter bank (python_simple_implementation.py:105-140)
# ---------------------------------------------------------------------------

def _hertz_to_mel(freq):
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hertz) * logstep,
                    mels)
    return mels


def _mel_to_hertz(mels):
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(log_region,
                    min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
                    freq)
    return freq


@functools.lru_cache(maxsize=8)
def mel_filters(cfg: AudioConfig = AudioConfig()) -> np.ndarray:
    """Returns [freq_bins, mel_bins] float32 Slaney filter bank."""
    n_freq = cfg.freq_bins
    fft_freqs = np.linspace(0, cfg.sample_rate // 2, n_freq)
    mel_min = _hertz_to_mel(0.0)
    mel_max = _hertz_to_mel(8000.0)
    mel_freqs = np.linspace(mel_min, mel_max, cfg.mel_bins + 2)
    filter_freqs = _mel_to_hertz(mel_freqs)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (filter_freqs[2:cfg.mel_bins + 2] - filter_freqs[:cfg.mel_bins])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrices(cfg: AudioConfig = AudioConfig()):
    """Real/imag DFT matrices [window, freq_bins] (f32), windowed framing ready."""
    n = cfg.window_size
    k = np.arange(cfg.freq_bins, dtype=np.float64)
    t = np.arange(n, dtype=np.float64)
    angles = 2.0 * np.pi * np.outer(t, k) / n       # [n, freq]
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


# ---------------------------------------------------------------------------
# Offline padding schedule (python_simple_implementation.py:163-179)
# ---------------------------------------------------------------------------

def pad_audio_offline(audio: np.ndarray, audio_cfg: AudioConfig = AudioConfig(),
                      stream_cfg: StreamingConfig = StreamingConfig(),
                      delay_tokens: int | None = None) -> np.ndarray:
    """Left pad 32 tokens of silence; right pad to 1280-alignment +
    (delay + 1 + 10) tokens. The right pad follows the ACTIVE transcription
    delay (voxtral.c:1645-1648); defaults to the config's delay."""
    mult = audio_cfg.raw_audio_per_token
    n = len(audio)
    align = (mult - (n % mult)) % mult
    if delay_tokens is None:
        delay_tokens = stream_cfg.delay_tokens
    n_right = delay_tokens + 1 + stream_cfg.extra_right_pad_tokens
    right = align + n_right * mult
    left = stream_cfg.n_left_pad_tokens * mult
    return np.pad(np.asarray(audio, dtype=np.float32), (left, right))


# ---------------------------------------------------------------------------
# Batch log-mel
# ---------------------------------------------------------------------------

def _frame_count(n_samples: int, cfg: AudioConfig) -> int:
    # center=True adds window//2 on both sides; torch emits 1 + n//hop frames,
    # and the pipeline drops the last one.
    return n_samples // cfg.hop_length


def batch_log_mel(audio: np.ndarray, cfg: AudioConfig = AudioConfig()) -> np.ndarray:
    """audio: [N] float32 (already padded). Returns [mel_bins, frames] f32."""
    audio = np.asarray(audio, dtype=np.float32)
    half = cfg.window_size // 2
    padded = np.concatenate([audio[1:half + 1][::-1], audio, audio[-half - 1:-1][::-1]])
    n_frames = _frame_count(len(audio), cfg)
    idx = np.arange(cfg.window_size)[None, :] + cfg.hop_length * np.arange(n_frames)[:, None]
    frames = padded[idx] * hann_window(cfg.window_size)[None, :]   # [F, 400]
    cosm, sinm = dft_matrices(cfg)
    re = frames @ cosm
    im = frames @ sinm
    power = re * re + im * im                                       # [F, 201]
    mel = power @ mel_filters(cfg)                                  # [F, 128]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, cfg.log_mel_max - 8.0)
    return (((log_spec + 4.0) / 4.0).T).astype(np.float32)          # [128, F]
