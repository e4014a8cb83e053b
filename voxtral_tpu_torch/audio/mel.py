"""Log-mel spectrogram frontend (Slaney filters, Whisper-style framing).

A copy of `voxtral_tpu/audio/mel.py`: the host batch log-mel, its device
form `batch_log_mel_device` (the counterpart of `batch_log_mel_jax`, f32
torch products) and the incremental `MelStream` (the port keeps its own:
the JAX module imports the JAX package's config). Semantics match the
ground-truth pipeline (python_simple_implementation.py:102-157) and the C incremental
context (voxtral_audio.c:400-662):

- STFT: periodic Hann window 400, hop 160, center=True with reflect padding,
  onesided 201 bins, power spectrum, LAST FRAME DROPPED.
- mel = SlaneyFilters.T @ power; log10 clamped to >= 1e-10; floored at
  (global_log_mel_max - 8); then (x + 4) / 4.
- Streaming: the sample buffer starts with 200 + left_pad zeros (reflect of
  silence is silence); frames are emitted as soon as their 400-sample window
  fits; finish() appends a 200-sample right reflection and drops the final
  frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from voxtral_tpu_torch.config import AudioConfig, StreamingConfig
from voxtral_tpu_torch.utils import resolve_device


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


@functools.lru_cache(maxsize=8)
def _mel_tables(a: AudioConfig, device: str):
    """Hann window, DFT and Slaney filter tables on `device`, built once."""
    cosm, sinm = dft_matrices(a)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (hann_window(a.window_size), cosm, sinm,
                           mel_filters(a)))


@functools.lru_cache(maxsize=8)
def _frame_index(a: AudioConfig, t: int, device: str):
    idx = (a.hop_length * np.arange(t)[:, None]
           + np.arange(a.window_size)[None, :])                 # [T, window]
    return torch.from_numpy(idx).to(device)


def _power_mel(frames, cosm, sinm, filt):
    """One stream's windowed frames [T, window] -> mel power [T, mel]."""
    re = frames @ cosm                                          # [T, freq]
    im = frames @ sinm
    return (re * re + im * im) @ filt


def batch_log_mel_device(audio, cfg: AudioConfig = AudioConfig(), *,
                         device="cuda") -> torch.Tensor:
    """batch_log_mel on `device`: audio [N] (numpy or a tensor, already
    padded) -> f32 [mel_bins, frames] there. The reflect pad, Hann-windowed
    framing, then the DFT and filter products as f32 matmuls of the one
    clip (its rows do not follow a batch), log10, clamp and scale.
    `device` defaults to "cuda" and raises without CUDA."""
    dev = resolve_device(device)
    x = torch.as_tensor(audio).to(dev, torch.float32)
    half = cfg.window_size // 2
    padded = torch.cat([x[1:half + 1].flip(0), x, x[-half - 1:-1].flip(0)])
    hann, cosm, sinm, filt = _mel_tables(cfg, str(dev))
    frames = padded[_frame_index(cfg, _frame_count(x.shape[0], cfg), str(dev))] * hann
    log_spec = torch.log10(torch.clamp(_power_mel(frames, cosm, sinm, filt), min=1e-10))
    log_spec = torch.clamp(log_spec, min=cfg.log_mel_max - 8.0)
    return ((log_spec + 4.0) / 4.0).T.contiguous()              # [128, F]


# ---------------------------------------------------------------------------
# Incremental mel stream (voxtral_audio.c:400-662 semantics, vectorized)
# ---------------------------------------------------------------------------

class MelStream:
    """Incremental log-mel over a growing (compacted) sample buffer.

    Frames are identical to `batch_log_mel` of the eventual full signal:
    frame t covers padded samples [t*hop, t*hop + window). The buffer starts
    with 200 + `left_pad_samples` zeros; `finish()` appends the 200-sample
    right reflection and drops the final frame.
    """

    def __init__(self, left_pad_samples: int, cfg: AudioConfig = AudioConfig()):
        self.cfg = cfg
        self._window = hann_window(cfg.window_size)
        self._cos, self._sin = dft_matrices(cfg)
        self._filters = mel_filters(cfg)
        self.left_pad = cfg.window_size // 2 + left_pad_samples
        self._samples = np.zeros(self.left_pad, dtype=np.float32)
        self.sample_offset = 0          # global index of _samples[0]
        self.n_total_samples = self.left_pad
        self._mel = np.zeros((0, cfg.mel_bins), dtype=np.float32)
        self.frame_offset = 0           # global frame index of _mel[0]
        self.finished = False

    @property
    def n_frames(self) -> int:
        return self._mel.shape[0]

    def frames(self) -> np.ndarray:
        """Currently buffered frames, [n, mel_bins]; global index of row 0 is
        frame_offset."""
        return self._mel

    def feed(self, samples: np.ndarray) -> int:
        """Append samples; returns the number of new frames."""
        if self.finished:
            raise RuntimeError("MelStream already finished")
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        if samples.size:
            self._samples = np.concatenate([self._samples, samples])
            self.n_total_samples += samples.size
        return self._compute_available()

    def finish(self) -> int:
        if self.finished:
            return self.n_frames
        # Right reflect: 200 samples mirrored around the last sample
        # (src = end - 2 - i, voxtral_audio.c:615-623).
        half = self.cfg.window_size // 2
        tail = self._samples[-half - 1:-1][::-1].copy()
        self._samples = np.concatenate([self._samples, tail])
        self.n_total_samples += half
        self._compute_available()
        if self.n_frames > 0:
            self._mel = self._mel[:-1]
        self.finished = True
        return self.n_frames

    def discard_before(self, global_frame: int) -> None:
        drop = min(max(global_frame - self.frame_offset, 0), self.n_frames)
        if drop > 0:
            self._mel = self._mel[drop:]
            self.frame_offset += drop

    def _compute_available(self) -> int:
        cfg = self.cfg
        next_frame = self.frame_offset + self.n_frames
        # frame t needs samples [t*hop, t*hop+window) (global indices)
        last_fit = (self.n_total_samples - cfg.window_size) // cfg.hop_length
        n_new = last_fit + 1 - next_frame
        if n_new <= 0:
            return 0
        starts = (np.arange(next_frame, next_frame + n_new) * cfg.hop_length
                  - self.sample_offset)
        idx = starts[:, None] + np.arange(cfg.window_size)[None, :]
        frames = self._samples[idx] * self._window[None, :]
        re = frames @ self._cos
        im = frames @ self._sin
        power = re * re + im * im
        mel = power @ self._filters
        log_spec = np.log10(np.maximum(mel, 1e-10))
        log_spec = np.maximum(log_spec, cfg.log_mel_max - 8.0)
        new = ((log_spec + 4.0) / 4.0).astype(np.float32)
        self._mel = np.concatenate([self._mel, new], axis=0)
        self._compact_samples()
        return n_new

    def _compact_samples(self) -> None:
        needed_from = (self.frame_offset + self.n_frames) * self.cfg.hop_length
        discard = needed_from - self.sample_offset
        if discard > 0:
            self._samples = self._samples[discard:]
            self.sample_offset += discard
