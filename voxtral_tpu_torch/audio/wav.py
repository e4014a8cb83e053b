"""WAV parsing and resampling (host-side, zero external deps): a copy of
`voxtral_tpu/audio/wav.py`.

Mirrors the reference audio loader's behavior (voxtral_audio.c:49-141):
16-bit PCM (and additionally IEEE float) RIFF parsing, chunk walking that
tolerates ffmpeg's 0xFFFFFFFF streaming data size, mono mixdown, and linear
resampling to 16 kHz.
"""

from __future__ import annotations

import shutil
import struct
import subprocess

import numpy as np


def parse_wav_bytes(data: bytes):
    """Returns (samples_f32_mono, sample_rate). Raises ValueError on bad input."""
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if size == 0xFFFFFFFF or body + size > len(data):
            size = len(data) - body           # streaming writers lie about size
        if cid == b"fmt ":
            if body + 16 > len(data):
                raise ValueError("truncated fmt chunk")
            audio_fmt, channels, rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", data, body)
            fmt = (audio_fmt, channels, rate, bits)
        elif cid == b"data":
            pcm = data[body:body + size]
            if fmt is not None:
                break
        pos = body + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, bits = fmt
    if audio_fmt == 1 and bits == 16:
        samples = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 3 and bits == 32:
        samples = np.frombuffer(pcm, dtype="<f4").astype(np.float32)
    elif audio_fmt == 1 and bits == 32:
        samples = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}bit")
    if channels > 1:
        n = (samples.size // channels) * channels
        samples = samples[:n].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(samples, dtype=np.float32), rate


def resample_linear(samples: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Linear-interpolation resampler (matches voxtral_audio.c:110-137)."""
    if rate_in == rate_out:
        return np.asarray(samples, dtype=np.float32)
    n_out = int(round(len(samples) * rate_out / rate_in))
    pos = np.arange(n_out, dtype=np.float64) * rate_in / rate_out
    i0 = np.minimum(pos.astype(np.int64), len(samples) - 1)
    i1 = np.minimum(i0 + 1, len(samples) - 1)
    frac = (pos - i0).astype(np.float32)
    s = np.asarray(samples, dtype=np.float32)
    return (s[i0] * (1.0 - frac) + s[i1] * frac).astype(np.float32)


def load_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    with open(path, "rb") as f:
        samples, rate = parse_wav_bytes(f.read())
    return resample_linear(samples, rate, target_rate)


def load_audio(path: str, target_rate: int = 16000) -> np.ndarray:
    """load_wav, with an ffmpeg-subprocess fallback for non-WAV containers
    (OGG etc.), the same dependency the reference needs for its OGG samples.
    Raises ValueError if the file is not WAV and ffmpeg is unavailable."""
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return load_wav(path, target_rate)
    if shutil.which("ffmpeg") is None:
        raise ValueError(f"{path}: not a WAV file and ffmpeg is not installed")
    out = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le", "-ac", "1",
         "-ar", str(target_rate), "-"],
        check=True, stdout=subprocess.PIPE).stdout
    return np.frombuffer(out, dtype="<f4").astype(np.float32)
