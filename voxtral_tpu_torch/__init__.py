"""voxtral_tpu_torch: the PyTorch/CUDA port of the JAX package voxtral_tpu
(Voxtral Realtime 4B streaming ASR) for an NVIDIA H100.

Top-level API, mirroring the reference's vox_load / vox_transcribe /
vox_transcribe_audio (voxtral.h:249-337):

    import voxtral_tpu_torch as vt
    engine = vt.load("model_dir")               # (params, cfg, tokenizer)
    text = vt.transcribe(engine, "speech.wav")
    text = vt.transcribe_audio(engine, samples_16khz_f32)

and the command line `python -m voxtral_tpu_torch.cli -d MODEL_DIR -i
speech.wav`. Stream and fleet surfaces: `voxtral_tpu_torch.runtime.VoxStream`
(one stream; the bucketed path, or a B = 1 FleetManager, the default on
CUDA) and `voxtral_tpu_torch.runtime.FleetManager` (multi-stream serving
over the fleet step `voxtral_tpu_torch.runtime.fleet`, one process); the
offline pipeline is `voxtral_tpu_torch.models.transcribe_tokens_batch`.

The JAX package is the reference each module is tested against; module and
function names follow it. Entry points take `device=` (default "cuda") and
raise when CUDA is missing unless the caller asks for "cpu". The kernels
are hand-written CUDA, built with nvcc at first use: the ring attention
(`csrc/ring_attention.cu`: decode regime, float and int8 rings;
`csrc/ring_attention_enc.cu`: encoder regime, float, int8 and int4 rings),
the W8A16 GEMV for Q8 weights (`csrc/w8a16.cu`) and the fused tied logits +
greedy argmax (`csrc/logits_argmax.cu`). Weights are float or Q8
(`quant.Quantized`, from `quant.quantize_params` or a Q8 file). The host
audio surface (`audio/`: the incremental MelStream, its native C++ binding,
WAV loading, microphone capture) runs on the CPU.
"""

from __future__ import annotations

__version__ = "0.1.0"


def load(model_dir: str, *, dtype=None, quantize: bool = False, device="cuda"):
    """Load weights + tokenizer onto `device`. Returns (params, cfg,
    tokenizer); tokenizer is None when `model_dir` has no tekken.json.
    dtype (of the float leaves) defaults to bfloat16. A Q8 file
    (tools/quantize.py) loads its 2-D tensors as `quant.Quantized` leaves;
    quantize=True Q8-ifies float weights after loading (halves the
    weights' memory)."""
    import os

    import torch

    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.tokenizer import Tokenizer
    from voxtral_tpu_torch.weights import load_params

    dt = dtype or torch.bfloat16
    cfg = voxtral_4b(param_dtype=dt, compute_dtype=dt)
    params = load_params(os.path.join(model_dir, "consolidated.safetensors"),
                         cfg, device=device)
    if quantize:
        from voxtral_tpu_torch.quant import quantize_params
        params = quantize_params(params)
    tok_path = os.path.join(model_dir, "tekken.json")
    tokenizer = Tokenizer(tok_path) if os.path.exists(tok_path) else None
    return params, cfg, tokenizer


def transcribe_audio(engine, samples, *, interval: float = 2.0,
                     delay_ms: int = 480, device="cuda") -> str:
    """Transcribe 16 kHz mono f32 samples through the streaming engine on
    `device` (where the engine's params live)."""
    params, cfg, tokenizer = engine
    from voxtral_tpu_torch.runtime import StreamConfig, VoxStream
    s = VoxStream(params, cfg, tokenizer=tokenizer,
                  stream_cfg=StreamConfig(interval=interval,
                                          delay_tokens=delay_ms // 80),
                  device=device)
    sr = cfg.audio.sample_rate
    for i in range(0, len(samples), sr):
        s.feed(samples[i:i + sr])
    s.finish()
    return "".join(s.get()).strip()


def transcribe(engine, path: str, **kw) -> str:
    """Transcribe an audio file (WAV; other formats via ffmpeg if present);
    keywords go to transcribe_audio."""
    import shutil
    import subprocess

    import numpy as np

    from voxtral_tpu_torch.audio import load_wav
    _, cfg, _ = engine
    if path.lower().endswith(".wav"):
        audio = load_wav(path, cfg.audio.sample_rate)
    elif shutil.which("ffmpeg"):
        out = subprocess.run(
            ["ffmpeg", "-loglevel", "quiet", "-i", path, "-f", "s16le",
             "-ar", str(cfg.audio.sample_rate), "-ac", "1", "-"],
            capture_output=True, check=True).stdout
        audio = np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"cannot decode {path!r} (need WAV or ffmpeg)")
    return transcribe_audio(engine, audio, **kw)
