"""voxtral_tpu_torch: the PyTorch/CUDA port of voxtral_tpu (Voxtral Realtime
4B streaming ASR) for an NVIDIA H100.

    import voxtral_tpu_torch as vt
    params, cfg = vt.load("model_dir")                  # bf16, on cuda
    from voxtral_tpu_torch.models import transcribe_tokens_batch
    tokens, aux = transcribe_tokens_batch(params, cfg, samples_16khz_f32)

The JAX package `voxtral_tpu` is the reference each module is tested
against; module and function names follow it. Entry points take
`device=` (default "cuda") and raise when CUDA is missing unless the caller
asks for "cpu". The ring-attention kernels are hand-written CUDA
(`csrc/ring_attention.cu`: decode regime, float and int8 rings;
`csrc/ring_attention_enc.cu`: encoder regime, float, int8 and int4 rings),
built with nvcc at first use. The multi-stream serving step is
`voxtral_tpu_torch.runtime.fleet`.
"""

from __future__ import annotations

__version__ = "0.1.0"


def load(model_dir: str, *, dtype=None, device="cuda"):
    """Load the weights of `model_dir/consolidated.safetensors` onto
    `device`. Returns (params, cfg); dtype defaults to bfloat16."""
    import os

    import torch

    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.weights import load_params

    dt = dtype or torch.bfloat16
    cfg = voxtral_4b(param_dtype=dt, compute_dtype=dt)
    params = load_params(os.path.join(model_dir, "consolidated.safetensors"),
                         cfg, device=device)
    return params, cfg
