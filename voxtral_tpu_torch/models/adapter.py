"""Audio-language adapter: 4x downsample reshape + 2-layer MLP (counterpart
of `voxtral_tpu/models/adapter.py`). No biases, exact GELU between the two
projections, no output normalization."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.ops.linear import linear


def adapter_forward(ada_params: dict, cfg: VoxtralConfig,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """enc_out: [S, enc_dim] with S % downsample == 0 -> [S/ds, dec_dim]."""
    s, d = enc_out.shape
    ds = cfg.downsample
    x = enc_out.reshape(s // ds, d * ds)
    x = F.gelu(linear(x, ada_params["w0"]))
    return linear(x, ada_params["w1"])
