"""Causal Whisper-style audio encoder, batch forward (counterpart of
`voxtral_tpu/models/encoder.py::conv_stem` and `encoder_forward`).

MHA 32 heads x 64, biases on wq/wv/wo/w2 but NOT wk/w1/w3, interleaved RoPE
theta=1e6, sliding window 750, RMSNorm, SwiGLU, exact (erf) GELU in the
conv stem. The incremental (ring) encoder arrives with the fleet slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.ops import (
    apply_rope, causal_conv1d, rms_norm, rope_angles, windowed_attention,
)
from voxtral_tpu_torch.ops.linear import linear


def conv_stem(enc_params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel: [mel_bins, F] -> [F//2 (ceil), enc_dim] post-conv activations."""
    h = F.gelu(causal_conv1d(mel, enc_params["conv0_w"], enc_params["conv0_b"], stride=1))
    h = F.gelu(causal_conv1d(h, enc_params["conv1_w"], enc_params["conv1_b"], stride=2))
    return h.t()


def _attn_block(lp: dict, x_norm: torch.Tensor, cfg, cos, sin):
    """Shared QKV+RoPE computation. x_norm: [..., S, D] -> q [..., S, H, hd],
    k, v (leading batch dims preserved)."""
    e = cfg
    hs = (*x_norm.shape[:-1], e.heads, e.head_dim)
    q = linear(x_norm, lp["wq"], lp["wq_b"]).reshape(hs)
    k = linear(x_norm, lp["wk"]).reshape(hs)
    v = linear(x_norm, lp["wv"], lp["wv_b"]).reshape(hs)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def encoder_forward(enc_params: dict, cfg: VoxtralConfig, h: torch.Tensor,
                    pos_start: int = 0) -> torch.Tensor:
    """Batch transformer over post-conv activations h: [S, D] -> [S, D]."""
    e = cfg.encoder
    s = h.shape[0]
    positions = pos_start + torch.arange(s, device=h.device)
    cos, sin = rope_angles(positions, e.head_dim, e.rope_theta)

    for lp in enc_params["layers"]:
        x = rms_norm(h, lp["attn_norm"], e.norm_eps)
        q, k, v = _attn_block(lp, x, e, cos, sin)
        attn = windowed_attention(q, k, v, window=e.window)
        h = h + linear(attn.reshape(s, e.attn_dim), lp["wo"], lp["wo_b"])
        x = rms_norm(h, lp["ffn_norm"], e.norm_eps)
        h = h + linear(F.silu(linear(x, lp["w1"])) * linear(x, lp["w3"]),
                       lp["w2"], lp["w2_b"])
    return rms_norm(h, enc_params["norm"], e.norm_eps)
