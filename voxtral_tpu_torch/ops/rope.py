"""Interleaved (GPT-J style) rotary position embeddings (counterpart of
`voxtral_tpu/ops/rope.py`).

Consecutive element pairs (2j, 2j+1) of each head form a rotation pair. The
angle math follows the JAX order in float32 (`1 / theta**(arange/hd)`, then
position * inv_freq): float64 here would move the phase at large positions
away from the reference.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: [...] int tensor. Returns (cos, sin) each [..., head_dim//2] f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(theta, exponents)              # [hd/2] f32
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, hd]; cos/sin: [..., S, hd//2] (broadcast over heads).

    Rotation is computed in f32 and cast back to x.dtype.
    """
    xf = x.float()
    xp = xf.unflatten(-1, (-1, 2))
    x_even = xp[..., 0]
    x_odd = xp[..., 1]
    c = cos[..., :, None, :]   # [..., S, 1, hd/2]
    si = sin[..., :, None, :]
    o_even = x_even * c - x_odd * si
    o_odd = x_odd * c + x_even * si
    out = torch.stack([o_even, o_odd], dim=-1).flatten(-2)
    return out.to(x.dtype)
