"""KV-ring quantizers (counterpart of the KV part of `voxtral_tpu/quant.py`,
which imports jax; the port keeps its own copy).

Both quantizers are symmetric per (stream, slot, kv-head): scale = amax/127
(int8) or amax/7 (int4), computed in f32 as the jitted JAX functions do
(amax times the f32 reciprocal), codes rounded half to even, so their
outputs equal the JAX package's jitted quantizers bit for bit on the same
f32 input.
Scales come out in the [B, Hkv, S] layout the ring attention reads. The
attention never dequantizes a ring: K scales multiply score columns, V
scales fold into probability columns.

int4 packing ("halves", as the JAX package): for one head of hd lanes,
packed byte c (c < hd/2) holds lane c in its low nibble and lane c + hd/2
in its high nibble, both signed. Used for the encoder rings only.

Q8 weights (`Quantized`, `quantize_np`, `dequantize`) are not ported yet.
"""

from __future__ import annotations

import torch


def _amax_scales(x: torch.Tensor, kv_heads: int, head_dim: int, qmax: float):
    b, s, _ = x.shape
    x4 = x.float().reshape(b, s, kv_heads, head_dim)
    amax = x4.abs().amax(dim=-1)                           # [B, S, Hkv]
    # XLA compiles `amax / qmax` (a constant divisor) to a product with the
    # f32 reciprocal; the jitted JAX quantizers round that way, and so do we
    scales = torch.where(amax > 0, amax * (1.0 / qmax), torch.ones_like(amax))
    return x4, scales


def quantize_kv(x: torch.Tensor, kv_heads: int, head_dim: int):
    """[B, S, kv_heads*head_dim] float -> (int8 [B, S, K], scales
    [B, kv_heads, S] f32)."""
    b, s, _ = x.shape
    x4, scales = _amax_scales(x, kv_heads, head_dim, 127.0)
    q = torch.clamp(torch.round(x4 / scales[..., None]), -127, 127)
    return (q.to(torch.int8).reshape(b, s, kv_heads * head_dim),
            scales.transpose(1, 2).contiguous())


def quantize_kv_int4(x: torch.Tensor, kv_heads: int, head_dim: int):
    """[B, S, kv_heads*head_dim] float -> (int8 [B, S, K/2] holding two
    int4 codes per byte (halves packing), scales [B, kv_heads, S] f32)."""
    b, s, _ = x.shape
    h2 = head_dim // 2
    x4, scales = _amax_scales(x, kv_heads, head_dim, 7.0)
    q = torch.clamp(torch.round(x4 / scales[..., None]), -8, 7).to(torch.int32)
    packed = (q[..., :h2] & 0xF) | (q[..., h2:] * 16)      # in [-128, 127]
    return (packed.to(torch.int8).reshape(b, s, kv_heads * h2),
            scales.transpose(1, 2).contiguous())


def unpack_int4(packed: torch.Tensor):
    """Inverse nibble split: packed int8 [..., n] -> (lo, hi) int32 signed
    int4 codes (lanes c and c + hd/2 of `quantize_kv_int4`'s layout)."""
    xi = packed.to(torch.int32)
    hi = xi >> 4                                           # arithmetic shift
    lo = ((xi & 0xF) ^ 8) - 8                              # sign-extend nibble
    return lo, hi
