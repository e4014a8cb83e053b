"""Quantizers: Q8 weights and KV rings (counterpart of `voxtral_tpu/quant.py`,
which imports jax; the port keeps its own copy).

Q8 weights (`Quantized`): per-output-row symmetric int8, scale = amax/127
per row in f32, codes rounded half to even. Linear weights live [in, out]
with scales on the last axis; the tied embedding table stays [vocab, dim]
with per-vocab-row scales (axis=0). `quantize_np` is the numpy quantizer of
the safetensors format (exact division, as numpy divides); `quantize_torch`
and `quantize_params` follow the jitted JAX quantizer, which XLA compiles
with `amax / 127` as a product with the f32 reciprocal. The division of
the weights by their scales is by a tensor and stays a division. Both give
the JAX package's codes and scales bit for bit on the same input.

KV rings: both quantizers are symmetric per (stream, slot, kv-head): scale = amax/127
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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Quantized:
    """Per-row symmetric int8 matrix: w[.., r] ~= q[.., r] * s[r].

    q: int8; s: f32 [q.shape[axis]]. axis=-1 (linear weights [in, out],
    per-out scales) or 0 (the embedding table [vocab, dim])."""
    q: torch.Tensor | np.ndarray
    s: torch.Tensor | np.ndarray
    axis: int = -1

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self):
        return self.q.device


def _scale_shape(ndim: int, axis: int) -> list:
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return shape


def dequantize(w: Quantized) -> torch.Tensor:
    """f32 materialisation (load-time and small tensors only)."""
    return w.q.float() * w.s.float().reshape(_scale_shape(w.q.ndim, w.axis))


def quantize_np(arr, axis: int = -1) -> Quantized:
    """Numpy quantizer of the Q8 safetensors format: scale = amax/127 per
    row on `axis`, symmetric, rounded half to even. numpy arrays in and
    out."""
    arr = np.asarray(arr, dtype=np.float32)
    red = tuple(i for i in range(arr.ndim) if i != (axis % arr.ndim))
    amax = np.abs(arr).max(axis=red)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(arr / scales.reshape(_scale_shape(arr.ndim, axis))),
                -127, 127).astype(np.int8)
    return Quantized(q=q, s=scales, axis=axis % arr.ndim if axis != -1 else -1)


def quantize_torch(w: torch.Tensor, axis: int = -1) -> Quantized:
    """Quantizer on the tensor's device (the counterpart of the jitted
    `quantize_jax`). Works on an f32 copy, in place, so the transient is
    about two f32 copies of `w`."""
    a = w.to(torch.float32, copy=True)
    ax = axis % a.ndim
    red = tuple(i for i in range(a.ndim) if i != ax)
    amax = a.abs().amax(dim=red)
    # XLA rounds `amax / 127.0` as `amax * (1/127)`; so does this
    scales = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = (a.div_(scales.reshape(_scale_shape(a.ndim, ax))).round_()
         .clamp_(-127, 127).to(torch.int8))
    return Quantized(q=q, s=scales, axis=ax if axis != -1 else -1)


# Param-tree keys of the large matmul weights, per layer
_Q8_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_params(params: dict) -> dict:
    """The Q8 inference form of a float param tree: the 7 matrices of every
    encoder and decoder layer, the adapter's w0/w1 and the tied embedding
    become `Quantized`; norms, biases, the conv stem and the ada MLPs stay
    as they are.

    CONSUMES the input: each quantized leaf is replaced in its dict by its
    Q8 form as soon as it is made, so (with no other reference to the float
    leaves) device memory holds the float tree shrinking leaf by leaf and
    never two full trees. Pass a copy to keep the float tree."""
    def swap(d, key, axis=-1):
        d[key] = quantize_torch(d[key], axis)

    for stack in ("encoder", "decoder"):
        for lp in params[stack]["layers"]:
            for key in _Q8_LAYER_KEYS:
                swap(lp, key)
    swap(params["adapter"], "w0")
    swap(params["adapter"], "w1")
    swap(params["decoder"], "embed", axis=0)
    return {
        "encoder": {**params["encoder"],
                    "layers": tuple(dict(lp) for lp in params["encoder"]["layers"])},
        "adapter": dict(params["adapter"]),
        "decoder": {**params["decoder"],
                    "layers": tuple(dict(lp) for lp in params["decoder"]["layers"])},
    }


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
