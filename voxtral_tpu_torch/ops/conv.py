"""Causal 1-D convolution with vLLM WhisperCausalConv1d padding semantics
(counterpart of `voxtral_tpu/ops/conv.py`).

Padding rule (python_simple_implementation.py:327-338): left pad = kernel -
stride; right "extra" pad aligns the output to ceil(n_frames).

The convolution is written as K strided slices, each through one f32
`torch.matmul`, not `F.conv1d`: on the card a float32 `F.conv1d` goes
through cuDNN in TF32 by default, while float32 matmul stays in full
float32 (`torch.backends.cuda.matmul.allow_tf32` is False by default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def causal_conv_pads(length: int, kernel: int, stride: int) -> tuple[int, int]:
    """(left_pad, right_pad) for an input of `length` frames."""
    padding_total = kernel - stride
    n_frames = (length - kernel + padding_total) / stride + 1
    target_length = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    extra = int(target_length - length)
    return padding_total, extra


def causal_conv_out_len(length: int, kernel: int, stride: int) -> int:
    left, extra = causal_conv_pads(length, kernel, stride)
    return (length + left + extra - kernel) // stride + 1


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  *, stride: int) -> torch.Tensor:
    """x: [C_in, L]; weight: [K, C_in, C_out]; bias: [C_out].
    Returns [C_out, L'], computed in f32."""
    _, length = x.shape
    kernel = weight.shape[0]
    left, extra = causal_conv_pads(length, kernel, stride)
    out_len = causal_conv_out_len(length, kernel, stride)
    xp = F.pad(x.float(), (left, extra))                     # [C_in, L + pads]
    w = weight.float()
    out = None
    for k in range(kernel):
        tap = xp[:, k:k + stride * (out_len - 1) + 1:stride]  # [C_in, L']
        y = torch.matmul(w[k].t(), tap)                       # [C_out, L']
        out = y if out is None else out + y
    return out + bias.float()[:, None]
