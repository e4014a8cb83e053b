"""Linear / embedding ops that dispatch on the weight's representation
(counterpart of `voxtral_tpu/ops/linear.py`): float tensors, or Q8
(`quant.Quantized`: int8 codes + f32 per-row scales). Every matmul of the
model goes through `linear`, so Q8 is a change of data, not of model code.
"""

from __future__ import annotations

import torch

from voxtral_tpu_torch.ops.logits_argmax import tied_logits, tied_logits_plain
from voxtral_tpu_torch.ops.q8_matmul import q8_matmul
from voxtral_tpu_torch.quant import Quantized


def _check_weight(w):
    if not isinstance(w, (torch.Tensor, Quantized)):
        raise TypeError(f"weight of type {type(w).__name__} is not supported: the "
                        "port takes float tensors and Q8 (quant.Quantized) weights")


def linear(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """x: [..., in] @ w: [in, out] (+ bias) -> [..., out].

    Float w: mixed float dtypes promote as `x @ w` does in JAX. Q8 w
    (scales on the out axis): (x @ q summed in f32) * s, rounded to x's
    dtype (ops/q8_matmul.py). The bias is added in the result's dtype."""
    _check_weight(w)
    if isinstance(w, Quantized):
        if w.axis not in (-1, 1):
            raise ValueError(f"a Q8 linear weight has per-out scales, got axis={w.axis}")
        y = q8_matmul(x.reshape(-1, x.shape[-1]), w.q, w.s)
        y = y.reshape(*x.shape[:-1], w.q.shape[1])
    else:
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embed_lookup(embed, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Tied-embedding row gather: ids [...] -> [..., dim] in `dtype`. A Q8
    table gives q[ids] * s[ids], both cast to `dtype` first (as JAX)."""
    _check_weight(embed)
    if isinstance(embed, Quantized):
        return embed.q[ids].to(dtype) * embed.s[ids].to(dtype)[..., None]
    return embed[ids].to(dtype)


def embed_logits(h: torch.Tensor, embed) -> torch.Tensor:
    """Tied-embedding logits: h [..., dim] @ embed[vocab, dim].T -> f32
    [..., vocab], with f32 accumulation.

    Float table: operands in the table's dtype. A bf16 product must not
    round the logits to bf16 (that creates argmax ties the JAX package does
    not have), and an f32 copy of the 131072x3072 table per token would move
    1.6 GB. On the card, `torch.mm(..., out_dtype=torch.float32)` keeps bf16
    operands and returns the f32 accumulator; on the CPU the operands are
    widened to f32, which is exact for bf16 values.

    Q8 table (axis=0): h keeps its dtype, the per-row scale multiplies the
    f32 sum; on the card this is the K3 kernel's logits mode
    (ops/logits_argmax.py)."""
    _check_weight(embed)
    if isinstance(embed, Quantized):
        return tied_logits(h, embed)
    h2 = h.reshape(-1, h.shape[-1]).to(embed.dtype)
    if embed.dtype == torch.float32:
        y = torch.mm(h2, embed.t())
    elif h2.is_cuda:
        y = torch.mm(h2, embed.t(), out_dtype=torch.float32)
    else:
        y = tied_logits_plain(h2, embed)
    return y.reshape(*h.shape[:-1], embed.shape[0])
