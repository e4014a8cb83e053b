"""Linear / embedding ops on float weights (counterpart of
`voxtral_tpu/ops/linear.py`). Q8 (`Quantized`) weights arrive with the quant
slice; any non-tensor weight raises here.
"""

from __future__ import annotations

import torch


def _check_weight(w):
    if not isinstance(w, torch.Tensor):
        raise TypeError(
            f"weight of type {type(w).__name__} is not supported: the port "
            "takes float tensors only (Q8 weights arrive with the quant slice)")


def linear(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """x: [..., in] @ w: [in, out] (+ bias) -> [..., out]; mixed float dtypes
    promote as `x @ w` does in JAX."""
    _check_weight(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embed_lookup(embed: torch.Tensor, ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Tied-embedding row gather: ids [...] -> [..., dim] in `dtype`."""
    _check_weight(embed)
    return embed[ids].to(dtype)


def embed_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits: h [..., dim] @ embed[vocab, dim].T -> f32
    [..., vocab], with operands in the table's dtype and f32 accumulation.

    A bf16 product must not round the logits to bf16 (that creates argmax
    ties the JAX package does not have), and an f32 copy of the 131072x3072
    table per token would move 1.6 GB. On the card, `torch.mm(...,
    out_dtype=torch.float32)` keeps bf16 operands and returns the f32
    accumulator. On the CPU the operands are widened to f32, which is exact
    for bf16 values."""
    _check_weight(embed)
    h2 = h.reshape(-1, h.shape[-1]).to(embed.dtype)
    if embed.dtype == torch.float32:
        y = torch.mm(h2, embed.t())
    elif h2.is_cuda:
        y = torch.mm(h2, embed.t(), out_dtype=torch.float32)
    else:
        y = torch.mm(h2.float(), embed.t().float())
    return y.reshape(*h.shape[:-1], embed.shape[0])
