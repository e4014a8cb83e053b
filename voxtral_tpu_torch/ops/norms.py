"""RMSNorm with f32 statistics (counterpart of `voxtral_tpu/ops/norms.py`).

Statistics and the scale multiply are computed in float32 regardless of
input dtype, then cast back (python_simple_implementation.py:229-237).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., D], weight: [D]. Returns same dtype as x."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    out = xf * rms * weight.float()
    return out.to(x.dtype)
