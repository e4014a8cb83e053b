"""RMSNorm with f32 statistics (counterpart of `voxtral_tpu/ops/norms.py`).

Statistics and the scale multiply are computed in float32 regardless of
input dtype, then cast back (python_simple_implementation.py:229-237).

`rms_norm(x, weight, eps)` takes the plain version (`rms_norm_plain`) for a
CPU tensor and launches K4 (`csrc/rms_norm.cu`, counted in `LAUNCHES`) for a
CUDA tensor, or raises. K4 is a hand kernel with no Pallas counterpart (the
JAX package leaves the norm to an XLA fusion): one launch instead of the
plain version's nine, and a reduction order fixed by D and the dtype
(`k4_plan`), so a row's bits never depend on how many rows the call holds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

MAX_VECS = 4                             # = kMaxVecs in the source
_MAX_THREADS = 1024                      # = kMaxThreads
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # = DType in the source

# Kernel launches; the wrapper adds one where it launches its kernel and
# nowhere else.
LAUNCHES = {"rms_norm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., D], weight: [D]. Returns same dtype as x."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    out = xf * rms * weight.float()
    return out.to(x.dtype)


class K4Plan(NamedTuple):
    vec: int                  # elements a load: 16 bytes' worth, or 1 for an odd width
    threads: int              # threads a block (one row a block)


def k4_plan(d: int, dtype: torch.dtype) -> K4Plan:
    """K4's block shape for rows of width `d` in `dtype`: every loop bound
    and so the order of every f32 operation. It takes no row count, so a
    row's bits are the same in a call of 1 row or of 1280. About two
    vectors a thread (at most MAX_VECS), at least one warp and at most
    1024 threads; a width that is not a multiple of 16 bytes takes the
    scalar path (vec 1)."""
    if dtype not in _DTYPES:
        raise ValueError(f"rms_norm: K4 takes f32 or bf16 rows, not {dtype}")
    if d < 1:
        raise ValueError(f"rms_norm: width {d}")
    wide = 16 // dtype.itemsize
    vec = wide if d % wide == 0 else 1
    nvec = d // vec
    half = -(-nvec // 2)
    threads = min(_MAX_THREADS, max(32, 32 * -(-half // 32)))
    if nvec > threads * MAX_VECS:
        raise ValueError(f"rms_norm: width {d} in {dtype} exceeds K4's {threads} threads x "
                         f"{MAX_VECS} vectors of {vec} elements")
    return K4Plan(vec, threads)


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    fn = _build.load("rms_norm.cu").rms_norm_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp] + [ci] * 6 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


def _dense_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if it is contiguous and 16-byte aligned, else a fresh copy
    (an allocation is aligned): a strided x reaches the kernel as dense rows."""
    if not t.is_contiguous():
        return t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K4 on a CUDA x [..., D] (f32 or bf16) and weight [D] (f32 or bf16) on
    the same card; returns x's shape and dtype. Raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_kernel takes a CUDA tensor, got one on {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if weight.device != x.device or weight.dtype not in _DTYPES or tuple(weight.shape) != (d,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} {weight.dtype} on "
                         f"{weight.device} for x [..., {d}] on {x.device}: K4 takes an f32 or "
                         "bf16 weight [D] on x's device")
    plan = k4_plan(d, x.dtype)
    rows = x.numel() // d
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    xd, wd = _dense_aligned(x), _dense_aligned(weight)
    err = _lib()(xd.data_ptr(), wd.data_ptr(), out.data_ptr(), rows, d, _DTYPES[x.dtype],
                 _DTYPES[weight.dtype], plan.vec, plan.threads, eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    LAUNCHES["rms_norm"] += 1
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., D], weight: [D]. Returns same dtype as x."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return rms_norm_kernel(x, weight, eps)
