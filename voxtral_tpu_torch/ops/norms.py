"""RMSNorm with f32 statistics (counterpart of `voxtral_tpu/ops/norms.py`).

Statistics and the scale multiply are computed in float32 regardless of
input dtype, then cast back (python_simple_implementation.py:229-237).

`rms_norm(x, weight, eps)` takes the plain version (`rms_norm_plain`) for a
CPU tensor and launches K4 (`csrc/rms_norm.cu`, counted in `LAUNCHES`) for a
CUDA tensor, or raises. K4 is a hand kernel with no Pallas counterpart (the
JAX package leaves the norm to an XLA fusion): one launch instead of the
plain version's nine, and a reduction order fixed by D and the dtype
(`k4_plan`), so a row's bits never depend on how many rows the call holds.

`add_rms_norm(h, delta, weight, eps, scale)` is the layer boundary that XLA
fuses on the TPU: the residual add, the norm and the ada multiply, in one
launch of K4's fused entry with K4's order (the same bits as the unfused
chain `h + delta`, `rms_norm`, `* scale`, which is its plain version).
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
LAUNCHES = {"rms_norm": 0, "add_rms_norm": 0}


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
    fn = _build.load("rms_norm.cu").k4_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [ci] * 6 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


def _dense_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if it is contiguous and 16-byte aligned, else a fresh copy
    (an allocation is aligned): a strided x reaches the kernel as dense rows."""
    if not t.is_contiguous():
        return t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_weight(who: str, x: torch.Tensor, weight: torch.Tensor) -> int:
    """Raises unless weight is an f32 or bf16 [D] on x's device; returns D."""
    d = x.shape[-1] if x.dim() else 0
    if weight.device != x.device or weight.dtype not in _DTYPES or tuple(weight.shape) != (d,):
        raise ValueError(f"{who}: weight {tuple(weight.shape)} {weight.dtype} on "
                         f"{weight.device} for x [..., {d}] on {x.device}: K4 takes an f32 or "
                         "bf16 weight [D] on x's device")
    return d


def _k4_launch(name: str, x: torch.Tensor, weight: torch.Tensor, eps: float,
               delta: torch.Tensor | None = None, scale: torch.Tensor | None = None):
    """The body of both kernel entries: K4 on CUDA x [..., D], plain (delta
    None) or fused. Returns [out], or [h_new, out] with a delta, in x's
    shape and dtype, and counts the launch under `name`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}_kernel takes a CUDA tensor, got one on {x.device}")
    d = _check_weight(name, x, weight)
    plan = k4_plan(d, x.dtype)
    rows = x.numel() // d
    outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for _ in range(1 if delta is None else 2)]
    if rows == 0:
        return outs
    # the dense copies stay referenced until the launch is queued
    dense = [None if t is None else _dense_aligned(t) for t in (x, delta, weight, scale)]
    xp, dp, wp, sp = (None if t is None else t.data_ptr() for t in dense)
    hp = None if delta is None else outs[0].data_ptr()
    err = _lib()(xp, dp, wp, sp, hp, outs[-1].data_ptr(), rows, d, _DTYPES[x.dtype],
                 _DTYPES[weight.dtype], plan.vec, plan.threads, eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return outs


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K4 on a CUDA x [..., D] (f32 or bf16) and weight [D] (f32 or bf16) on
    the same card; returns x's shape and dtype. Raises on anything else."""
    return _k4_launch("rms_norm", x, weight, eps)[0]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., D], weight: [D]. Returns same dtype as x."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return rms_norm_kernel(x, weight, eps)


def add_rms_norm_plain(h: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-5, scale: torch.Tensor | None = None):
    """The unfused chain: h_new = h + delta, x = rms_norm_plain(h_new)
    (* scale). Returns (h_new, x)."""
    h_new = h + delta
    x = rms_norm_plain(h_new, weight, eps)
    if scale is not None:
        x = x * scale
    return h_new, x


def _check_add_args(h, delta, scale):
    """The fused form takes h and delta of one dtype and shape (a call site
    that relied on type promotion casts first), and a scale [D] in their
    dtype on their device."""
    if delta.dtype != h.dtype or delta.shape != h.shape or delta.device != h.device:
        raise ValueError(f"add_rms_norm: h {tuple(h.shape)} {h.dtype} and delta "
                         f"{tuple(delta.shape)} {delta.dtype} on {delta.device}: the same "
                         "dtype, shape and device are needed")
    d = h.shape[-1] if h.dim() else 0
    if scale is not None and (scale.dtype != h.dtype or tuple(scale.shape) != (d,)
                              or scale.device != h.device):
        raise ValueError(f"add_rms_norm: scale {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device} for h [..., {d}] {h.dtype}: a row [D] in h's "
                         "dtype on h's device is needed")


def add_rms_norm_kernel(h: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                        eps: float = 1e-5, scale: torch.Tensor | None = None):
    """K4's fused entry on CUDA h and delta [..., D] (f32 or bf16, one dtype
    and shape), weight [D] (f32 or bf16) and an optional scale [D] in h's
    dtype, all on one card: returns (h + delta, rms_norm(h + delta) (*
    scale)) in h's shape and dtype. Raises on anything else."""
    _check_add_args(h, delta, scale)
    h_new, out = _k4_launch("add_rms_norm", h, weight, eps, delta, scale)
    return h_new, out


def add_rms_norm(h: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5, scale: torch.Tensor | None = None):
    """h, delta: [..., D] of one dtype and shape; weight: [D]; scale: None
    or [D] in h's dtype. Returns (h + delta, rms_norm(h + delta, weight)
    (* scale)), both in h's dtype."""
    if h.device.type == "cuda":
        return add_rms_norm_kernel(h, delta, weight, eps, scale)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    _check_add_args(h, delta, scale)
    return add_rms_norm_plain(h, delta, weight, eps, scale)
