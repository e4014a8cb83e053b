"""Products with Q8 weights: plain version, the W8A16 GEMV kernel (K2,
`csrc/w8a16.cu`) and the route `linear` takes for a `Quantized` weight.

    y = round_to(x.dtype)((x @ q, summed in f32) * s)

x: [M, K] f32 or bf16; q: int8 [K, N] (the param tree's [in, out] layout);
s: f32 [N] per-out scales. This is the JAX package's Q8 `linear` without
the bias (voxtral_tpu/ops/linear.py:25-29), an XLA mixed-dtype dot there;
no PyTorch call multiplies bf16 by int8.

`q8_matmul` routes on the device and on M alone:
- a CPU tensor takes the plain version;
- on CUDA, M <= Q8_GEMV_MAX_ROWS (decode: M = streams) launches K2,
  counted in `LAUNCHES`;
- on CUDA, larger M (encoder chunks, prefill, adapter: hundreds of rows)
  casts the codes to x's dtype (exact: |q| <= 127 fits bf16's significand),
  multiplies with `torch.mm` into f32 and scales while rounding to x's
  dtype: the same function as a plain large product, as the JAX package
  leaves it to XLA. Counted in `LARGE_M_CALLS`.
Neither route is a fallback of the other: a CUDA call that K2 does not
take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Decode's largest M (streams per step) that goes to the GEMV kernel
Q8_GEMV_MAX_ROWS = 64
# = kCols, kRowStep, the largest MT and kSlice in w8a16.cu
_COLS, _ROW_STEP, _M_CHUNK, _MAX_SLICE = 32, 16, 16, 512
_BLOCKS_PER_SM = 4                         # split K until about this many blocks
_N_COUNTERS = 1 << 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (a wrapper adds one where it launches its kernel and
# nowhere else) and calls of the large-M route.
LAUNCHES = {"w8a16_gemv": 0}
LARGE_M_CALLS = {"q8_mm": 0}


def reset_launches() -> None:
    LAUNCHES["w8a16_gemv"] = 0
    LARGE_M_CALLS["q8_mm"] = 0


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 product of the exact f32 values, then the scale,
    then rounding to x's dtype."""
    return (torch.mm(x.float(), q.float()) * s.float()).to(x.dtype)


def split_k(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(k_slice, splits) for K2: slices of at most 512 rows (the kernel
    holds a slice's weights in registers), split further until the grid has
    about _BLOCKS_PER_SM blocks per SM while slices stay at least 128 rows
    long; each slice a multiple of 16 rows."""
    tiles = -(-n // _COLS) * -(-m // _M_CHUNK)
    splits = max(-(-k // _MAX_SLICE),
                 min(-(-_BLOCKS_PER_SM * sms // tiles), k // 128))
    k_slice = -(-(-(-k // splits)) // _ROW_STEP) * _ROW_STEP
    return k_slice, -(-k // k_slice)


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    fn = _build.load("w8a16.cu").w8a16_gemv_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci] + [vp] * 6 + [ci] * 5 + [vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _device_state(index: int):
    """(SM count, zeroed split-K counters) of one card; every launch leaves
    the counters zero."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, torch.zeros(_N_COUNTERS, dtype=torch.int32, device=f"cuda:{index}")


def w8a16_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors: x [M, K] f32/bf16 contiguous, 16-byte aligned,
    M <= 64, K % 8 == 0; q int8 [K, N] contiguous (N % 4 == 0, 4-byte
    aligned); s f32 [N]. Launches on the current stream; raises on anything
    else."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"w8a16_gemv needs CUDA tensors, got {dev}")
    if x.dtype not in _DTYPE_CODES or x.dim() != 2:
        raise ValueError(f"x must be 2-D f32 or bf16, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != k:
        raise ValueError(f"q must be int8 [{k}, N], got {q.dtype} {tuple(q.shape)}")
    n = q.shape[1]
    if s.dtype != torch.float32 or tuple(s.shape) != (n,):
        raise ValueError(f"s must be f32 [{n}], got {s.dtype} {tuple(s.shape)}")
    if not 1 <= m <= Q8_GEMV_MAX_ROWS:
        raise ValueError(f"M = {m} rows: the kernel takes 1..{Q8_GEMV_MAX_ROWS}")
    if n % 4 or k % 8 or q.data_ptr() % 4 or x.data_ptr() % 16:
        raise ValueError(f"K = {k} must be a multiple of 8, N = {n} of 4, x 16-byte "
                         "and q 4-byte aligned")
    for t in (x, q, s):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("w8a16_gemv needs contiguous tensors")
    sms, counters = _device_state(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
    if -(-n // _COLS) * -(-m // _M_CHUNK) > _N_COUNTERS:
        raise ValueError(f"N = {n} has more column tiles than the kernel's counters")
    k_slice, splits = split_k(m, k, n, sms)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    part = torch.empty((splits * m * n if splits > 1 else 1,), dtype=torch.float32,
                       device=dev)
    err = _lib()(_DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(), s.data_ptr(),
                 y.data_ptr(), part.data_ptr(), counters.data_ptr(), m, k, n, k_slice,
                 splits, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_gemv kernel launch failed: CUDA error {err}")
    LAUNCHES["w8a16_gemv"] += 1
    return y


def _q8_mm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The large-M route on CUDA (see the module docstring)."""
    LARGE_M_CALLS["q8_mm"] += 1
    if x.dtype == torch.float32:
        return torch.mm(x, q.float()).mul_(s)
    y = torch.mm(x, q.to(x.dtype), out_dtype=torch.float32)
    return torch.mul(y, s, out=torch.empty(y.shape, dtype=x.dtype, device=y.device))


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ Q8 (q [K, N], s [N]) -> [M, N] in x's dtype; see the
    module docstring for the routes."""
    if x.device.type == "cpu":
        return q8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[0] <= Q8_GEMV_MAX_ROWS:
        return w8a16_gemv(x, q, s)
    return _q8_mm(x, q, s)
