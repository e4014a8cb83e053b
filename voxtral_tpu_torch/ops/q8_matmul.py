"""Products with Q8 weights: plain version, the W8A16 GEMV kernel (K2,
`csrc/w8a16.cu`) and the route `linear` takes for a `Quantized` weight.

    y = round_to(x.dtype)((x @ q, summed in f32) * s)

x: [M, K] f32 or bf16; q: int8 [K, N] (the param tree's [in, out] layout);
s: f32 [N] per-out scales. This is the JAX package's Q8 `linear` without
the bias (voxtral_tpu/ops/linear.py:25-29), an XLA mixed-dtype dot there.
The nearest PyTorch call, `torch._weight_int8pack_mm`, takes the codes as
[N, K] and the scales in x's dtype; `chip_smoke.py` times it as K2's
yardstick, and the port never calls it.

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

from voxtral_tpu_torch.ops._scratch import cluster_splits, resident_per_cluster

# Decode's largest M (streams per step) that goes to the GEMV kernel
Q8_GEMV_MAX_ROWS = 64                     # = kMaxM in the source
_COLS = 128                               # = kCols: columns per block (bf16 route)
_STAGE_ROWS = 64                          # = kStageRows: K rows per stage
_STAGES = 4                               # = kStages: stages in the ring
_MAX_SPLITS = 8                           # = kMaxSplits: one portable cluster
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


def k2_plan(m: int, k: int, n: int, resident) -> tuple[int, int, int, int]:
    """(column tile width, stages, k_slice, splits) of K2 on x [m, k] and
    codes [k, n]. `resident[c - 1]`: the bf16 kernel's blocks resident at
    once on the card when a column tile's splits form clusters of c blocks
    (c = 1..8). A block per 128-column tile with all of m's 16-row tiles,
    and K split into the most splits (at most 8, one cluster) whose grid
    stays within one wave, each slice a whole number of 64-row stages and
    no split empty. The f32 route splits K the same way. `m` is checked
    here; it enters through `resident`, which the wrapper asks the runtime
    for at m's 16-row tile count."""
    if not 1 <= m <= Q8_GEMV_MAX_ROWS:
        raise ValueError(f"M = {m} rows: the kernel takes 1..{Q8_GEMV_MAX_ROWS}")
    return (_COLS, _STAGES,
            *cluster_splits(k, -(-n // _COLS), _STAGE_ROWS, resident, _MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("w8a16.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.w8a16_gemv_launch.argtypes = [ci] + [vp] * 4 + [ci] * 5 + [vp]
    lib.w8a16_gemv_launch.restype = ci
    lib.w8a16_resident_blocks.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int)]
    lib.w8a16_resident_blocks.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _resident(index: int, m_tiles: int) -> tuple[int, ...]:
    """Blocks of the bf16 kernel for m_tiles 16-row tiles resident at once
    on card `index`, for clusters of 1..8 blocks."""
    return resident_per_cluster(_lib().w8a16_resident_blocks, index, 16 * m_tiles,
                                _MAX_SPLITS, "w8a16_gemv")


def w8a16_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors: x [M, K] f32/bf16, 1 <= M <= 64, K % 8 == 0;
    q int8 [K, N], N % 16 == 0; s f32 [N]; all contiguous, x, q and s
    16-byte aligned (whole 16-byte chunks of every row, for the kernel's
    stages). One launch on the current stream; raises on anything else,
    before the card."""
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
    if not all(t.is_contiguous() for t in (x, q, s)):
        raise ValueError("w8a16_gemv needs contiguous tensors")
    if k % 8 or n % 16 or any(t.data_ptr() % 16 for t in (x, q, s)):
        raise ValueError(f"K = {k} must be a multiple of 8 and N = {n} of 16, x, q and s "
                         "16-byte aligned")
    dev = x.device
    if dev.type != "cuda" or q.device != dev or s.device != dev:
        raise ValueError(f"w8a16_gemv needs CUDA tensors on one card, got {dev}, "
                         f"{q.device}, {s.device}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _, _, k_slice, splits = k2_plan(m, k, n, _resident(index, -(-m // 16)))
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    err = _lib().w8a16_gemv_launch(_DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
                                   s.data_ptr(), y.data_ptr(), m, k, n, k_slice, splits,
                                   torch.cuda.current_stream(dev).cuda_stream)
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
        # K2 takes whole contiguous rows; a strided x (the conv stem's
        # transposed output reaches the encoder's linears as a view at
        # B = 1) is copied first
        return w8a16_gemv(x.contiguous(), q, s)
    return _q8_mm(x, q, s)
