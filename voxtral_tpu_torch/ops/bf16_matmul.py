"""Skinny bf16 matrix product: plain version and the CUDA kernel T3
(`csrc/bf16_matmul.cu`), the port of the Pallas kernel
`tools/profile_weight_stream.py:98 pallas_matmul` (pallas_call at :103).

    y = x @ w, summed in f32

x: bf16 [M, K], M <= 64 (decode: M = streams); w: bf16 [K, N]; y: f32
[M, N]. Over the whole K: the Pallas grid's k // 1536 steps leave out the
last K % 1536 rows, this product does not.

A CPU tensor takes the plain version; a CUDA tensor launches T3 (counted
in `LAUNCHES`) or raises. `torch.mm` is a yardstick for the kernel in
`chip_smoke.py`, never a route here.

What the kernel takes: 1 <= M <= 64, K % 8 == 0 and N % 8 == 0, x and w
16-byte aligned (whole 16-byte chunks of every row, for its cp.async
stages); every shape the tools use meets that. The wrapper refuses the rest
before the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxtral_tpu_torch.ops._scratch import cluster_splits, resident_per_cluster

BF16_MATMUL_MAX_ROWS = 64                 # = kMaxM in the source
_COLS = 128                               # = kCols: columns per block
_STAGE_ROWS = 64                          # = kStageRows: K rows per stage
_STAGES = 4                               # = kStages: stages in the ring
_MAX_SPLITS = 8                           # = kMaxSplits: one portable cluster

LAUNCHES = {"bf16_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["bf16_matmul"] = 0


def bf16_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 product of the exact f32 values of x and w."""
    return torch.mm(x.float(), w.float())


def t3_plan(m: int, k: int, n: int, resident) -> tuple[int, int, int, int]:
    """(column tile width, stages, k_slice, splits) of T3 on x [m, k] @ w
    [k, n]. `resident[c - 1]`: the kernel's blocks resident at once on the
    card when a column tile's splits form clusters of c blocks (c = 1..8).
    A block per 128-column tile, and K split into the most splits (at most
    8, one cluster) whose grid stays within one wave, each slice a whole
    number of 64-row stages and no split empty. `m` is checked here; it
    enters through `resident`, which the wrapper asks the runtime for at
    m's 16-row tile count."""
    if not 1 <= m <= BF16_MATMUL_MAX_ROWS:
        raise ValueError(f"M = {m} rows: the kernel takes 1..{BF16_MATMUL_MAX_ROWS}")
    return (_COLS, _STAGES,
            *cluster_splits(k, -(-n // _COLS), _STAGE_ROWS, resident, _MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("bf16_matmul.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bf16_matmul_launch.argtypes = [vp] * 3 + [ci] * 5 + [vp]
    lib.bf16_matmul_launch.restype = ci
    lib.bf16_matmul_resident_blocks.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_int)]
    lib.bf16_matmul_resident_blocks.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _resident(index: int, m_tiles: int) -> tuple[int, ...]:
    """Blocks of the kernel for m_tiles 16-row tiles resident at once on
    card `index`, for clusters of 1..8 blocks."""
    return resident_per_cluster(_lib().bf16_matmul_resident_blocks, index, 16 * m_tiles,
                                _MAX_SPLITS, "bf16_matmul")


def bf16_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """T3 on CUDA tensors: x bf16 [M, K], 1 <= M <= 64, K % 8 == 0; w bf16
    [K, N], N % 8 == 0; both contiguous and 16-byte aligned. Launches on
    the current stream; raises on anything else."""
    for t in (x, w):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"bf16_matmul takes contiguous 2-D bf16 tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"w must be [{k}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    if not 1 <= m <= BF16_MATMUL_MAX_ROWS:
        raise ValueError(f"M = {m} rows: the kernel takes 1..{BF16_MATMUL_MAX_ROWS}")
    if k % 8 or n % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"K = {k} and N = {n} must be multiples of 8, x and w 16-byte "
                         "aligned")
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"bf16_matmul needs CUDA tensors on one card, got {dev}, "
                         f"{w.device}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _, _, k_slice, splits = t3_plan(m, k, n, _resident(index, -(-m // 16)))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _lib().bf16_matmul_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n,
                                    k_slice, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16_matmul kernel launch failed: CUDA error {err}")
    LAUNCHES["bf16_matmul"] += 1
    return y


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] (bf16) -> f32 [M, N]; see the module docstring
    for the routes."""
    if x.device.type == "cpu":
        return bf16_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return bf16_matmul_kernel(x, w)
