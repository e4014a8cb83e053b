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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxtral_tpu_torch.ops._scratch import sm_count, zeroed_scratch

BF16_MATMUL_MAX_ROWS = 64                 # = kMaxM in the source
_COLS = 32                                # = kCols
_N_COUNTERS = 1 << 16

LAUNCHES = {"bf16_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["bf16_matmul"] = 0


def bf16_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 product of the exact f32 values of x and w."""
    return torch.mm(x.float(), w.float())


def split_k(k: int, n: int, slots: int) -> tuple[int, int]:
    """(k_slice, splits): K split while the grid stays within `slots`
    resident blocks (one wave), slices at least 256 rows (one chunk of the
    kernel) and a multiple of 16."""
    tiles = -(-n // _COLS)
    splits = max(1, min(slots // tiles, -(-k // 256)))
    k_slice = -(-(-(-k // splits)) // 16) * 16
    return k_slice, -(-k // k_slice)


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("bf16_matmul.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bf16_matmul_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.bf16_matmul_launch.restype = ci
    lib.bf16_matmul_blocks_per_sm.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
    lib.bf16_matmul_blocks_per_sm.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _slots(index: int, m_tiles: int) -> int:
    """Resident blocks of the kernel for m_tiles 16-row tiles on card
    `index`: blocks per SM (from the CUDA runtime) times SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().bf16_matmul_blocks_per_sm(16 * m_tiles, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"bf16_matmul occupancy query failed: CUDA error {err}")
    return blocks.value * sm_count(index)


def bf16_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """T3 on CUDA tensors: x bf16 [M, K], 1 <= M <= 64, K % 8 == 0, 16-byte
    aligned; w bf16 [K, N], N % 4 == 0, 8-byte aligned; both contiguous.
    Launches on the current stream; raises on anything else."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"bf16_matmul needs CUDA tensors, got {dev}")
    for t in (x, w):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"bf16_matmul takes contiguous 2-D bf16 tensors, got "
                             f"{t.dtype} {tuple(t.shape)}")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"w must be [{k}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    if not 1 <= m <= BF16_MATMUL_MAX_ROWS:
        raise ValueError(f"M = {m} rows: the kernel takes 1..{BF16_MATMUL_MAX_ROWS}")
    if k % 8 or n % 4 or x.data_ptr() % 16 or w.data_ptr() % 8:
        raise ValueError(f"K = {k} must be a multiple of 8, N = {n} of 4, x 16-byte and "
                         "w 8-byte aligned")
    if -(-n // _COLS) > _N_COUNTERS:
        raise ValueError(f"N = {n} has more column tiles than the kernel's counters")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    k_slice, splits = split_k(k, n, _slots(index, -(-m // 16)))
    counters = zeroed_scratch(index, "bf16_matmul", _N_COUNTERS)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((splits * m * n if splits > 1 else 1,), dtype=torch.float32,
                       device=dev)
    err = _lib().bf16_matmul_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                                    counters.data_ptr(), m, k, n, k_slice, splits,
                                    torch.cuda.current_stream(dev).cuda_stream)
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
