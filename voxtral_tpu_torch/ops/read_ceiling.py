"""Read ceilings: plain versions and the CUDA kernels of
`csrc/read_ceiling.cu`, the ports of three Pallas profiling kernels.

- `wread(q)`, T1 (`tools/profile_q8_matmul_roofline.py:85`): int8 [K, N]
  -> f32 [1, N] column sums. Exact: every partial sum is an integer below
  2^24.
- `rd(k, v, salt)`, T11 (`tools/profile_dma_ceiling.py:28`): int8 rings
  [B, P, C] and an f32 salt (one element) -> f32 [B, 1, C] =
  (sum_p k + sum_p v) + salt, the JAX order; exact up to the one rounding
  of the salt's add, so the same bits as the JAX function.
- `pure_stream(w, blk_k, blk_n)`, T2 (`tools/profile_weight_stream.py:73`):
  bf16 [K, N] -> f32 [8, 128], the sum over the [min(blk_k, K),
  min(blk_n, N)] blocks of w (N-outer, K-inner, from 0) of each block's
  top-left [8, 128] tile. The kernel reads every byte of w (the TPU kernel
  DMAs every block whole); `pure_stream_kernel` also returns a 32-bit
  wrapping sum of w's words per block, which `word_checksum_plain` checks.
  Where K or N is not a multiple of its block, the ragged last blocks add
  their tiles too; the JAX grid (k // bk, n // bn steps) leaves them out.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(counted in `LAUNCHES`) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxtral_tpu_torch.ops._scratch import sm_count, zeroed_scratch

_TILE_COLS, _ROWS_PER_ITER = 512, 64      # = kTileCols, kRowsPerIter in the source
# Column sums: split rows until about this many blocks per SM; the
# fastest target for T1's stack and T11's chain together in the sweep of
# voxtral_tpu_torch/tools/profile_colsum_split.py on an H100 SXM.
_BLOCKS_PER_SM = 2
_STREAM_BLOCKS_PER_SM = 8                 # T2: streaming blocks per SM (grid-stride loop)
_EXACT = 1 << 24                          # an f32 holds every integer below this
_ACC_ENTRIES, _N_COUNTERS = 1 << 20, 1 << 16   # column sums' merge scratch

# Kernel launches; a wrapper adds one where it launches its kernel and
# nowhere else.
LAUNCHES = {"wread": 0, "pure_stream": 0, "rd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def wread_plain(q: torch.Tensor) -> torch.Tensor:
    """f32 [1, N]: column sums of int8 q [K, N], summed exactly in int32."""
    return q.to(torch.int32).sum(0, keepdim=True).to(torch.float32)


def rd_plain(k: torch.Tensor, v: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """f32 [B, 1, C] = (sum_p k + sum_p v) + salt, the two sums exact."""
    ks = k.to(torch.int32).sum(1, keepdim=True).to(torch.float32)
    vs = v.to(torch.int32).sum(1, keepdim=True).to(torch.float32)
    return (ks + vs) + salt.reshape(()).to(torch.float32)


def pure_stream_plain(w: torch.Tensor, blk_k: int = 1536, blk_n: int = 1024) -> torch.Tensor:
    """f32 [8, 128]: the blocks' top-left tiles (clipped to the block and
    the matrix) added in f32, N-outer, K-inner, starting from zeros."""
    k, n = w.shape
    bk, bn = min(blk_k, k), min(blk_n, n)
    acc = torch.zeros((8, 128), dtype=torch.float32, device=w.device)
    for r0, c0 in ((r0, c0) for c0 in range(0, n, bn) for r0 in range(0, k, bk)):
        tile = w[r0:r0 + min(8, bk, k - r0), c0:c0 + min(128, bn, n - c0)]
        acc[:tile.shape[0], :tile.shape[1]] += tile.float()
    return acc


def word_checksum_plain(w: torch.Tensor) -> int:
    """The wrapping sum (mod 2^32) of w's bytes read as 32-bit words."""
    words = w.contiguous().view(-1).view(torch.int32)
    return int(words.to(torch.int64).sum().item()) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("read_ceiling.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.colsum_int8_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.colsum_int8_launch.restype = ci
    lib.pure_stream_launch.argtypes = [vp, ci, ci, ci, ci, vp, vp, ci, vp]
    lib.pure_stream_launch.restype = ci
    return lib


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_cuda(name: str, tensors, dtype) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} takes {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")
    return dev


def col_split(batch: int, rows: int, cols: int, sms: int) -> tuple[int, int]:
    """(k_slice, splits) of the column-sum kernel: rows split until the
    grid has about _BLOCKS_PER_SM blocks per SM, each slice a multiple of
    64 rows."""
    tiles = batch * -(-cols // _TILE_COLS)
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles), -(-rows // _ROWS_PER_ITER)))
    k_slice = -(-(-(-rows // splits)) // _ROWS_PER_ITER) * _ROWS_PER_ITER
    return k_slice, -(-rows // k_slice)


def _colsum(name, a, a2, salt, out):
    """Launch the column-sum kernel over a (and a2) [batch, rows, cols]."""
    batch, rows, cols = a.shape
    if cols % 16:
        raise ValueError(f"{name}: {cols} columns, the kernel takes a multiple of 16")
    if 127 * rows * (1 if a2 is None else 2) >= _EXACT:
        raise ValueError(f"{name}: {rows} rows, sums could leave f32's exact integers")
    if batch * cols > _ACC_ENTRIES or batch * -(-cols // _TILE_COLS) > _N_COUNTERS:
        raise ValueError(f"{name}: {batch} x {cols} columns exceed the merge scratch")
    dev = a.device
    index = _index(dev)
    k_slice, splits = col_split(batch, rows, cols, sm_count(index))
    acc = zeroed_scratch(index, "colsum_acc", _ACC_ENTRIES)
    counters = zeroed_scratch(index, "colsum_counters", _N_COUNTERS)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = _lib().colsum_int8_launch(a.data_ptr(), ptr(a2), ptr(salt), out.data_ptr(),
                                    acc.data_ptr(), counters.data_ptr(), batch, rows, cols,
                                    k_slice, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def wread_kernel(q: torch.Tensor) -> torch.Tensor:
    """T1 on a CUDA int8 [K, N] tensor (N % 16 == 0); raises on anything
    else."""
    dev = _check_cuda("wread", (q,), torch.int8)
    if q.dim() != 2:
        raise ValueError(f"wread takes a 2-D [K, N] tensor, got {tuple(q.shape)}")
    out = torch.empty((1, q.shape[1]), dtype=torch.float32, device=dev)
    return _colsum("wread", q[None], None, None, out)


def rd_kernel(k: torch.Tensor, v: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """T11 on CUDA int8 rings k, v [B, P, C] (C % 16 == 0) and an f32 salt
    of one element; raises on anything else."""
    dev = _check_cuda("rd", (k, v), torch.int8)
    if k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"rd takes two [B, P, C] rings, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if salt.device != dev or salt.dtype != torch.float32 or salt.numel() != 1:
        raise ValueError("rd: salt must be one f32 element on the rings' device")
    b, _, c = k.shape
    out = torch.empty((b, 1, c), dtype=torch.float32, device=dev)
    return _colsum("rd", k, v, salt.contiguous(), out)


def pure_stream_kernel(w: torch.Tensor, blk_k: int = 1536, blk_n: int = 1024):
    """T2 on a CUDA bf16 [K, N] tensor (K * N % 8 == 0). Returns (the f32
    [8, 128] result, the per-block 32-bit wrapping sums of the words read:
    int32 [blocks], whose sum mod 2^32 is `word_checksum_plain(w)` when
    every byte was read). Raises on anything else."""
    dev = _check_cuda("pure_stream", (w,), torch.bfloat16)
    if w.dim() != 2 or (w.shape[0] * w.shape[1]) % 8 or blk_k < 1 or blk_n < 1:
        raise ValueError(f"pure_stream takes bf16 [K, N] with K * N % 8 == 0 and "
                         f"blocks >= 1, got {tuple(w.shape)}, ({blk_k}, {blk_n})")
    k, n = w.shape
    bk, bn = min(blk_k, k), min(blk_n, n)
    index = _index(dev)
    blocks = max(1, min(_STREAM_BLOCKS_PER_SM * sm_count(index), -(-(k * n // 8) // 256)))
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    checksum = torch.empty((blocks,), dtype=torch.int32, device=dev)
    err = _lib().pure_stream_launch(w.data_ptr(), k, n, bk, bn, out.data_ptr(),
                                    checksum.data_ptr(), blocks,
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pure_stream kernel launch failed: CUDA error {err}")
    LAUNCHES["pure_stream"] += 1
    return out, checksum


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def wread(q: torch.Tensor) -> torch.Tensor:
    return wread_kernel(q) if _route(q) else wread_plain(q)


def rd(k: torch.Tensor, v: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    return rd_kernel(k, v, salt) if _route(k) else rd_plain(k, v, salt)


def pure_stream(w: torch.Tensor, blk_k: int = 1536, blk_n: int = 1024) -> torch.Tensor:
    if _route(w):
        return pure_stream_kernel(w, blk_k, blk_n)[0]
    return pure_stream_plain(w, blk_k, blk_n)
