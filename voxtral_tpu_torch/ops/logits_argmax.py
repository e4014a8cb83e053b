"""Tied-embedding logits and the greedy argmax: plain version and the fused
CUDA kernel K3 (`csrc/logits_argmax.cu`), the port of the Pallas kernel
`tools/profile_logits.py:57 fused_logits_argmax` (pallas_call at :103).

    logits[b, v] = (h[b] . T[v], summed in f32) [* s[v]]
    tok[b]       = argmax_v logits[b, v]        (first index on ties)

The table is the decoder's tied embedding: a float tensor [V, D] (bf16 or
f32; h is first cast to its dtype, voxtral_tpu/ops/linear.py:56) or a
`Quantized` table with axis=0 (int8 [V, D] and f32 per-row scales [V]; h
keeps its own dtype, the scale multiplies the f32 sum, linear.py:50-54).

- `logits_argmax(h, embed)`: tok int32 [B]; the decode step's greedy head.
- `tied_logits(h, embed)`: f32 [B, V]; `embed_logits` takes it for a Q8
  table on CUDA.
A CPU tensor takes the plain version; a CUDA tensor launches K3 (argmax or
logits mode, one launch either way, counted together in `LAUNCHES`) or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxtral_tpu_torch.quant import Quantized

_BLOCK_ROWS, _MAX_BT = 512, 16             # = kBlockRows, kMaxBT in the source
_H_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TABLE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_N_COUNTERS = 1 << 12

# Kernel launches, both modes; a wrapper adds one where it launches the
# kernel and nowhere else.
LAUNCHES = {"fused_logits_argmax": 0}


def reset_launches() -> None:
    LAUNCHES["fused_logits_argmax"] = 0


def _table(embed):
    """(table [V, D], scales [V] f32 or None) of a float or Q8 table."""
    if isinstance(embed, Quantized):
        if embed.axis != 0:
            raise ValueError(f"a Q8 embedding table has axis=0, got {embed.axis}")
        return embed.q, embed.s
    return embed, None


def tied_logits_plain(h: torch.Tensor, table: torch.Tensor, scales=None) -> torch.Tensor:
    """f32 [B, V] logits of h [B, D]. The operands are widened to f32
    (exact for bf16 values and int8 codes) and multiplied in f32."""
    if scales is None:
        return torch.mm(h.to(table.dtype).float(), table.float().t())
    return torch.mm(h.float(), table.float().t()) * scales.float()


def logits_argmax_plain(h: torch.Tensor, table: torch.Tensor, scales=None) -> torch.Tensor:
    """int32 [B]: the first index of each row's largest logit."""
    return torch.argmax(tied_logits_plain(h, table, scales), dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    fn = _build.load("logits_argmax.cu").logits_argmax_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci] * 3 + [vp] * 8 + [ci] * 3 + [vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _counters(index: int) -> torch.Tensor:
    """Zeroed merge counters of one card; every launch leaves them zero."""
    return torch.zeros(_N_COUNTERS, dtype=torch.int32, device=f"cuda:{index}")


def fused_logits_argmax(h: torch.Tensor, table: torch.Tensor, scales=None, *,
                        logits: bool = False) -> torch.Tensor:
    """K3 on CUDA tensors: h [B, D] f32/bf16, table [V, D] f32/bf16, or
    int8 with scales f32 [V]; all contiguous, D % 16 == 0, the table
    16-byte aligned. Returns tok int32 [B], or with `logits` the f32
    logits [B, V]. Launches on the current stream; raises on anything
    else."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"fused_logits_argmax needs CUDA tensors, got {dev}")
    if h.dtype not in _H_CODES or h.dim() != 2:
        raise ValueError(f"h must be 2-D f32 or bf16, got {h.dtype} {tuple(h.shape)}")
    b, d = h.shape
    if table.dtype not in _TABLE_CODES or table.dim() != 2 or table.shape[1] != d:
        raise ValueError(f"table must be [V, {d}] f32/bf16/int8, got "
                         f"{table.dtype} {tuple(table.shape)}")
    v = table.shape[0]
    if (table.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 table needs scales, a float table takes none")
    if scales is not None and (scales.dtype != torch.float32 or tuple(scales.shape) != (v,)):
        raise ValueError(f"scales must be f32 [{v}], got {scales.dtype} {tuple(scales.shape)}")
    if d % 16 or table.data_ptr() % 16:
        raise ValueError(f"D = {d} must be a multiple of 16 and the table 16-byte aligned")
    if b < 1 or -(-b // _MAX_BT) > _N_COUNTERS:
        raise ValueError(f"B = {b} streams is out of the kernel's range")
    for t in (h, table) + (() if scales is None else (scales,)):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("fused_logits_argmax needs contiguous tensors")
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    out = part_val = part_idx = counters = None
    if logits:
        out = torch.empty((b, v), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b,), dtype=torch.int32, device=dev)
        n_part = -(-v // _BLOCK_ROWS) * -(-b // _MAX_BT) * _MAX_BT
        part_val = torch.empty((n_part,), dtype=torch.float32, device=dev)
        part_idx = torch.empty((n_part,), dtype=torch.int32, device=dev)
        counters = _counters(dev.index if dev.index is not None
                             else torch.cuda.current_device())
    err = _lib()(_TABLE_CODES[table.dtype], _H_CODES[h.dtype], int(logits), h.data_ptr(),
                 table.data_ptr(), ptr(scales), out.data_ptr() if logits else None,
                 None if logits else out.data_ptr(), ptr(part_val), ptr(part_idx),
                 ptr(counters), b, v, d, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_logits_argmax kernel launch failed: CUDA error {err}")
    LAUNCHES["fused_logits_argmax"] += 1
    return out


def _dispatch(h, embed, logits: bool):
    table, scales = _table(embed)
    h2 = h.reshape(-1, h.shape[-1])
    if h2.device.type == "cpu":
        return (tied_logits_plain if logits else logits_argmax_plain)(h2, table, scales)
    if h2.device.type != "cuda":
        raise ValueError(f"unsupported device {h2.device}")
    return fused_logits_argmax(h2, table, scales, logits=logits)


def logits_argmax(h: torch.Tensor, embed) -> torch.Tensor:
    """Greedy tokens of h [..., D] over the tied table `embed` -> int32
    [...]."""
    return _dispatch(h, embed, False).reshape(h.shape[:-1])


def tied_logits(h: torch.Tensor, embed) -> torch.Tensor:
    """f32 logits of h [..., D] over the tied table `embed` -> [..., V]."""
    return _dispatch(h, embed, True).reshape(*h.shape[:-1], -1)
