"""Tied-embedding logits and the greedy argmax: plain version and the fused
CUDA kernel K3 (`csrc/logits_argmax.cu`), the port of the Pallas kernel
`tools/profile_logits.py:57 fused_logits_argmax` (pallas_call at :103).

    logits[b, v] = (h[b] . T[v], summed in f32) [* s[v]]
    tok[b]       = argmax_v logits[b, v]        (first index on ties)

The table is the decoder's tied embedding: a float tensor [V, D] (bf16 or
f32; h is first cast to its dtype, voxtral_tpu/ops/linear.py:56) or a
`Quantized` table with axis=0 (int8 [V, D] and f32 per-row scales [V]; h
keeps its own dtype, the scale multiplies the f32 sum, linear.py:50-54).

- `logits_argmax(h, embed, tp=None)`: tok int32 [B]; the decode step's
  greedy head. With a `parallel.TensorParallel` over a vocab-sharded
  table, each rank runs K3 on its own rows and also takes the winning
  logit; the ranks all-gather (logit, index + the shard's offset) and keep
  the largest logit, the lowest global index on ties (jnp.argmax's rule:
  shards are contiguous in rank order).
- `tied_logits(h, embed)`: f32 [B, V]; `embed_logits` takes it for a Q8
  table on CUDA.
A CPU tensor takes the plain version; a CUDA tensor launches K3 (argmax or
logits mode, one launch either way, counted together in `LAUNCHES`) or
raises. K3's route is a dispatch on dtype (`k3_plan`): a bf16 table, or an
int8 table with bf16 h, runs its products on the tensor cores (mma.sync,
one block per SM streaming the table); an f32 table, or an int8 table with
f32 h, on the CUDA cores in f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxtral_tpu_torch.ops._scratch import sm_count, zeroed_scratch
from voxtral_tpu_torch.quant import Quantized

# = kBlockRows, kMaxBT, kWarps in the source: vocab rows per block of the
# CUDA-core route, streams per grid.y row, warps per block
_BLOCK_ROWS, _MAX_BT, _WARPS = 512, 16, 8
# the tensor-core route's shared memory: h in fragment order, two tiles'
# partial sums (16 KB) and at least two stages of 16 rows x 128 columns per
# warp, within the card's opt-in limit (227 KB on the H100) less
# kSmemReserve
_SMEM_LIMIT = 232448 - 2048
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


def logits_argmax_plain(h: torch.Tensor, table: torch.Tensor, scales=None, *,
                        with_value: bool = False):
    """int32 [B]: the first index of each row's largest logit; with
    `with_value`, also that logit (f32 [B])."""
    logits = tied_logits_plain(h, table, scales)
    tok = torch.argmax(logits, dim=-1)
    if with_value:
        return tok.to(torch.int32), torch.gather(logits, 1, tok[:, None])[:, 0]
    return tok.to(torch.int32)


def k3_plan(table_dtype, h_dtype, b: int, v: int, d: int, sms: int) -> tuple[str, int, int]:
    """(route, blocks, scratch entries) of a K3 call: the route by dtype
    ("tensor_cores" for a bf16 table, or int8 with bf16 h; "cuda_cores"
    otherwise), grid.x (ceil(V / 512) on the CUDA cores; on the tensor cores
    one block per SM, fewer when there are fewer 16-row tiles than SMs),
    and the argmax partials' length (blocks x ceil(B / 16) x 16). Raises if
    the tensor cores' shared memory cannot hold h for this D."""
    if table_dtype == torch.bfloat16 or (table_dtype == torch.int8
                                         and h_dtype == torch.bfloat16):
        n_tiles = 1 if b <= 8 else 2
        h_bytes = -(-d // 128) * 8 * n_tiles * 256
        stage = 16 * 128 * table_dtype.itemsize
        if h_bytes + 16384 + 2 * _WARPS * stage > _SMEM_LIMIT:
            raise ValueError(f"D = {d}: h does not fit the kernel's shared memory")
        route, blocks = "tensor_cores", min(sms, -(-v // 16))
    else:
        route, blocks = "cuda_cores", -(-v // _BLOCK_ROWS)
    return route, blocks, blocks * -(-b // _MAX_BT) * _MAX_BT


@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    fn = _build.load("logits_argmax.cu").logits_argmax_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci] * 3 + [vp] * 9 + [ci] * 4 + [vp]
    fn.restype = ci
    return fn


def fused_logits_argmax(h: torch.Tensor, table: torch.Tensor, scales=None, *,
                        logits: bool = False, with_value: bool = False):
    """K3 on CUDA tensors: h [B, D] f32/bf16, table [V, D] f32/bf16, or
    int8 with scales f32 [V]; all contiguous, D % 16 == 0, the table
    16-byte aligned. Returns tok int32 [B] (with `with_value`, also the
    winning logits f32 [B]), or with `logits` the f32 logits [B, V].
    Launches on the current stream; raises on anything else."""
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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _, blocks, n_part = k3_plan(table.dtype, h.dtype, b, v, d, sm_count(index))
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    out = best = part_val = part_idx = counters = None
    if logits:
        out = torch.empty((b, v), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b,), dtype=torch.int32, device=dev)
        if with_value:
            best = torch.empty((b,), dtype=torch.float32, device=dev)
        part_val = torch.empty((n_part,), dtype=torch.float32, device=dev)
        part_idx = torch.empty((n_part,), dtype=torch.int32, device=dev)
        counters = zeroed_scratch(index, "fused_logits_argmax", _N_COUNTERS)
    err = _lib()(_TABLE_CODES[table.dtype], _H_CODES[h.dtype], int(logits), h.data_ptr(),
                 table.data_ptr(), ptr(scales), out.data_ptr() if logits else None,
                 None if logits else out.data_ptr(), ptr(best), ptr(part_val), ptr(part_idx),
                 ptr(counters), b, v, d, blocks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_logits_argmax kernel launch failed: CUDA error {err}")
    LAUNCHES["fused_logits_argmax"] += 1
    return (out, best) if with_value else out


def _dispatch(h, embed, logits: bool, with_value: bool = False):
    table, scales = _table(embed)
    h2 = h.reshape(-1, h.shape[-1])
    if h2.device.type == "cpu":
        if logits:
            return tied_logits_plain(h2, table, scales)
        return logits_argmax_plain(h2, table, scales, with_value=with_value)
    if h2.device.type != "cuda":
        raise ValueError(f"unsupported device {h2.device}")
    return fused_logits_argmax(h2, table, scales, logits=logits, with_value=with_value)


def logits_argmax(h: torch.Tensor, embed, tp=None) -> torch.Tensor:
    """Greedy tokens of h [..., D] over the tied table `embed` (with `tp`:
    this rank's vocab shard) -> int32 [...] (global ids)."""
    if tp is None or tp.model_size == 1:
        return _dispatch(h, embed, False).reshape(h.shape[:-1])
    tok, val = _dispatch(h, embed, False, with_value=True)
    tok = tok + tp.model_rank * _table(embed)[0].shape[0]
    # one gather of (value, global id) in f64, exact for both
    both = tp.all_gather(torch.stack([val.double(), tok.double()])[None], 0)   # [m, 2, B]
    rank = torch.argmax(both[:, 0], dim=0)                  # the first rank on ties
    return both[:, 1].gather(0, rank[None])[0].to(torch.int32).reshape(h.shape[:-1])


def tied_logits(h: torch.Tensor, embed) -> torch.Tensor:
    """f32 logits of h [..., D] over the tied table `embed` -> [..., V]."""
    return _dispatch(h, embed, True).reshape(*h.shape[:-1], -1)
