"""Decode attention over int8, nibble-packed and block-major rings: plain
versions and the CUDA kernels of `csrc/layout_attention.cu`, the ports of
four Pallas profiling kernels. Every kv head has hd = 128 lanes and 4
query heads: kv head h reads q lanes [512 h, 512 h + 512) as a [4, 128]
matrix and writes the same lanes of the bf16 output.

- `attn8(q, kr, vr)`, T4 (`tools/profile_int4_unpack.py:83`): int8 rings
  [B, P, kv_dim]; s = q . k^T (f32), e = exp(s - max s) rounded to bf16,
  out = e . v. Unmasked and unnormalised, as in the tool.
- `attn4(q, krp, vrp)`, T5 (`tools/profile_int4_unpack.py:131`): the same
  on nibble-packed rings [B, P, kv_dim / 2] (`quant.unpack_int4`'s layout:
  byte c of a head holds lane c low, lane c + 64 high); s is the lo-half
  dot plus the hi-half dot.
- `attn3d(q, kr, vr, sp, qp, ks, vs, blk)`, T6
  (`tools/profile_attn_layout.py:52`): int8 rings [B, P, kv_dim], scales
  ks, vs [B, kv_dim / blk, blk / 128, P] (the memory of [B, kv_heads, P]),
  slot positions sp [B, 1, P] and the query position qp [B, 1, 1]; masked
  (0 <= sp <= qp, sp >= qp - 8191) and normalised in the tool's rounding
  order (`_cell`, :29): den before the scales, e * vs rounded to bf16, the
  division after the PV product. A stream with every slot masked gives 0.
- `attn4d(...)`, T7 (`tools/profile_attn_layout.py:87`): T6 on
  block-major rings [B, kv_dim / blk, P, blk].

The batch comes from the tensors (the tools' kernels read a module global
B). A CPU tensor takes the plain version; a CUDA tensor launches the
kernel (counted in `LAUNCHES`) or raises.

T4, T6 and T7 run on the CUDA cores, one block per (stream, kv head). T5
runs on the tensor cores with P split into fixed shares of 16-slot tiles,
the splits of a (stream, kv head) one thread-block cluster that merges in
one launch; `t5_plan` sizes the split from the shapes and the card's
resident blocks, and the wrapper refuses what the plan cannot take before
the card. T4, T6 and T7 take P up to 13440 slots (the CUDA-core kernels'
scores in one block's shared memory); T5 takes up to 16768 (8 shares of
2096).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from voxtral_tpu_torch.ops._scratch import resident_per_cluster, sm_count
from voxtral_tpu_torch.quant import unpack_int4

HD, GROUP = 128, 4
WINDOW = 8192                              # profile_attn_layout.py:31
_NEG = -1e30
_SCALE = float(torch.tensor(1.0 / math.sqrt(HD), dtype=torch.float32))   # f32 value
_RED_BYTES = 8 * GROUP * HD * 4            # = kRedBytes in the source
_MAX_DYNAMIC_SMEM = 232448 - 1024          # = kMaxDynamicSmem
_T5_TILE = 16                              # = kT5Tile: slots per tile
_T5_MAX_SPLITS = 8                         # = kT5MaxSplits: one portable cluster
_T5_MAX_SHARE = 2096                       # = kT5MaxShare: slots of one split
T5_MAX_SLOTS = _T5_MAX_SPLITS * _T5_MAX_SHARE

# Kernel launches; a wrapper adds one where it launches its kernel and
# nowhere else.
LAUNCHES = {"attn8": 0, "attn4": 0, "attn3d": 0, "attn4d": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _query_rows(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """q [B, 1, kv_heads * 512] -> f32 [B, kv_heads, 4, 128] of its bf16 values."""
    return q.to(torch.bfloat16).float().reshape(q.shape[0], kv_heads, GROUP, HD)


def _head_rows(r: torch.Tensor, kv_heads: int, lanes: int) -> torch.Tensor:
    """[B, P, kv_heads * lanes] -> [B, kv_heads, P, lanes]."""
    b, p, _ = r.shape
    return r.reshape(b, p, kv_heads, lanes).transpose(1, 2)


def _out(o: torch.Tensor, dtype) -> torch.Tensor:
    """[B, kv_heads, 4, 128] -> [B, 1, kv_heads * 512] in `dtype`."""
    return o.reshape(o.shape[0], 1, -1).to(dtype)


def _probs(s: torch.Tensor) -> torch.Tensor:
    """exp(s - max s) over the slots, rounded to bf16 (held as f32)."""
    return torch.exp(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float()


def attn8_plain(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    hkv = kr.shape[2] // HD
    qh = _query_rows(q, hkv)
    k, v = (_head_rows(r.float(), hkv, HD) for r in (kr, vr))
    e = _probs(qh @ k.transpose(-1, -2))
    return _out(e @ v, torch.bfloat16)


def attn4_plain(q: torch.Tensor, krp: torch.Tensor, vrp: torch.Tensor) -> torch.Tensor:
    hh = HD // 2
    hkv = krp.shape[2] // hh
    qh = _query_rows(q, hkv)
    klo, khi = (x.float() for x in unpack_int4(_head_rows(krp, hkv, hh)))
    vlo, vhi = (x.float() for x in unpack_int4(_head_rows(vrp, hkv, hh)))
    s = qh[..., :hh] @ klo.transpose(-1, -2) + qh[..., hh:] @ khi.transpose(-1, -2)
    e = _probs(s)
    return _out(torch.cat([e @ vlo, e @ vhi], -1), torch.bfloat16)


def _masked_plain(q, k, v, sp, qp, ks, vs):
    """T6/T7 on codes k, v f32 [B, kv_heads, P, 128], scales [B, kv_heads, P]."""
    b, hkv, p, _ = k.shape
    qh = _query_rows(q, hkv)
    sp, qp = sp.reshape(b, 1, 1, p), qp.reshape(b, 1, 1, 1)
    mask = (sp >= 0) & (sp <= qp) & (sp >= qp - (WINDOW - 1))      # int32, wraps as JAX's
    s = (qh @ k.transpose(-1, -2)) * _SCALE
    s = torch.where(mask, s * ks.reshape(b, hkv, 1, p), _NEG)
    m = torch.clamp_min(s.amax(-1, keepdim=True), _NEG / 2)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    den = torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    e = (e * vs.reshape(b, hkv, 1, p)).to(torch.bfloat16).float()
    return _out((e @ v) / den, q.dtype)


def attn3d_plain(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    hkv = kr.shape[2] // HD
    k, v = (_head_rows(r.float(), hkv, HD) for r in (kr, vr))
    return _masked_plain(q, k, v, sp, qp, ks, vs)


def to_block_major(r: torch.Tensor, blk: int) -> torch.Tensor:
    """[B, P, kv_dim] -> [B, kv_dim / blk, P, blk], the same values."""
    b, p, kv = r.shape
    return r.reshape(b, p, kv // blk, blk).transpose(1, 2).contiguous()


def attn4d_plain(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    b, nb, p, _ = kr.shape
    sub = blk // HD

    def heads(r):                                  # [B, nb, P, blk] -> [B, hkv, P, hd]
        return r.float().reshape(b, nb, p, sub, HD).transpose(2, 3).reshape(b, nb * sub, p, HD)

    return _masked_plain(q, heads(kr), heads(vr), sp, qp, ks, vs)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("layout_attention.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.attn8_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.attn8_launch.restype = ci
    lib.attn4_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.attn4_launch.restype = ci
    lib.attn4_resident_blocks.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
    lib.attn4_resident_blocks.restype = ci
    lib.attn_masked_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.attn_masked_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _resident(index: int) -> tuple[int, ...]:
    """T5's blocks resident at once on card `index` in clusters of 1..8."""
    return resident_per_cluster(lambda _rows, c, blocks: _lib().attn4_resident_blocks(c, blocks),
                                index, 0, _T5_MAX_SPLITS, "attn4")


def t5_plan(b: int, p: int, kv_heads: int, sms: int, resident) -> tuple[int, int]:
    """(share, splits) of T5 on b streams, p slots and kv_heads heads, on a
    card of `sms` SMs where `resident[c - 1]` of T5's blocks are resident at
    once when a (stream, head)'s splits form clusters of c blocks (c =
    1..8). Split r takes slots [r share, (r + 1) share), each share whole
    16-slot tiles and no split empty: the fewest splits (at most 8) whose b
    x kv_heads x splits blocks cover every SM, fewer where that grid would
    pass one wave, and never fewer than shares of at most 2096 slots need.
    Refuses p outside 1..16768."""
    if b < 1 or kv_heads < 1:
        raise ValueError(f"attn4: {b} streams, {kv_heads} kv heads")
    if not 1 <= p <= T5_MAX_SLOTS:
        raise ValueError(f"attn4: {p} slots; the kernel takes 1..{T5_MAX_SLOTS} "
                         f"({_T5_MAX_SPLITS} shares of {_T5_MAX_SHARE})")
    pairs, tiles = b * kv_heads, -(-p // _T5_TILE)
    need = -(-p // _T5_MAX_SHARE)
    splits = min(_T5_MAX_SPLITS, tiles, max(need, -(-sms // pairs)))
    while splits > need and pairs * splits > resident[splits - 1]:
        splits -= 1
    share = -(-tiles // splits) * _T5_TILE
    return share, -(-p // share)


def _smem_bytes(slots: int, masked: bool) -> int:
    """Dynamic shared memory of one block (= smem_bytes in the source)."""
    return 16 * slots + _RED_BYTES + (9 * slots if masked else 0)


def _check_dtypes(name: str, pairs) -> None:
    for t, dtype in pairs:
        if t.dtype != dtype:
            raise ValueError(f"{name} takes {dtype}, got {t.dtype}")


def _check_dims(name: str, q, b: int, p: int, hkv: int) -> None:
    if q.shape != (b, 1, hkv * GROUP * HD):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match {hkv} kv heads of "
                         f"{HD} lanes ({GROUP} query rows each) and {b} streams")
    if not 1 <= b <= 65535 or p < 1 or hkv < 1:
        raise ValueError(f"{name}: {b} streams, {p} slots, {hkv} kv heads")


def _check_smem(name: str, p: int, masked: bool) -> None:
    """The CUDA-core kernels keep a block's P score rows in shared memory."""
    if _smem_bytes(p, masked) > _MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: {p} slots' score rows exceed the block's shared memory")


def _device(name: str, tensors) -> torch.device:
    """The one CUDA device of `tensors`, each contiguous and 16-byte aligned."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, expected {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")
    return dev


def _launched(name: str, err: int, out: torch.Tensor) -> torch.Tensor:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _unmasked_kernel(name: str, q, kr, vr, packed: bool) -> torch.Tensor:
    _check_dtypes(name, ((q, torch.bfloat16), (kr, torch.int8), (vr, torch.int8)))
    lanes = HD // 2 if packed else HD
    if kr.dim() != 3 or kr.shape != vr.shape or kr.shape[2] % lanes:
        raise ValueError(f"{name} takes two [B, P, kv_heads * {lanes}] rings, got "
                         f"{tuple(kr.shape)}, {tuple(vr.shape)}")
    b, p, kv = kr.shape
    hkv = kv // lanes
    _check_dims(name, q, b, p, hkv)
    if not packed:
        _check_smem(name, p, False)
    elif p > T5_MAX_SLOTS:
        raise ValueError(f"{name}: {p} slots; the kernel takes 1..{T5_MAX_SLOTS}")
    dev = _device(name, (q, kr, vr))
    plan = ()
    if packed:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        plan = t5_plan(b, p, hkv, sm_count(index), _resident(index))
    out = torch.empty_like(q)
    launch = _lib().attn4_launch if packed else _lib().attn8_launch
    err = launch(q.data_ptr(), kr.data_ptr(), vr.data_ptr(), out.data_ptr(), b, p, hkv, *plan,
                 torch.cuda.current_stream(dev).cuda_stream)
    return _launched(name, err, out)


def attn8_kernel(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    """T4 on CUDA tensors: q bf16 [B, 1, 4 kv_dim], kr, vr int8 [B, P,
    kv_dim] (kv_dim % 128 == 0); raises on anything else."""
    return _unmasked_kernel("attn8", q, kr, vr, False)


def attn4_kernel(q: torch.Tensor, krp: torch.Tensor, vrp: torch.Tensor) -> torch.Tensor:
    """T5 on CUDA tensors: q bf16 [B, 1, 8 C], krp, vrp packed int8 [B, P, C]
    (C % 64 == 0); raises on anything else."""
    return _unmasked_kernel("attn4", q, krp, vrp, True)


def _masked_kernel(name, q, kr, vr, sp, qp, ks, vs, blk, block_major):
    _check_dtypes(name, ((q, torch.bfloat16), (kr, torch.int8), (vr, torch.int8),
                         (sp, torch.int32), (qp, torch.int32), (ks, torch.float32),
                         (vs, torch.float32)))
    if kr.shape != vr.shape or kr.dim() != (4 if block_major else 3):
        raise ValueError(f"{name}: rings {tuple(kr.shape)}, {tuple(vr.shape)}")
    if block_major:
        b, nb, p, width = kr.shape
        kv = nb * width
        if width != blk:
            raise ValueError(f"{name}: ring blocks of {width} lanes, blk {blk}")
    else:
        b, p, kv = kr.shape
    if blk < HD or blk % HD or kv % blk:
        raise ValueError(f"{name}: blk {blk} must be a multiple of {HD} dividing {kv}")
    _check_dims(name, q, b, p, kv // HD)
    _check_smem(name, p, True)
    if (sp.shape != (b, 1, p) or qp.shape != (b, 1, 1)
            or ks.shape != (b, kv // blk, blk // HD, p) or vs.shape != ks.shape):
        raise ValueError(f"{name}: sp {tuple(sp.shape)}, qp {tuple(qp.shape)}, ks "
                         f"{tuple(ks.shape)}, vs {tuple(vs.shape)} do not match the rings")
    dev = _device(name, (q, kr, vr, sp, qp, ks, vs))
    out = torch.empty_like(q)
    err = _lib().attn_masked_launch(
        q.data_ptr(), kr.data_ptr(), vr.data_ptr(), sp.data_ptr(), qp.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), out.data_ptr(), b, p, kv // HD,
        blk if block_major else 0, torch.cuda.current_stream(dev).cuda_stream)
    return _launched(name, err, out)


def attn3d_kernel(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    """T6 on CUDA tensors: q bf16 [B, 1, 4 kv_dim], kr, vr int8 [B, P,
    kv_dim], sp int32 [B, 1, P], qp int32 [B, 1, 1], ks, vs f32 [B, kv_dim /
    blk, blk / 128, P]; raises on anything else."""
    return _masked_kernel("attn3d", q, kr, vr, sp, qp, ks, vs, blk, False)


def attn4d_kernel(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    """T7: T6 on block-major int8 rings [B, kv_dim / blk, P, blk]."""
    return _masked_kernel("attn4d", q, kr, vr, sp, qp, ks, vs, blk, True)


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


def attn8(q: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    return attn8_kernel(q, kr, vr) if _route(q) else attn8_plain(q, kr, vr)


def attn4(q: torch.Tensor, krp: torch.Tensor, vrp: torch.Tensor) -> torch.Tensor:
    return attn4_kernel(q, krp, vrp) if _route(q) else attn4_plain(q, krp, vrp)


def attn3d(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    fn = attn3d_kernel if _route(q) else attn3d_plain
    return fn(q, kr, vr, sp, qp, ks, vs, blk)


def attn4d(q, kr, vr, sp, qp, ks, vs, blk: int) -> torch.Tensor:
    fn = attn4d_kernel if _route(q) else attn4d_plain
    return fn(q, kr, vr, sp, qp, ks, vs, blk)


def chain(attn, q: torch.Tensor, kr, vr, layers: int) -> torch.Tensor:
    """The tools' timed program: `layers` calls acc = acc + 0.001 *
    attn(acc, k, v), from acc = q. kr, vr: lists of ring copies, call i
    reading copy i % len(kr)."""
    acc = q
    for i in range(layers):
        acc = acc + 0.001 * attn(acc, kr[i % len(kr)], vr[i % len(vr)]).to(q.dtype)
    return acc
