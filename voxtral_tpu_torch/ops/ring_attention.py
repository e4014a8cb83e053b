"""Ring-buffer GQA decode attention: plain version, CUDA kernel wrapper and
the dispatcher the decoder calls (counterpart of
`voxtral_tpu/ops/pallas_attention.py`).

- `ring_gqa_attention_reference`: plain torch, following the TPU kernel's
  `_kernel`/`_attend_block` (pallas_attention.py:45-198): f32 scores from
  operands in q's dtype, one softmax over ring slots and extra columns,
  the max floored at -5e29 and the denominator at 1e-30 (fully-masked rows
  give 0), unnormalised probabilities cast to q's dtype for PV, division
  after PV. It takes any S and mixed dtypes.
- `ring_gqa_attention`: the kernel wrapper. It accepts the decode regime
  with float rings (S = 1; q, rings and extra columns all f32 or all bf16;
  at most 256 extra columns) and raises on anything else: int8 rings with
  scales, int4-packed rings, S > 1. A CUDA tensor launches
  `csrc/ring_attention.cu`, which is built for head_dim 64 and 128 (the
  widths of voxtral_4b) and raises for others; a CPU tensor takes the plain
  version at any head_dim.
  `ring_gqa_attention.launches` counts kernel launches.
- `ring_attention`: the decoder's entry point.

Heads are merged into the last axis: q [B, S, heads*hd], rings
[B, P, kv_heads*hd]; the `group` query heads of kv head h are the
contiguous heads h*group .. h*group + group - 1.

The read bound `n_valid_slots` (slots >= it must be invalid) is a device
int32 scalar on the CUDA path: the kernel reads it, so no host sync and no
bucket switch is needed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_NEG = -1e30
_HEAD_DIMS = (64, 128)            # the kernel's instantiations (voxtral_4b)
# = kSplit in csrc/ring_attention.cu: ring slots per split. It sizes the
# partial buffers, and the extra columns (one split of their own) fit in it.
_SPLIT_SLOTS = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ring_gqa_attention_reference(q, k_ring, v_ring, slot_pos, q_pos, *,
                                 window: int, heads: int, kv_heads: int,
                                 head_dim: int, extra_k=None, extra_v=None,
                                 extra_pos=None, n_valid_slots=None):
    """Plain version of the fused ring attention. q: [B, S, heads*hd];
    k_ring/v_ring: [B, P, kv_heads*hd]; slot_pos: [B, P] int (negative =
    invalid); q_pos: [B, S]; extra_k/v: [B, Sx, kv_heads*hd] with extra_pos
    [B, Sx]; n_valid_slots: only slots below it are read. Returns
    [B, S, heads*hd] in q.dtype."""
    b, s, qd = q.shape
    p = k_ring.shape[1]
    g = heads // kv_heads
    mxu = q.dtype
    qh = q.reshape(b, s, kv_heads, g, head_dim).permute(0, 2, 3, 1, 4).float()

    def kq(k):                                   # -> [B, Hkv, g, S, T] f32
        kt = (k.to(mxu).float().reshape(b, -1, kv_heads, head_dim)
              .permute(0, 2, 3, 1))              # [B, Hkv, hd, T]
        return torch.matmul(qh, kt[:, :, None])

    def pv(e, v):                                # -> [B, Hkv, g, S, hd] f32
        vt = (v.to(mxu).float().reshape(b, -1, kv_heads, head_dim)
              .permute(0, 2, 1, 3))              # [B, Hkv, T, hd]
        return torch.matmul(e.to(mxu).float(), vt[:, :, None])

    qp = torch.as_tensor(q_pos, device=q.device).reshape(b, s).long()
    lo = qp - (window - 1)

    def mask_of(pos):                            # [B, T] -> [B, 1, 1, S, T]
        pos = pos.long()[:, None, :]
        m = (pos >= 0) & (pos <= qp[:, :, None]) & (pos >= lo[:, :, None])
        return m[:, None, None]

    mask = mask_of(slot_pos)
    if n_valid_slots is not None:
        nv = torch.as_tensor(n_valid_slots, device=q.device)
        mask = mask & (torch.arange(p, device=q.device) < nv)
    scale = 1.0 / math.sqrt(head_dim)
    s1 = torch.where(mask, kq(k_ring) * scale, _NEG)
    m = s1.amax(-1, keepdim=True)
    has_extra = extra_k is not None and extra_k.shape[1] > 0
    if has_extra:
        x_mask = mask_of(extra_pos)
        s2 = torch.where(x_mask, kq(extra_k) * scale, _NEG)
        m = torch.maximum(m, s2.amax(-1, keepdim=True))
    m = torch.clamp(m, min=_NEG / 2)             # fully-masked row guard
    e1 = torch.where(mask, torch.exp(s1 - m), 0.0)
    denom = e1.sum(-1, keepdim=True)
    o = pv(e1, v_ring)
    if has_extra:
        e2 = torch.where(x_mask, torch.exp(s2 - m), 0.0)
        denom = denom + e2.sum(-1, keepdim=True)
        o = o + pv(e2, extra_v)
    o = o / torch.clamp(denom, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, qd).to(q.dtype)


def _check_supported(q, k_ring, v_ring, slot_pos, *, heads, kv_heads,
                     head_dim, k_scale, v_scale, extra_k, extra_v, extra_pos,
                     kv_packed):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 rings with k_scale/v_scale are not supported yet: they "
            "arrive with the fleet slice (ring kernel int8 regime)")
    kv_dim = kv_heads * head_dim
    if kv_packed or k_ring.shape[-1] * 2 == kv_dim:
        raise NotImplementedError(
            "int4-packed rings are not supported yet: they arrive with the "
            "fleet slice (ring kernel encoder regime)")
    b, s, qd = q.shape
    if s != 1:
        raise NotImplementedError(
            f"S = {s} queries per stream: the kernel covers the decode regime "
            "(S = 1); the encoder regime arrives with the fleet slice")
    if heads % kv_heads or qd != heads * head_dim:
        raise ValueError(f"q width {qd} does not match heads={heads}, "
                         f"kv_heads={kv_heads}, head_dim={head_dim}")
    tensors = [q, k_ring, v_ring]
    if extra_k is not None:
        tensors += [extra_k, extra_v]
        if extra_k.shape[1] > _SPLIT_SLOTS:
            raise ValueError(f"{extra_k.shape[1]} extra columns > {_SPLIT_SLOTS}")
        if extra_pos is None or extra_pos.shape != extra_k.shape[:2]:
            raise ValueError("extra_pos must be [B, Sx]")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            "q, rings and extra columns must share one dtype, float32 or "
            f"bfloat16; got {[t.dtype for t in tensors]}")
    if k_ring.shape != v_ring.shape or k_ring.shape[0] != b \
            or k_ring.shape[-1] != kv_dim or slot_pos.shape != k_ring.shape[:2]:
        raise ValueError(f"ring shapes {tuple(k_ring.shape)}, "
                         f"{tuple(v_ring.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)} do not match q {tuple(q.shape)}")


@functools.lru_cache(maxsize=1)
def _lib():
    from voxtral_tpu_torch import _build
    lib = _build.load("ring_attention.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ring_gqa_attention_launch.argtypes = (
        [ci, ci] + [vp] * 13 + [ci] * 6 + [ctypes.c_float, vp])
    lib.ring_gqa_attention_launch.restype = ci
    return lib


def _launch(q, k_ring, v_ring, slot_pos, q_pos, *, window, heads, kv_heads,
            head_dim, extra_k, extra_v, extra_pos, n_valid_slots):
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the kernel is built for "
                         f"{_HEAD_DIMS}")
    dev = q.device
    b, _, qd = q.shape
    p = k_ring.shape[1]
    i32 = torch.int32
    sp = slot_pos.to(i32).contiguous()
    qp = torch.as_tensor(q_pos, device=dev).reshape(b).to(i32).contiguous()
    if n_valid_slots is None:
        n_valid_slots = p
    nv = torch.as_tensor(n_valid_slots, device=dev).to(i32).reshape(())
    sx = 0 if extra_k is None else extra_k.shape[1]
    floats = [q, k_ring, v_ring] + ([extra_k, extra_v] if sx else [])
    ints = [sp, qp, nv]
    if sx:
        xp = extra_pos.to(i32).contiguous()
        ints.append(xp)
    for t in floats + ints:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("ring attention kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in floats):
        raise ValueError("ring attention kernel needs 16-byte aligned tensors")
    n_parts = -(-p // _SPLIT_SLOTS) + 1
    o_part = torch.empty((b, heads, n_parts, head_dim), dtype=torch.float32,
                         device=dev)
    m_part = torch.empty((b, heads, n_parts), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    err = _lib().ring_gqa_attention_launch(
        _DTYPE_CODES[q.dtype], head_dim, q.data_ptr(), k_ring.data_ptr(),
        v_ring.data_ptr(), sp.data_ptr(), qp.data_ptr(),
        extra_k.data_ptr() if sx else None, extra_v.data_ptr() if sx else None,
        xp.data_ptr() if sx else None, nv.data_ptr(), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(), b, p, sx, heads,
        kv_heads, window, 1.0 / math.sqrt(head_dim),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring attention kernel launch failed: CUDA error {err}")
    ring_gqa_attention.launches += 1
    return out


def ring_gqa_attention(q, k_ring, v_ring, slot_pos, q_pos, *, window: int,
                       heads: int, kv_heads: int, head_dim: int,
                       k_scale=None, v_scale=None, extra_k=None, extra_v=None,
                       extra_pos=None, n_valid_slots=None, kv_packed=None):
    """Fused ring attention (decode regime, float rings); see the module
    docstring. Arguments follow the JAX package's `ring_gqa_attention`,
    with `n_valid_slots` (int or device scalar) in place of `p_limit`."""
    _check_supported(q, k_ring, v_ring, slot_pos, heads=heads,
                     kv_heads=kv_heads, head_dim=head_dim, k_scale=k_scale,
                     v_scale=v_scale, extra_k=extra_k, extra_v=extra_v,
                     extra_pos=extra_pos, kv_packed=kv_packed)
    kw = dict(window=window, heads=heads, kv_heads=kv_heads,
              head_dim=head_dim, extra_k=extra_k, extra_v=extra_v,
              extra_pos=extra_pos, n_valid_slots=n_valid_slots)
    if q.device.type == "cpu":
        return ring_gqa_attention_reference(q, k_ring, v_ring, slot_pos,
                                            q_pos, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_ring, v_ring, slot_pos, q_pos, **kw)


ring_gqa_attention.launches = 0


def ring_attention(q, k_ring, v_ring, slot_pos, q_pos, *, window: int,
                   heads: int, kv_heads: int, head_dim: int, k_scale=None,
                   v_scale=None, extra_kv=None, n_valid_slots=None):
    """Entry point used by the decoder. extra_kv: optional (xk, xv, xp);
    n_valid_slots: bound on the ring slots that can hold valid entries
    (slots beyond it MUST be invalid)."""
    xk = xv = xp = None
    if extra_kv is not None:
        xk, xv, xp = extra_kv
    return ring_gqa_attention(
        q, k_ring, v_ring, slot_pos, q_pos, window=window, heads=heads,
        kv_heads=kv_heads, head_dim=head_dim, k_scale=k_scale,
        v_scale=v_scale, extra_k=xk, extra_v=xv, extra_pos=xp,
        n_valid_slots=n_valid_slots)
