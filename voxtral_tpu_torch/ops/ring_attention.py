"""Ring-buffer GQA attention: plain version, CUDA kernel wrappers and the
dispatcher the decoder and the incremental encoder call (counterpart of
`voxtral_tpu/ops/pallas_attention.py`).

- `ring_gqa_attention_reference`: plain torch, following the TPU kernel's
  `_kernel`/`_attend_block` (pallas_attention.py:45-198) in the order of
  its rounding: ring codes cast to q's dtype, f32 scores
  `q.k / sqrt(hd) * ks_j`, one softmax over ring slots and extra columns
  (max floored at -5e29, denominator at 1e-30: fully-masked rows give 0),
  the denominator summed before the V scale multiplies the probability
  column, `e * vs` cast to q's dtype for PV, division after PV; the extra
  (float) columns carry no scales. int4-packed rings take two half-width
  dots. It takes any S, any head_dim and mixed float dtypes.
- `ring_gqa_attention`: the wrapper. A CPU tensor takes the plain version.
  A CUDA tensor launches one of three kernels, counted in `LAUNCHES`:
  * "ring_gqa_attention" (K1, `csrc/ring_attention.cu`): S = 1, rings in
    q's float dtype;
  * "ring_gqa_attention_int8" (K1-int8, same source): S = 1, int8 rings
    with k_scale/v_scale [B, Hkv, P];
  * "ring_gqa_attention_enc" (K1-enc, `csrc/ring_attention_enc.cu`): S > 1,
    or int4-packed rings (any S); float, int8 or int4 rings.
  K1 and K1-int8 are built for head_dim 64 and 128, K1-enc for 64 (the
  encoder's); all take q, float rings and extra columns of one dtype, f32
  or bf16. Anything else raises on CUDA; there is no fallback to the plain
  version.
- `ring_attention`: the models' entry point.

Heads are merged into the last axis: q [B, S, heads*hd], rings
[B, P, kv_heads*hd] (int4-packed: [B, P, kv_heads*hd/2] int8 bytes); the
`group` query heads of kv head h are the contiguous heads h*group ..
h*group + group - 1.

The read bound `n_valid_slots` (slots >= it must be invalid) is a device
int32 scalar on the CUDA path: the kernels read it, so no host sync and no
bucket switch is needed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from voxtral_tpu_torch.quant import unpack_int4

_NEG = -1e30
# the kernels' head_dim instantiations (the widths of voxtral_4b)
_HEAD_DIMS = {"ring_gqa_attention": (64, 128), "ring_gqa_attention_int8": (64, 128),
              "ring_gqa_attention_enc": (64,)}
# = kSplit in csrc/ring_attention.cu: ring slots per split. It sizes the
# partial buffers, and the decode kernel's extra columns (one split of their
# own) must fit in it.
_SPLIT_SLOTS = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches, one plain integer per kernel; a wrapper adds one where
# it launches its kernel and nowhere else.
LAUNCHES = {"ring_gqa_attention": 0, "ring_gqa_attention_int8": 0,
            "ring_gqa_attention_enc": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def is_packed(k_ring, kv_heads: int, head_dim: int, kv_packed=None) -> bool:
    """Whether the ring is int4-packed: a half-width ring is (the layout
    admits no other). An explicit `kv_packed` that contradicts the ring
    width is a layout bug and raises."""
    half_lane = k_ring.shape[-1] * 2 == kv_heads * head_dim
    if kv_packed is not None and kv_packed != half_lane:
        raise ValueError(
            f"kv_packed={kv_packed} but ring lane width {k_ring.shape[-1]} "
            f"vs kv_dim {kv_heads * head_dim} implies packed={half_lane}")
    return half_lane


def ring_gqa_attention_reference(q, k_ring, v_ring, slot_pos, q_pos, *,
                                 window: int, heads: int, kv_heads: int,
                                 head_dim: int, k_scale=None, v_scale=None,
                                 extra_k=None, extra_v=None, extra_pos=None,
                                 n_valid_slots=None, kv_packed=None):
    """Plain version of the fused ring attention. q: [B, S, heads*hd];
    k_ring/v_ring: [B, P, kv_heads*hd] (float, or int8 codes with
    k_scale/v_scale [B, kv_heads, P] f32; int4-packed [B, P, kv_heads*hd/2]
    with scales); slot_pos: [B, P] int (negative = invalid); q_pos: [B, S];
    extra_k/v: [B, Sx, kv_heads*hd] float with extra_pos [B, Sx];
    n_valid_slots: only slots below it are read. Returns [B, S, heads*hd]
    in q.dtype."""
    b, s, qd = q.shape
    p = k_ring.shape[1]
    g = heads // kv_heads
    hh = head_dim // 2
    mxu = q.dtype
    packed = is_packed(k_ring, kv_heads, head_dim, kv_packed)
    qh = q.reshape(b, s, kv_heads, g, head_dim).permute(0, 2, 3, 1, 4).float()

    def rows(k, pack):      # -> [B, Hkv, T, hd] f32 in q's dtype, or halves
        if pack:
            halves = unpack_int4(k.reshape(b, -1, kv_heads, hh))
            return tuple(x.to(mxu).float().permute(0, 2, 1, 3) for x in halves)
        return (k.to(mxu).float().reshape(b, -1, kv_heads, head_dim)
                .permute(0, 2, 1, 3))

    def kq(k):                                   # -> [B, Hkv, g, S, T] f32
        if isinstance(k, tuple):                 # two half-width dots
            lo, hi = (x.transpose(-1, -2)[:, :, None] for x in k)
            return (torch.matmul(qh[..., :hh], lo)
                    + torch.matmul(qh[..., hh:], hi))
        return torch.matmul(qh, k.transpose(-1, -2)[:, :, None])

    def pv(e, v):                                # -> [B, Hkv, g, S, hd] f32
        e = e.to(mxu).float()
        if isinstance(v, tuple):                 # halves back in lane order
            return torch.cat([torch.matmul(e, x[:, :, None]) for x in v], -1)
        return torch.matmul(e, v[:, :, None])

    qp = torch.as_tensor(q_pos, device=q.device).reshape(b, s).long()
    lo = qp - (window - 1)

    def mask_of(pos):                            # [B, T] -> [B, 1, 1, S, T]
        pos = pos.long()[:, None, :]
        m = (pos >= 0) & (pos <= qp[:, :, None]) & (pos >= lo[:, :, None])
        return m[:, None, None]

    def per_slot(sc):                            # [B, Hkv, P] -> [B,Hkv,1,1,P]
        return sc.float()[:, :, None, None, :]

    mask = mask_of(slot_pos)
    if n_valid_slots is not None:
        nv = torch.as_tensor(n_valid_slots, device=q.device)
        mask = mask & (torch.arange(p, device=q.device) < nv)
    scale = 1.0 / math.sqrt(head_dim)
    s1 = kq(rows(k_ring, packed)) * scale
    if k_scale is not None:
        s1 = s1 * per_slot(k_scale)
    s1 = torch.where(mask, s1, _NEG)
    m = s1.amax(-1, keepdim=True)
    has_extra = extra_k is not None and extra_k.shape[1] > 0
    if has_extra:
        x_mask = mask_of(extra_pos)
        s2 = torch.where(x_mask, kq(rows(extra_k, False)) * scale, _NEG)
        m = torch.maximum(m, s2.amax(-1, keepdim=True))
    m = torch.clamp(m, min=_NEG / 2)             # fully-masked row guard
    e1 = torch.where(mask, torch.exp(s1 - m), 0.0)
    denom = e1.sum(-1, keepdim=True)
    if has_extra:
        e2 = torch.where(x_mask, torch.exp(s2 - m), 0.0)
        denom = denom + e2.sum(-1, keepdim=True)
    if v_scale is not None:
        e1 = e1 * per_slot(v_scale)
    o = pv(e1, rows(v_ring, packed))
    if has_extra:
        o = o + pv(e2, rows(extra_v, False))
    o = o / torch.clamp(denom, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, qd).to(q.dtype)


def _check_supported(q, k_ring, v_ring, slot_pos, *, heads, kv_heads,
                     head_dim, k_scale, v_scale, extra_k, extra_v, extra_pos,
                     kv_packed) -> tuple[str, int]:
    """Validate a call; return the kernel that takes it (a LAUNCHES key)
    and the ring layout the kernels are told (0 float, 1 int8 with scales,
    2 int4-packed with scales)."""
    b, s, qd = q.shape
    if heads % kv_heads or qd != heads * head_dim:
        raise ValueError(f"q width {qd} does not match heads={heads}, "
                         f"kv_heads={kv_heads}, head_dim={head_dim}")
    packed = is_packed(k_ring, kv_heads, head_dim, kv_packed)
    scaled = k_scale is not None
    if scaled != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    if packed and not scaled:
        raise ValueError("int4-packed rings require scales")
    p = k_ring.shape[1]
    if scaled:
        if k_ring.dtype != torch.int8 or v_ring.dtype != torch.int8:
            raise ValueError(f"rings with scales must be int8 codes; got "
                             f"{k_ring.dtype}, {v_ring.dtype}")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (b, kv_heads, p):
                raise ValueError(f"scales must be f32 [B, Hkv, P] = "
                                 f"{(b, kv_heads, p)}; got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    kernel = ("ring_gqa_attention_enc" if s > 1 or packed else
              "ring_gqa_attention_int8" if scaled else "ring_gqa_attention")
    floats = [q] + ([] if scaled else [k_ring, v_ring])
    if extra_k is not None:
        floats += [extra_k, extra_v]
        if kernel != "ring_gqa_attention_enc" and extra_k.shape[1] > _SPLIT_SLOTS:
            raise ValueError(f"{extra_k.shape[1]} extra columns > {_SPLIT_SLOTS}")
        if extra_pos is None or extra_pos.shape != extra_k.shape[:2]:
            raise ValueError("extra_pos must be [B, Sx]")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in floats):
        raise ValueError(
            "q, float rings and extra columns must share one dtype, float32 "
            f"or bfloat16; got {[t.dtype for t in floats]}")
    ring_w = kv_heads * head_dim // (2 if packed else 1)
    if k_ring.shape != v_ring.shape or k_ring.shape[0] != b \
            or k_ring.shape[-1] != ring_w or slot_pos.shape != k_ring.shape[:2]:
        raise ValueError(f"ring shapes {tuple(k_ring.shape)}, "
                         f"{tuple(v_ring.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)} do not match q {tuple(q.shape)}")
    return kernel, 2 if packed else 1 if scaled else 0


@functools.lru_cache(maxsize=None)
def _lib(source: str):
    from voxtral_tpu_torch import _build
    lib = _build.load(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if source == "ring_attention.cu":
        fn = lib.ring_gqa_attention_launch
        fn.argtypes = [ci, ci, ci] + [vp] * 15 + [ci] * 6 + [ctypes.c_float, vp]
    else:
        fn = lib.ring_gqa_attention_enc_launch
        fn.argtypes = [ci, ci, ci] + [vp] * 12 + [ci] * 7 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


def _launch(q, k_ring, v_ring, slot_pos, q_pos, *, kernel, ring_kind, window,
            heads, kv_heads, head_dim, k_scale, v_scale, extra_k, extra_v,
            extra_pos, n_valid_slots):
    """Launch `kernel` (a LAUNCHES key) on CUDA tensors with rings of
    layout `ring_kind` (see `_check_supported`); raises on what the kernels
    do not take."""
    if head_dim not in _HEAD_DIMS[kernel]:
        raise ValueError(f"head_dim {head_dim}: the {kernel} kernel is built "
                         f"for {_HEAD_DIMS[kernel]}")
    dev = q.device
    b, s, _ = q.shape
    p = k_ring.shape[1]
    i32 = torch.int32
    sp = slot_pos.to(i32).contiguous()
    qp = torch.as_tensor(q_pos, device=dev).reshape(b, s).to(i32).contiguous()
    if n_valid_slots is None:
        n_valid_slots = p
    nv = torch.as_tensor(n_valid_slots, device=dev).to(i32).reshape(())
    sx = 0 if extra_k is None else extra_k.shape[1]
    data = [q, k_ring, v_ring] + ([extra_k, extra_v] if sx else [])
    tables = [sp, qp, nv]
    if k_scale is not None:
        tables += [k_scale, v_scale]
    if sx:
        xp = extra_pos.to(i32).contiguous()
        tables.append(xp)
    for t in data + tables:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("ring attention kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in data):
        raise ValueError("ring attention kernel needs 16-byte aligned tensors")
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    scale = 1.0 / math.sqrt(head_dim)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    if kernel == "ring_gqa_attention_enc":
        err = _lib("ring_attention_enc.cu")(
            _DTYPE_CODES[q.dtype], ring_kind, head_dim, q.data_ptr(),
            k_ring.data_ptr(), v_ring.data_ptr(), ptr(k_scale), ptr(v_scale),
            sp.data_ptr(), qp.data_ptr(), ptr(extra_k) if sx else None,
            ptr(extra_v) if sx else None, xp.data_ptr() if sx else None,
            nv.data_ptr(), out.data_ptr(), b, s, p, sx, heads, kv_heads,
            window, scale, stream)
    else:
        n_parts = -(-p // _SPLIT_SLOTS) + 1
        o_part = torch.empty((b, heads, n_parts, head_dim), dtype=torch.float32,
                             device=dev)
        m_part = torch.empty((b, heads, n_parts), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        err = _lib("ring_attention.cu")(
            _DTYPE_CODES[q.dtype], ring_kind, head_dim, q.data_ptr(),
            k_ring.data_ptr(), v_ring.data_ptr(), ptr(k_scale), ptr(v_scale),
            sp.data_ptr(), qp.data_ptr(), ptr(extra_k) if sx else None,
            ptr(extra_v) if sx else None, xp.data_ptr() if sx else None,
            nv.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), out.data_ptr(), b, p, sx, heads, kv_heads,
            window, scale, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out


def ring_gqa_attention(q, k_ring, v_ring, slot_pos, q_pos, *, window: int,
                       heads: int, kv_heads: int, head_dim: int,
                       k_scale=None, v_scale=None, extra_k=None, extra_v=None,
                       extra_pos=None, n_valid_slots=None, kv_packed=None):
    """Fused ring attention; see the module docstring. Arguments follow the
    JAX package's `ring_gqa_attention`, with `n_valid_slots` (int or device
    scalar) in place of `p_limit`."""
    kernel, ring_kind = _check_supported(
        q, k_ring, v_ring, slot_pos, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, k_scale=k_scale, v_scale=v_scale, extra_k=extra_k,
        extra_v=extra_v, extra_pos=extra_pos, kv_packed=kv_packed)
    kw = dict(window=window, heads=heads, kv_heads=kv_heads,
              head_dim=head_dim, k_scale=k_scale, v_scale=v_scale,
              extra_k=extra_k, extra_v=extra_v, extra_pos=extra_pos,
              n_valid_slots=n_valid_slots)
    if q.device.type == "cpu":
        return ring_gqa_attention_reference(q, k_ring, v_ring, slot_pos,
                                            q_pos, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_ring, v_ring, slot_pos, q_pos, kernel=kernel,
                   ring_kind=ring_kind, **kw)


def ring_attention(q, k_ring, v_ring, slot_pos, q_pos, *, window: int,
                   heads: int, kv_heads: int, head_dim: int, k_scale=None,
                   v_scale=None, extra_kv=None, n_valid_slots=None):
    """Entry point used by the decoder and the incremental encoder.
    extra_kv: optional (xk, xv, xp); n_valid_slots: bound on the ring slots
    that can hold valid entries (slots beyond it MUST be invalid)."""
    xk = xv = xp = None
    if extra_kv is not None:
        xk, xv, xp = extra_kv
    return ring_gqa_attention(
        q, k_ring, v_ring, slot_pos, q_pos, window=window, heads=heads,
        kv_heads=kv_heads, head_dim=head_dim, k_scale=k_scale,
        v_scale=v_scale, extra_k=xk, extra_v=xv, extra_pos=xp,
        n_valid_slots=n_valid_slots)
