"""The rounding of the decode kernels' tensor-core route
(csrc/ring_attention.cu, ring_dec_mma_kernel: bf16 q on int8 rings, K1-int8,
and on bf16 float rings, K1), emulated in plain torch, against the JAX
package's Pallas kernel run in interpret mode; and the wrapper's
pure-Python route rule for both (ops/ring_attention.dec_plan) with its
refusals. The kernel itself runs only on the card (chip_smoke.py holds it
against the plain version there, at the same 2e-2 of max|ref| this file
uses)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.pallas_attention import ring_gqa_attention as jax_ring_gqa
from voxtral_tpu_torch.ops import ring_attention as ra
from voxtral_tpu_torch.quant import quantize_kv

torch.set_num_threads(2)

SLOT_INVALID = -(1 << 30)
TILE, WARPS = 16, 4              # = kTile, kWarps: slots per warp tile, warps per block
SPLIT = ra._SPLIT_SLOTS           # = kSplit: ring slots per split
LOG2E = 1.4426950408889634
# decode: one query per stream, GQA group 4, hd 128; a wrapped ring of 600
# slots read below nv = 530 (three splits, the last 18 slots: not a multiple
# of the tile), a window that masks the ring's oldest positions; stream 2's
# query position is invalid (a fully masked stream)
B, H, HKV, HD, P, NV, WINDOW = 3, 8, 2, 128, 600, 530, 500
G = H // HKV
RTOL = 2e-2                       # chip_smoke.py's bf16 ring tolerance (of max|ref|)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _warp_partials(q, qp, cols):
    """One block of the route: its columns (k, v, pos, ks, vs; k and v as
    code or bf16 values) cut into 16-column tiles, tile i to warp i % 4; per
    warp an online softmax in base 2 whose probabilities are rounded to bf16
    against each head's running max, O in f32 rescaled per tile; then the
    warps' merge in warp order. q [G, hd]. Returns the block's (m, l, o)."""
    k, v, pos, ks, vs = cols
    lo = qp - (WINDOW - 1)
    scale_l2 = (1.0 / math.sqrt(HD)) * LOG2E
    warps = []
    for w in range(WARPS):
        m = torch.full((G, 1), -5e29)
        l = torch.zeros((G, 1))
        o = torch.zeros((G, HD))
        for t0 in range(w * TILE, len(pos), WARPS * TILE):
            c = slice(t0, t0 + TILE)
            x = (q @ k[c].T) * (scale_l2 * ks[c])
            ok = (pos[c] >= 0) & (pos[c] <= qp) & (pos[c] >= lo)
            x = torch.where(ok[None, :], x, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            e = torch.exp2(x - m_new)
            l = l * alpha + e.sum(-1, keepdim=True)
            o = o * alpha + _bf16(e * vs[c]) @ v[c]
            m = m_new
        warps.append((m, l, o))
    return _merge(warps)


def _merge(parts):
    """Partials (m, l, o) merged in order, base 2, the max floored at -5e29."""
    mx = torch.stack([torch.full_like(parts[0][0], -5e29)] + [p[0] for p in parts]).amax(0)
    den = sum(torch.exp2(m - mx) * l for m, l, _ in parts)
    acc = sum(torch.exp2(m - mx) * o for m, _, o in parts)
    return mx, den, acc


def _emulate(q, qp, ring, extra):
    """The route for one (stream, kv head): `ring` (codes, v codes, pos, ks,
    vs) below nv cut into 256-slot splits, one block each, then the extra
    columns (bf16 values, unit scales) as one more block, the splits merged
    in order and scaled by the reciprocal of their sum. A stream whose query
    position is invalid writes neutral partials. Returns [G, hd] bf16
    values as f32."""
    if qp < 0:
        return torch.zeros((G, HD))
    blocks = [tuple(x[s0:s0 + SPLIT] for x in ring) for s0 in range(0, len(ring[2]), SPLIT)]
    if extra is not None:
        blocks.append(extra)
    _, den, acc = _merge([_warp_partials(q, qp, cols) for cols in blocks])
    return _bf16(acc * (1.0 / torch.clamp(den, min=1e-30)))


def _case(sx, seed, ring="int8"):
    """bf16 q, int8 rings with scales (the port's quantizer) or bf16 float
    rings (`ring`), whose slots below NV hold a ring of NV positions that
    has wrapped (two invalid), sx bf16 extra columns (the decode chunk's
    own: one invalid, the last one past the query), stream 2's query
    position invalid. Float rings come with unit scales for the emulation
    (the Pallas kernel gets none)."""
    rng = np.random.RandomState(seed)
    last = 1000
    j = np.arange(P)
    sp = np.where(j < NV, last - np.mod(last - j, NV), SLOT_INVALID)
    sp = np.ascontiguousarray(np.broadcast_to(sp, (B, P))).astype(np.int32).copy()
    sp[:, 3] = sp[:, NV // 2] = SLOT_INVALID
    q = _bf16(torch.from_numpy((rng.randn(B, 1, H * HD) * 0.5).astype(np.float32)))
    qp = np.full((B, 1), last + max(sx - 1, 0), dtype=np.int32)
    qp[2] = SLOT_INVALID
    k, v = (torch.from_numpy((rng.randn(B, P, HKV * HD) * 0.5).astype(np.float32))
            for _ in range(2))
    if ring == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k, HKV, HD), quantize_kv(v, HKV, HD)
    else:
        kq, vq = _bf16(k), _bf16(v)
        ks = vs = torch.ones((B, HKV, P))
    extra = None
    if sx:
        xk, xv = (_bf16(torch.from_numpy((rng.randn(B, sx, HKV * HD) * 0.5).astype(np.float32)))
                  for _ in range(2))
        xp = (last + 1 + np.arange(sx, dtype=np.int32))[None].repeat(B, 0)
        xp[:, 1] = SLOT_INVALID
        extra = (xk, xv, xp)
    return q, (kq, vq), (ks, vs), sp, qp, extra


def _pallas(q, rings, scales, sp, qp, extra, ring="int8"):
    kw = {}
    if ring == "int8":
        kw = dict(k_scale=jnp.asarray(scales[0].numpy()), v_scale=jnp.asarray(scales[1].numpy()))
        kr, vr = (jnp.asarray(r.numpy()) for r in rings)
    else:
        kr, vr = (jnp.asarray(r.numpy()).astype(jnp.bfloat16) for r in rings)
    if extra is not None:
        kw.update(extra_k=jnp.asarray(extra[0].numpy()).astype(jnp.bfloat16),
                  extra_v=jnp.asarray(extra[1].numpy()).astype(jnp.bfloat16),
                  extra_pos=jnp.asarray(extra[2]))
    out = jax_ring_gqa(
        jnp.asarray(q.numpy()).astype(jnp.bfloat16), kr, vr, jnp.asarray(sp), jnp.asarray(qp),
        window=WINDOW, heads=H, kv_heads=HKV, head_dim=HD, p_limit=NV, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("ring", ["int8", "float"])
@pytest.mark.parametrize("sx", [0, 5])
def test_tensor_core_rounding_matches_pallas(sx, ring):
    """The emulated tile order and rounding (per-warp running max, e * vs
    rounded to bf16, the warp merge, then the split merge) land within
    chip_smoke.py's bf16 tolerance of the Pallas kernel (which rounds
    against the row's global max), on int8 rings and on bf16 float rings
    (unit scales); the fully masked stream is 0."""
    q, rings, scales, sp, qp, extra = _case(sx, 10 + sx, ring)
    ref = _pallas(q, rings, scales, sp, qp, extra, ring)
    out = np.zeros_like(ref)
    for b in range(B):
        for h in range(HKV):
            cols = slice(h * HD, (h + 1) * HD)
            ring = (rings[0][b, :NV, cols].float(), rings[1][b, :NV, cols].float(),
                    torch.from_numpy(sp[b, :NV]).long(), scales[0][b, h, :NV],
                    scales[1][b, h, :NV])
            ext = None
            if extra is not None:
                ext = (extra[0][b, :, cols], extra[1][b, :, cols],
                       torch.from_numpy(extra[2][b]).long(), torch.ones(sx), torch.ones(sx))
            qh = q[b, 0, h * G * HD:(h + 1) * G * HD].reshape(G, HD)
            got = _emulate(qh, int(qp[b, 0]), ring, ext)
            out[b, 0, h * G * HD:(h + 1) * G * HD] = got.reshape(-1).numpy()
    err = np.abs(out - ref).max()
    assert err <= RTOL * np.abs(ref).max(), (err, np.abs(ref).max())
    assert (out[2] == 0).all() and (ref[2] == 0).all()


def test_dec_plan_routes_by_dtype_with_a_fixed_split():
    """bf16 takes the tensor cores on float and int8 rings, f32 the CUDA
    cores; the split is one constant, a multiple of the 4 warps' 16-slot
    tiles, whatever the head counts (the fleet's 32/8, a TP rank's 16/4
    and 4/1, the hd-64 check shape 16/2) and the extra width; the plan has
    no B or SM count to follow, so a rank's heads split the ring as the
    whole call does."""
    assert SPLIT % (TILE * WARPS) == 0
    for ring in ("float", "int8"):
        for heads, kv_heads, hd in ((32, 8, 128), (16, 4, 128), (4, 1, 128), (16, 2, 64)):
            for sx in (0, 20, 256):
                assert ra.dec_plan(torch.bfloat16, heads, kv_heads, hd, sx, ring) == (
                    "tensor_cores", SPLIT)
                assert ra.dec_plan(torch.float32, heads, kv_heads, hd, sx, ring) == (
                    "cuda_cores", SPLIT)
        # the CUDA cores take any group (blocks of 4 query heads)
        assert ra.dec_plan(torch.float32, 32, 1, 128, 20, ring) == ("cuda_cores", SPLIT)
    # a bf16 group above 8 on float rings: the CUDA cores, by the plan
    for heads, kv_heads in ((32, 2, ), (16, 1), (18, 2)):
        assert ra.dec_plan(torch.bfloat16, heads, kv_heads, 128, 20, "float") == (
            "cuda_cores", SPLIT)


@pytest.mark.parametrize("dtype,heads,kv_heads,hd,sx,ring,match", [
    (torch.float16, 32, 8, 128, 20, "int8", "f32 or bf16"),
    (torch.bfloat16, 24, 8, 96, 20, "int8", "head_dim 96"),
    (torch.float32, 32, 8, 32, 20, "int8", "head_dim 32"),
    (torch.bfloat16, 32, 8, 128, 257, "int8", "257 extra columns"),
    (torch.bfloat16, 32, 2, 128, 20, "int8", "at most 8"),
    (torch.bfloat16, 30, 4, 128, 20, "int8", "group 30/4"),
    (torch.float16, 32, 8, 128, 20, "float", "f32 or bf16"),
    (torch.bfloat16, 24, 8, 96, 20, "float", "head_dim 96"),
    (torch.bfloat16, 32, 8, 128, 257, "float", "257 extra columns"),
    (torch.bfloat16, 30, 4, 128, 20, "float", "group 30/4"),
    (torch.bfloat16, 32, 8, 128, 20, "int4", "ring kind 'int4'"),
])
def test_dec_plan_refusals(dtype, heads, kv_heads, hd, sx, ring, match):
    with pytest.raises(ValueError, match=match):
        ra.dec_plan(dtype, heads, kv_heads, hd, sx, ring)


def test_k1int8_launch_consults_the_plan_before_the_card():
    """The wrapper's launch asks dec_plan before any device work: a bf16
    call whose group the tensor cores do not take (16 query heads per kv
    head) is refused; it never falls back to the CUDA-core kernel or the
    plain version."""
    b, p, hd = 1, 32, 128
    codes = torch.zeros((b, p, hd), dtype=torch.int8)
    sc = torch.ones((b, 1, p))
    with pytest.raises(ValueError, match="at most 8"):
        ra._launch(torch.zeros((b, 1, 16 * hd), dtype=torch.bfloat16), codes, codes,
                   torch.zeros((b, p), dtype=torch.int32), torch.zeros((b, 1), dtype=torch.int32),
                   kernel="ring_gqa_attention_int8", ring_kind=1, window=64, heads=16,
                   kv_heads=1, head_dim=hd, k_scale=sc, v_scale=sc, extra_k=None,
                   extra_v=None, extra_pos=None, n_valid_slots=None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_launch_consults_the_plan_before_the_card(monkeypatch, dtype):
    """K1's launch (float rings) asks dec_plan, with the ring kind "float",
    before any device work: on CPU tensors the plan's answer is all that
    happens, and a call the plan refuses (257 extra columns) raises before
    the card."""
    b, p, hd, sx = 1, 32, 128, 3
    ring = torch.zeros((b, p, 2 * hd), dtype=dtype)
    extra = torch.zeros((b, sx, 2 * hd), dtype=dtype)
    args = (torch.zeros((b, 1, 8 * hd), dtype=dtype), ring, ring,
            torch.zeros((b, p), dtype=torch.int32), torch.zeros((b, 1), dtype=torch.int32))
    kw = dict(kernel="ring_gqa_attention", ring_kind=0, window=64, heads=8, kv_heads=2,
              head_dim=hd, k_scale=None, v_scale=None, extra_k=extra, extra_v=extra,
              extra_pos=torch.zeros((b, sx), dtype=torch.int32), n_valid_slots=None)
    asked = []

    class Planned(Exception):
        pass

    def plan(*a):
        asked.append(a)
        raise Planned

    monkeypatch.setattr(ra, "dec_plan", plan)
    with pytest.raises(Planned):
        ra._launch(*args, **kw)
    assert asked == [(dtype, 8, 2, hd, sx, "float")]
    monkeypatch.undo()
    wide = torch.zeros((b, 257, 2 * hd), dtype=dtype)
    with pytest.raises(ValueError, match="257 extra columns"):
        ra._launch(*args, **dict(kw, extra_k=wide, extra_v=wide,
                                 extra_pos=torch.zeros((b, 257), dtype=torch.int32)))
