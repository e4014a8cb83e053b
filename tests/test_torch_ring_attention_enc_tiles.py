"""The rounding of K1-enc's tensor-core route (csrc/ring_attention_enc.cu,
bf16 q), emulated in plain torch, against the JAX package's Pallas kernel
run in interpret mode; and the wrappers' pure-Python route and size rules
for K1-enc (ops/ring_attention.enc_plan) and K3 (ops/logits_argmax.k3_plan),
with their refusals. The kernels themselves run only on the card
(chip_smoke.py holds them against the plain versions there, at the same
2e-2 of max|ref| this file uses)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.pallas_attention import ring_gqa_attention as jax_ring_gqa
from voxtral_tpu_torch.ops import logits_argmax as la
from voxtral_tpu_torch.ops import ring_attention as ra
from voxtral_tpu_torch.quant import quantize_kv, quantize_kv_int4, unpack_int4

torch.set_num_threads(2)

SLOT_INVALID = -(1 << 30)
TILE = 32                     # = kTile, ring slots / extra columns per tile
LOG2E = 1.4426950408889634
# encoder-like: hd 64, S 80 queries and 80 extra columns, MHA, a wrapped
# ring of 200 slots read below nv = 190, a window that masks its oldest slots
B, S, H, HD, P, NV, WINDOW, SX = 2, 80, 2, 64, 200, 190, 150, 80
RTOL = 2e-2                   # chip_smoke.py's bf16 ring tolerance (of max|ref|)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, q_pos, tiles, splits):
    """The tensor-core route's arithmetic for one (stream, kv head) and all
    its query rows. q [R, hd] bf16 values, q_pos [R]; `tiles`: the kernel's
    tiles in order (ring slots [32 t, 32 t + 32) below nv, empty past it,
    then the extra columns 32 at a time), each (k, v, pos, ks, vs) with k/v
    as bf16-valued rows in lane order (int4: low nibbles in lanes [0, 32),
    high ones in [32, 64)) and scales 1 for the extra columns. The tiles
    are split over `splits` blocks as the kernel splits them; per split an
    online softmax in base 2 whose probabilities are rounded to bf16
    against the running max, O in f32 rescaled per tile; then the splits'
    merge. Returns [R, hd] bf16 values as f32."""
    per = -(-len(tiles) // splits)
    r = q.shape[0]
    lo = q_pos - (WINDOW - 1)
    scale_l2 = (1.0 / math.sqrt(HD)) * LOG2E
    parts = []
    for sp in range(splits):
        m = torch.full((r, 1), -5e29)
        l = torch.zeros((r, 1))
        o = torch.zeros((r, HD))
        for k, v, pos, ks, vs in tiles[sp * per:sp * per + per]:
            if not len(pos):                       # past nv: never read
                continue
            x = (q @ k.T) * (scale_l2 * ks)
            p = pos[None, :]
            ok = (p >= 0) & (p <= q_pos[:, None]) & (p >= lo[:, None])
            x = torch.where(ok, x, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            e = torch.exp2(x - m_new)
            l = l * alpha + e.sum(-1, keepdim=True)
            o = o * alpha + _bf16(e * vs) @ v
            m = m_new
        parts.append((m, l, o))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    den = sum(torch.exp2(m - mx) * l for m, l, _ in parts)
    acc = sum(torch.exp2(m - mx) * o for m, _, o in parts)
    return _bf16(acc / torch.clamp(den, min=1e-30))


def _case(ring, seed):
    """bf16 q, a wrapped ring of `ring` codes ("float": bf16 rows), float
    extra columns (the chunk's own, causally placed; stream 1's last ten
    invalid), the last query row of stream 0 fully masked."""
    rng = np.random.RandomState(seed)
    last = 400
    k = (rng.randn(B, P, H * HD) * 0.5).astype(np.float32)
    v = (rng.randn(B, P, H * HD) * 0.5).astype(np.float32)
    j = np.arange(P)
    sp = np.where(j < NV, last - np.mod(last - j, NV), SLOT_INVALID)
    sp = np.ascontiguousarray(np.broadcast_to(sp, (B, P))).astype(np.int32).copy()
    sp[:, 3] = SLOT_INVALID
    q = _bf16(torch.from_numpy((rng.randn(B, S, H * HD) * 0.5).astype(np.float32)))
    qp = np.stack([last + 1 + np.arange(S)] * B).astype(np.int32)
    qp[0, -1] = SLOT_INVALID
    xk = _bf16(torch.from_numpy((rng.randn(B, SX, H * HD) * 0.5).astype(np.float32)))
    xv = _bf16(torch.from_numpy((rng.randn(B, SX, H * HD) * 0.5).astype(np.float32)))
    xp = qp.copy()
    xp[0, -1] = last + S
    xp[1, -10:] = SLOT_INVALID
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if ring == "float":
        rings, scales = (kt.bfloat16(), vt.bfloat16()), None
    else:
        qf = quantize_kv_int4 if ring == "int4" else quantize_kv
        (kq, kss), (vq, vss) = qf(kt, H, HD), qf(vt, H, HD)
        rings, scales = (kq, vq), (kss, vss)
    return q, rings, scales, sp, qp, (xk, xv, xp)


def _pallas(q, rings, scales, sp, qp, extra):
    kw = {} if scales is None else dict(k_scale=jnp.asarray(scales[0].numpy()),
                                        v_scale=jnp.asarray(scales[1].numpy()))
    jr = [jnp.asarray(r.float().numpy()).astype(jnp.bfloat16) if scales is None
          else jnp.asarray(r.numpy()) for r in rings]
    out = jax_ring_gqa(
        jnp.asarray(q.numpy()).astype(jnp.bfloat16), *jr, jnp.asarray(sp), jnp.asarray(qp),
        window=WINDOW, heads=H, kv_heads=H, head_dim=HD, p_limit=NV, interpret=True,
        extra_k=jnp.asarray(extra[0].numpy()).astype(jnp.bfloat16),
        extra_v=jnp.asarray(extra[1].numpy()).astype(jnp.bfloat16),
        extra_pos=jnp.asarray(extra[2]), **kw)
    return np.asarray(out.astype(jnp.float32))


def _rows(ring, codes, b, h):
    """Ring slots below NV of kv head h, stream b, as bf16-valued f32 rows
    in lane order."""
    if ring == "float":
        return codes[b, :NV, h * HD:(h + 1) * HD].float()
    if ring == "int4":
        lo, hi = unpack_int4(codes[b, :NV].reshape(NV, H, HD // 2))
        return torch.cat([lo, hi], -1)[:, h].float()
    return codes[b, :NV, h * HD:(h + 1) * HD].float()


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("ring", ["float", "int8", "int4"])
def test_tensor_core_rounding_matches_pallas(ring, splits):
    """The emulated tile order and rounding land within chip_smoke.py's
    bf16 tolerance of the Pallas kernel (which rounds against the row's
    global max), whole or split over blocks; the fully masked row is 0."""
    q, rings, scales, sp, qp, extra = _case(ring, seed={"float": 1, "int8": 2, "int4": 3}[ring])
    ref = _pallas(q, rings, scales, sp, qp, extra)
    xk, xv, xp = extra
    out = np.zeros_like(ref)
    for b in range(B):
        for h in range(H):
            cols = slice(h * HD, (h + 1) * HD)
            k, v = _rows(ring, rings[0], b, h), _rows(ring, rings[1], b, h)
            pos = torch.from_numpy(sp[b, :NV]).long()
            ks = vs = torch.ones(NV)
            if scales is not None:
                ks, vs = scales[0][b, h, :NV], scales[1][b, h, :NV]
            tiles = [(k[c], v[c], pos[c], ks[c], vs[c])
                     for c in (slice(t, t + TILE) for t in range(0, P, TILE))]
            xpos = torch.from_numpy(xp[b]).long()
            tiles += [(xk[b, c, cols], xv[b, c, cols], xpos[c], 1.0, 1.0)
                      for c in (slice(t, t + TILE) for t in range(0, SX, TILE))]
            got = _emulate(q[b, :, cols], torch.from_numpy(qp[b]).long(), tiles, splits)
            out[b, :, cols] = got.numpy()
    err = np.abs(out - ref).max()
    assert err <= RTOL * np.abs(ref).max(), (err, np.abs(ref).max())
    assert (out[0, -1] == 0).all() and (ref[0, -1] == 0).all()


def test_enc_plan_routes_by_dtype():
    """bf16 takes the tensor cores, f32 the CUDA cores (never split); the
    fleet's B = 16 fills 132 SMs unsplit, B = 1 and 2 split, a TP rank's B
    = 8 on half the heads does not (so its heads compute what the whole
    call's do), other dtypes are refused."""
    enc = dict(kv_heads=32, p=928, sx=80, sms=132)
    assert ra.enc_plan(torch.bfloat16, 16, **enc) == ("tensor_cores", 1)
    assert ra.enc_plan(torch.float32, 1, **enc) == ("cuda_cores", 1)
    assert ra.enc_plan(torch.bfloat16, 1, **enc) == ("tensor_cores", 8)
    assert ra.enc_plan(torch.bfloat16, 16, **{**enc, "kv_heads": 16}) == ("tensor_cores", 1)
    assert ra.enc_plan(torch.bfloat16, 2, **enc)[1] > 1
    assert ra.enc_plan(torch.bfloat16, 8, **{**enc, "kv_heads": 16}) == ("tensor_cores", 1)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ra.enc_plan(torch.float16, 1, **enc)


@pytest.mark.parametrize("b,hkv,p,sx,sms", [(1, 32, 928, 80, 132), (2, 32, 928, 80, 132),
                                            (1, 32, 65, 0, 132), (3, 2, 64, 1, 132),
                                            (1, 1, 8320, 20, 132), (5, 4, 200, 80, 16)])
def test_enc_plan_splits_leave_no_split_empty(b, hkv, p, sx, sms):
    """The kernel gives each split ceil(tiles / splits) tiles and refuses a
    launch with an empty split: the plan never asks for one, and asks for
    at most about two blocks per SM."""
    tiles = -(-p // TILE) + -(-sx // TILE)
    _, splits = ra.enc_plan(torch.bfloat16, b, hkv, p, sx, sms)
    per = -(-tiles // splits)
    assert 1 <= splits <= tiles and (splits - 1) * per < tiles
    assert splits == 1 or b * hkv * splits <= 2 * sms + b * hkv * per


@pytest.mark.parametrize("b,v", [(1, 131072), (5, 4096 + 37), (9, 4096 + 37), (16, 131072),
                                 (17, 4133), (32, 131072), (3, 1000)])
def test_k3_plan_scratch_sizes(b, v):
    """Grid and argmax scratch of both routes at ragged B and V: the
    tensor cores take one block per SM (fewer for a table of fewer 16-row
    tiles), the CUDA cores one per 512 rows; the partials hold 16 entries
    per block and grid.y row."""
    d, sms = 3072, 132
    rows = -(-b // 16)
    for table, h in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                     (torch.int8, torch.bfloat16)):
        route, blocks, n_part = la.k3_plan(table, h, b, v, d, sms)
        assert route == "tensor_cores"
        assert blocks == min(sms, -(-v // 16)) and n_part == blocks * rows * 16
    for table, h in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                     (torch.int8, torch.float32)):
        route, blocks, n_part = la.k3_plan(table, h, b, v, d, sms)
        assert route == "cuda_cores"
        assert blocks == -(-v // 512) and n_part == blocks * rows * 16


def test_k3_plan_refuses_h_beyond_shared_memory():
    """h lives in shared memory on the tensor cores: D = 3072 fits at 16
    streams, a D whose fragments leave no room for two stages is refused
    (the CUDA-core route stages h in passes and takes any D)."""
    assert la.k3_plan(torch.bfloat16, torch.bfloat16, 16, 1024, 3072, 132)[0] == "tensor_cores"
    with pytest.raises(ValueError, match="shared memory"):
        la.k3_plan(torch.bfloat16, torch.bfloat16, 16, 1024, 8192, 132)
    assert la.k3_plan(torch.float32, torch.float32, 16, 1024, 8192, 132)[0] == "cuda_cores"


def test_k1enc_refusals():
    """Mixed dtypes are refused before any device work, and K1-enc's
    launch refuses a head_dim other than 64 before touching the card."""
    q, rings, scales, sp, qp, (xk, xv, xp) = _case("int8", 4)
    kw = dict(window=WINDOW, heads=H, kv_heads=H, head_dim=HD, k_scale=scales[0],
              v_scale=scales[1], extra_pos=torch.from_numpy(xp))
    args = (q.bfloat16(), *rings, torch.from_numpy(sp), torch.from_numpy(qp))
    with pytest.raises(ValueError, match="share one dtype"):
        ra.ring_gqa_attention(*args, **kw, extra_k=xk.float(), extra_v=xv.float())
    with pytest.raises(ValueError, match="share one dtype"):
        ra.ring_gqa_attention(q.half(), *args[1:], **kw, extra_k=xk.half(), extra_v=xv.half())
    none = dict(k_scale=None, v_scale=None, extra_k=None, extra_v=None, extra_pos=None,
                n_valid_slots=None)
    for hd in (32, 128):
        with pytest.raises(ValueError, match=f"head_dim {hd}: the ring_gqa_attention_enc"):
            ra._launch(q.bfloat16(), *[r.float().bfloat16() for r in rings], torch.from_numpy(sp),
                       torch.from_numpy(qp), window=WINDOW, heads=H * HD // hd,
                       kv_heads=H * HD // hd, head_dim=hd, **none,
                       kernel="ring_gqa_attention_enc", ring_kind=0)


def test_k3_refuses_cpu_tensors():
    """fused_logits_argmax is the card's entry point: CPU tensors are
    refused there (the model's entry points take the plain version for
    them, tests/test_torch_logits_argmax.py)."""
    h = torch.zeros((2, 32), dtype=torch.bfloat16)
    table = torch.zeros((64, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        la.fused_logits_argmax(h, table)
