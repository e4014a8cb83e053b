"""The port's ring attention (voxtral_tpu_torch/ops/ring_attention.py) against
the JAX package's Pallas kernel run in interpret mode — float rings, int8
rings with scales, int4-packed rings, S = 1 and S > 1 — and the wrapper's
routing and refusals. The CUDA kernels themselves run only on the card
(chip_smoke.py holds them against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.pallas_attention import ring_attention as jax_ring_attention
from voxtral_tpu.ops.pallas_attention import ring_gqa_attention as jax_ring_gqa
from voxtral_tpu_torch.ops import ring_attention as ra
from voxtral_tpu_torch.quant import quantize_kv, quantize_kv_int4

torch.set_num_threads(2)

SLOT_INVALID = -(1 << 30)


def _mk_ring(rng, b, p, hkv, hd, last_pos):
    k = (rng.randn(b, p, hkv * hd) * 0.3).astype(np.float32)
    v = (rng.randn(b, p, hkv * hd) * 0.3).astype(np.float32)
    j = np.arange(p)
    sp = last_pos - np.mod(last_pos - j, p)
    sp = np.where(sp < 0, SLOT_INVALID, sp)
    return k, v, np.ascontiguousarray(np.broadcast_to(sp, (b, p))).astype(np.int32)


def _mk_prefix_ring(rng, b, p, hkv, hd, n_valid):
    k = (rng.randn(b, p, hkv * hd) * 0.3).astype(np.float32)
    v = (rng.randn(b, p, hkv * hd) * 0.3).astype(np.float32)
    sp = np.where(np.arange(p) < n_valid, np.arange(p), SLOT_INVALID)
    return k, v, np.ascontiguousarray(np.broadcast_to(sp, (b, p))).astype(np.int32)


def _both(q, k, v, sp, qp, *, window, h, hkv, hd, extra=None, p_limit=None,
          q_dtype=np.float32, ring_dtype=np.float32, scales=None, fn=None):
    """(port, Pallas interpret) outputs as f32 numpy. k/v are float rings,
    or int8 codes (int4-packed when half width) with scales = (ks, vs)
    [B, hkv, P] f32. fn: the port function (default: the plain version)."""
    jdt = {np.float32: jnp.float32, "bf16": jnp.bfloat16}
    tdt = {np.float32: torch.float32, "bf16": torch.bfloat16}
    jx = {} if extra is None else dict(
        extra_k=jnp.asarray(extra[0], jdt[q_dtype]),
        extra_v=jnp.asarray(extra[1], jdt[q_dtype]), extra_pos=jnp.asarray(extra[2]))
    tx = {} if extra is None else dict(
        extra_k=torch.from_numpy(extra[0]).to(tdt[q_dtype]),
        extra_v=torch.from_numpy(extra[1]).to(tdt[q_dtype]),
        extra_pos=torch.from_numpy(extra[2]))
    if scales is not None:
        jx.update(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
        tx.update(k_scale=torch.from_numpy(scales[0]),
                  v_scale=torch.from_numpy(scales[1]))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        jk, jv = jnp.asarray(k, jdt[ring_dtype]), jnp.asarray(v, jdt[ring_dtype])
        tk = torch.from_numpy(k).to(tdt[ring_dtype])
        tv = torch.from_numpy(v).to(tdt[ring_dtype])
    ref = jax_ring_gqa(
        jnp.asarray(q, jdt[q_dtype]), jk, jv, jnp.asarray(sp), jnp.asarray(qp),
        window=window, heads=h, kv_heads=hkv, head_dim=hd, p_limit=p_limit,
        interpret=True, **jx)
    out = (fn or ra.ring_gqa_attention_reference)(
        torch.from_numpy(q).to(tdt[q_dtype]), tk, tv, torch.from_numpy(sp),
        torch.from_numpy(qp), window=window, heads=h, kv_heads=hkv,
        head_dim=hd, n_valid_slots=p_limit, **tx)
    return out.float().numpy(), np.asarray(ref, np.float32)


def _quantized(k, hkv, hd, int4=False):
    """Float ring [B, P, hkv*hd] -> (codes, scales) numpy via the port's
    quantizers (bit-identical to the JAX package's, tests/test_torch_quant.py)."""
    codes, scales = (quantize_kv_int4 if int4 else quantize_kv)(
        torch.from_numpy(k), hkv, hd)
    return codes.numpy(), scales.numpy()


_CASES = {"decode_gqa": (2, 1, 8, 2, 128, 96, 48, 8),
          "encoder_mha": (2, 8, 4, 4, 64, 96, 48, 8)}    # b, s, h, hkv, hd, p, window, sx


def _quant_case(case, int4, seed=5):
    """Inputs of tests/test_pallas_attention.py's int8/int4 kernel tests:
    a wrapped ring of quantized codes plus float extra columns."""
    rng = np.random.RandomState(seed)
    b, s, h, hkv, hd, p, window, sx = _CASES[case]
    last = 80
    kf, vf, sp = _mk_ring(rng, b, p, hkv, hd, last)
    (kq, ks), (vq, vs) = _quantized(kf, hkv, hd, int4), _quantized(vf, hkv, hd, int4)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([np.arange(s) + last + 1 + sx for _ in range(b)]).astype(np.int32)
    xk = (rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32)
    xv = (rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32)
    xp = np.stack([last + 1 + np.arange(sx) for _ in range(b)]).astype(np.int32)
    return (q, kq, vq, sp, qp), dict(window=window, h=h, hkv=hkv, hd=hd,
                                     extra=(xk, xv, xp), scales=(ks, vs))


@pytest.mark.parametrize("wrap", [False, True])
def test_reference_matches_pallas_decode_gqa(wrap):
    rng = np.random.RandomState(42)
    b, s, h, hkv, hd, p, window = 3, 1, 8, 2, 128, 96, 48
    last = 200 if wrap else 40
    k, v, sp = _mk_ring(rng, b, p, hkv, hd, last)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([np.arange(s) + last + 1 + i for i in range(b)]).astype(np.int32)
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 8])
def test_reference_matches_pallas_extra_kv(s):
    rng = np.random.RandomState(7)
    b, h, hkv, hd, p, window, sx = 2, 8, 2, 128, 96, 48, 8
    last = 63
    k, v, sp = _mk_ring(rng, b, p, hkv, hd, last)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([np.arange(s) + last + 1 + sx for _ in range(b)]).astype(np.int32)
    xk = (rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32)
    xv = (rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32)
    xp = np.stack([last + 1 + np.arange(sx) for _ in range(b)]).astype(np.int32)
    xp[:, -2:] = SLOT_INVALID
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd,
                     extra=(xk, xv, xp))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_reference_fully_masked_rows_are_zero():
    rng = np.random.RandomState(3)
    b, s, h, hkv, hd, p, window = 1, 4, 2, 2, 64, 32, 16
    k, v, sp = _mk_ring(rng, b, p, hkv, hd, last_pos=10)
    q = rng.randn(b, s, h * hd).astype(np.float32)
    qp = np.full((b, s), SLOT_INVALID, np.int32)
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd)
    np.testing.assert_array_equal(out, 0.0)
    np.testing.assert_array_equal(ref, 0.0)


@pytest.mark.parametrize("q_dtype,tol", [(np.float32, 1e-5), ("bf16", 1e-2)])
def test_reference_bf16_ring(q_dtype, tol):
    """bf16 rings with f32 queries (all f32 after the widening: 1e-5), and
    with bf16 queries (probabilities rounded to bf16 before PV in both)."""
    rng = np.random.RandomState(11)
    b, s, h, hkv, hd, p, window = 2, 1, 8, 2, 128, 64, 32
    k, v, sp = _mk_ring(rng, b, p, hkv, hd, last_pos=50)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.full((b, s), 51, np.int32)
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd,
                     q_dtype=q_dtype, ring_dtype="bf16")
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("p_limit", [32, 64, 96])
def test_reference_n_valid_matches_p_limit(p_limit):
    """A read bound at or past the valid prefix changes nothing, in the
    port (n_valid_slots) as in the Pallas kernel (p_limit)."""
    rng = np.random.RandomState(11)
    b, s, h, hkv, hd, p, window = 2, 1, 8, 2, 128, 96, 200
    nv = 30
    k, v, sp = _mk_prefix_ring(rng, b, p, hkv, hd, nv)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([np.arange(s) + nv for _ in range(b)]).astype(np.int32)
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd,
                     p_limit=p_limit)
    full, _ = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, full, rtol=1e-5, atol=1e-5)


def test_reference_n_valid_hides_slots_past_the_bound():
    """Slots at or past n_valid_slots are not read even if their positions
    are valid, as the Pallas kernel's p_limit does not DMA them."""
    rng = np.random.RandomState(12)
    b, s, h, hkv, hd, p, window = 1, 1, 4, 2, 64, 64, 200
    k, v, sp = _mk_prefix_ring(rng, b, p, hkv, hd, p)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.full((b, s), p, np.int32)
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=hkv, hd=hd,
                     p_limit=32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    sp_cut = sp.copy()
    sp_cut[:, 32:] = SLOT_INVALID
    cut, _ = _both(q, k, v, sp_cut, qp, window=window, h=h, hkv=hkv, hd=hd)
    np.testing.assert_allclose(out, cut, rtol=1e-6, atol=1e-6)


def _decode_inputs(seed=5, dtype=torch.float32, b=2, p=96, h=8, hkv=2, hd=64,
                   sx=8):
    rng = np.random.RandomState(seed)
    k, v, sp = _mk_ring(rng, b, p, hkv, hd, last_pos=80)
    t = lambda a: torch.from_numpy(a).to(dtype)   # noqa: E731
    q = t((rng.randn(b, 1, h * hd) * 0.3).astype(np.float32))
    xk = t((rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32))
    xv = t((rng.randn(b, sx, hkv * hd) * 0.3).astype(np.float32))
    xp = torch.from_numpy(np.stack([81 + np.arange(sx)] * b).astype(np.int32))
    qp = torch.full((b, 1), 81 + sx - 1, dtype=torch.int32)
    kw = dict(window=48, heads=h, kv_heads=hkv, head_dim=hd)
    return (q, t(k), t(v), torch.from_numpy(sp), qp), kw, (xk, xv, xp)


def test_wrapper_on_cpu_is_the_reference_and_launches_nothing():
    args, kw, (xk, xv, xp) = _decode_inputs()
    before = dict(ra.LAUNCHES)
    out = ra.ring_gqa_attention(*args, **kw, extra_k=xk, extra_v=xv,
                                extra_pos=xp, n_valid_slots=torch.tensor(90))
    ref = ra.ring_gqa_attention_reference(*args, **kw, extra_k=xk, extra_v=xv,
                                          extra_pos=xp, n_valid_slots=90)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert ra.LAUNCHES == before


def test_dispatcher_matches_jax_ring_attention():
    """The decoder's entry point against the JAX package's on the CPU (there
    the XLA oracle), extra columns and a read bound included."""
    args, kw, (xk, xv, xp) = _decode_inputs(seed=9)
    out = ra.ring_attention(*args, **kw, extra_kv=(xk, xv, xp),
                            n_valid_slots=torch.tensor(96, dtype=torch.int32))
    j = [jnp.asarray(a.numpy()) for a in args]
    ref = jax_ring_attention(*j, **kw, extra_kv=tuple(
        jnp.asarray(a.numpy()) for a in (xk, xv, xp)), n_valid_slots=96)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_scales():
    """Well-formed int8 rings with scales go through the wrapper (on the CPU,
    its plain version) and equal the interpret-mode kernel; malformed scale
    arguments are refused."""
    args, kw = _quant_case("decode_gqa", int4=False)
    out, ref = _both(*args, **kw, fn=ra.ring_gqa_attention)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    q, kq, vq, sp, qp = (torch.from_numpy(a) for a in args)
    ks, vs = (torch.from_numpy(a) for a in kw["scales"])
    tkw = dict(window=kw["window"], heads=kw["h"], kv_heads=kw["hkv"],
               head_dim=kw["hd"])
    with pytest.raises(ValueError, match="come together"):
        ra.ring_gqa_attention(q, kq, vq, sp, qp, **tkw, k_scale=ks)
    with pytest.raises(ValueError, match="must be int8"):
        ra.ring_gqa_attention(q, kq.float(), vq.float(), sp, qp, **tkw,
                              k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="scales must be f32"):
        ra.ring_attention(q, kq, vq, sp, qp, **tkw, k_scale=ks[:, :1],
                          v_scale=vs[:, :1])
    with pytest.raises(ValueError, match="dtype"):
        ra.ring_gqa_attention(q, kq, vq, sp, qp, **tkw)   # int8 codes, no scales


def test_wrapper_refuses_packed_rings():
    """int4-packed rings with scales go through the wrapper and equal the
    interpret-mode kernel; packed rings without scales, and a kv_packed that
    contradicts the ring width, are refused."""
    args, kw = _quant_case("encoder_mha", int4=True)
    out, ref = _both(*args, **kw, fn=ra.ring_gqa_attention)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    q, kq, vq, sp, qp = (torch.from_numpy(a) for a in args)
    tkw = dict(window=kw["window"], heads=kw["h"], kv_heads=kw["hkv"],
               head_dim=kw["hd"])
    with pytest.raises(ValueError, match="int4-packed rings require scales"):
        ra.ring_gqa_attention(q, kq, vq, sp, qp, **tkw)
    args, kw, _ = _decode_inputs()
    with pytest.raises(ValueError, match="kv_packed"):
        ra.ring_gqa_attention(*args, **kw, kv_packed=True)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("case", ["decode_gqa", "encoder_mha"])
def test_kernel_quantized_ring_matches_pallas(case, int4):
    """Mirror of tests/test_pallas_attention.py's int8 and int4 kernel
    tests: the port's plain version on the same codes and scales equals the
    interpret-mode kernel (scores scaled per column, the V scale folded into
    the probabilities after the denominator, two half-width dots for packed
    rings)."""
    args, kw = _quant_case(case, int4)
    out, ref = _both(*args, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["decode_gqa", "encoder_mha"])
@pytest.mark.parametrize("p_limit", [32, 64, 96, 1024])
def test_kernel_p_limit_with_scales_matches_pallas(case, p_limit):
    """Mirror of test_kernel_p_limit_matches_full_read, with int8 rings: a
    read bound at or past the valid prefix changes nothing, and the port's
    n_valid_slots equals the kernel's p_limit."""
    rng = np.random.RandomState(11)
    b, s, h, hkv, hd, p, _, _ = _CASES[case]
    nv = 30
    k, v, sp = _mk_prefix_ring(rng, b, p, hkv, hd, nv)
    (kq, ks), (vq, vs) = _quantized(k, hkv, hd), _quantized(v, hkv, hd)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([np.arange(s) + nv for _ in range(b)]).astype(np.int32)
    kw = dict(window=200, h=h, hkv=hkv, hd=hd, scales=(ks, vs))
    out, ref = _both(q, kq, vq, sp, qp, **kw, p_limit=p_limit)
    full, _ = _both(q, kq, vq, sp, qp, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, full, rtol=1e-5, atol=1e-5)


def test_kv_packed_ring_width_mismatch_raises():
    """Mirror of the JAX test: an explicit kv_packed that contradicts the
    ring width fails loudly, in the plain version and the wrapper."""
    rng = np.random.RandomState(9)
    b, s, h, hkv, hd, p = 1, 1, 4, 2, 64, 96
    q = torch.from_numpy(rng.randn(b, s, h * hd).astype(np.float32))
    sp = torch.zeros((b, p), dtype=torch.int32)
    qp = torch.ones((b, s), dtype=torch.int32)
    scales = torch.ones((b, hkv, p))
    kw = dict(window=48, heads=h, kv_heads=hkv, head_dim=hd, k_scale=scales,
              v_scale=scales)
    half = torch.zeros((b, p, hkv * hd // 2), dtype=torch.int8)
    full = torch.zeros((b, p, hkv * hd), dtype=torch.int8)
    for fn in (ra.ring_gqa_attention, ra.ring_gqa_attention_reference):
        with pytest.raises(ValueError, match="kv_packed"):
            fn(q, half, half, sp, qp, **kw, kv_packed=False)
        with pytest.raises(ValueError, match="kv_packed"):
            fn(q, full, full, sp, qp, **kw, kv_packed=True)


@pytest.mark.parametrize("ring_dtype", [np.float32, "bf16"])
def test_encoder_mha_extra_columns_match_pallas(ring_dtype):
    """The encoder regime on float rings: S = 16 queries per stream, MHA,
    head_dim 64, a wrapped ring and the chunk's own K/V as causally masked
    extra columns (some invalid), with a read bound; bf16 rings with f32
    queries widen exactly, so both cases hold at 1e-5."""
    rng = np.random.RandomState(21)
    b, s, h, hd, p, window, sx = 2, 16, 4, 64, 64, 40, 16
    last = 150
    k, v, sp = _mk_ring(rng, b, p, h, hd, last)
    q = (rng.randn(b, s, h * hd) * 0.3).astype(np.float32)
    qp = np.stack([last + 1 + np.arange(s)] * b).astype(np.int32)
    xk = (rng.randn(b, sx, h * hd) * 0.3).astype(np.float32)
    xv = (rng.randn(b, sx, h * hd) * 0.3).astype(np.float32)
    xp = qp.copy()
    xp[1, 10:] = SLOT_INVALID                  # stream 1: a shorter chunk
    out, ref = _both(q, k, v, sp, qp, window=window, h=h, hkv=h, hd=hd,
                     extra=(xk, xv, xp), p_limit=56, ring_dtype=ring_dtype)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_routes_each_mode_to_its_kernel():
    """Which kernel a call would launch on the card (and count in LAUNCHES):
    S = 1 float rings -> K1, S = 1 int8 rings -> K1-int8, S > 1 or packed
    rings -> K1-enc."""
    args, kw, (xk, xv, xp) = _decode_inputs()
    q, k, v, sp, qp = args
    b, p = sp.shape
    sc = torch.ones((b, kw["kv_heads"], p))
    codes = torch.zeros(k.shape, dtype=torch.int8)
    packed = torch.zeros(k.shape[:2] + (k.shape[2] // 2,), dtype=torch.int8)
    common = dict(heads=kw["heads"], kv_heads=kw["kv_heads"], head_dim=kw["head_dim"],
                  extra_k=xk, extra_v=xv, extra_pos=xp, kv_packed=None)
    none = dict(k_scale=None, v_scale=None)
    scaled = dict(k_scale=sc, v_scale=sc)
    route = ra._check_supported              # -> (kernel, ring layout)
    assert route(q, k, v, sp, **common, **none) == ("ring_gqa_attention", 0)
    assert route(q, codes, codes, sp, **common,
                 **scaled) == ("ring_gqa_attention_int8", 1)
    assert route(q, packed, packed, sp, **common,
                 **scaled) == ("ring_gqa_attention_enc", 2)
    assert route(q.repeat(1, 3, 1), k, v, sp, **common,
                 **none) == ("ring_gqa_attention_enc", 0)
    assert route(q.repeat(1, 3, 1), codes, codes, sp, **common,
                 **scaled) == ("ring_gqa_attention_enc", 1)
    many = xk.repeat(1, 40, 1)                 # only the decode kernels cap Sx
    assert route(q.repeat(1, 3, 1), k, v, sp, **{**common, "extra_k": many,
                 "extra_v": many, "extra_pos": xp.repeat(1, 40)},
                 **none) == ("ring_gqa_attention_enc", 0)


def test_wrapper_refuses_other_modes():
    args, kw, (xk, xv, xp) = _decode_inputs()
    q, k, v, sp, qp = args
    # S = 2 queries per stream: the encoder regime, equal to the kernel
    rng = np.random.RandomState(4)
    q2 = (rng.randn(2, 2, kw["heads"] * kw["head_dim"]) * 0.3).astype(np.float32)
    qp2 = np.stack([[80, 81]] * 2).astype(np.int32)
    out, ref = _both(q2, k.numpy(), v.numpy(), sp.numpy(), qp2,
                     window=kw["window"], h=kw["heads"], hkv=kw["kv_heads"],
                     hd=kw["head_dim"], fn=ra.ring_gqa_attention)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dtype"):
        ra.ring_gqa_attention(q.bfloat16(), k, v, sp, qp, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        ra.ring_gqa_attention(q, k, v, sp, qp, **{**kw, "head_dim": 48,
                                                  "heads": 8 * 64 // 48})
    # head_dim 16 (same widths: 32 query heads over 8 kv heads): the plain
    # version takes it on the CPU; the kernels' launch refuses it before
    # touching the card, and K1-enc refuses head_dim 128
    kw16 = {**kw, "head_dim": 16, "heads": 32, "kv_heads": 8}
    ref = ra.ring_gqa_attention_reference(*args, **kw16)
    torch.testing.assert_close(ra.ring_gqa_attention(*args, **kw16), ref,
                               rtol=0, atol=0)
    none = dict(k_scale=None, v_scale=None, extra_k=None, extra_v=None,
                extra_pos=None, n_valid_slots=None)
    with pytest.raises(ValueError, match="head_dim 16: the ring_gqa_attention kernel"):
        ra._launch(*args, **kw16, **none, kernel="ring_gqa_attention",
                   ring_kind=0)
    with pytest.raises(ValueError, match="head_dim 128: the ring_gqa_attention_enc"):
        ra._launch(*args, **{**kw, "head_dim": 128, "heads": 4, "kv_heads": 1},
                   **none, kernel="ring_gqa_attention_enc", ring_kind=0)
    many = xk.repeat(1, 40, 1)
    with pytest.raises(ValueError, match="extra columns"):
        ra.ring_gqa_attention(*args, **kw, extra_k=many, extra_v=many,
                              extra_pos=xp.repeat(1, 40))
