"""The port's ring attention (voxtral_tpu_torch/ops/ring_attention.py) against
the JAX package's Pallas kernel run in interpret mode, and the CUDA wrapper's
refusals. The CUDA kernel itself runs only on the card (chip_smoke.py holds
it against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.ops.pallas_attention import ring_attention as jax_ring_attention
from voxtral_tpu.ops.pallas_attention import ring_gqa_attention as jax_ring_gqa
from voxtral_tpu_torch.ops import ring_attention as ra

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
          q_dtype=np.float32, ring_dtype=np.float32):
    """(port reference, Pallas interpret) outputs as f32 numpy."""
    jdt = {np.float32: jnp.float32, "bf16": jnp.bfloat16}
    tdt = {np.float32: torch.float32, "bf16": torch.bfloat16}
    jx = {} if extra is None else dict(
        extra_k=jnp.asarray(extra[0]), extra_v=jnp.asarray(extra[1]),
        extra_pos=jnp.asarray(extra[2]))
    tx = {} if extra is None else dict(
        extra_k=torch.from_numpy(extra[0]), extra_v=torch.from_numpy(extra[1]),
        extra_pos=torch.from_numpy(extra[2]))
    ref = jax_ring_gqa(
        jnp.asarray(q, jdt[q_dtype]), jnp.asarray(k, jdt[ring_dtype]),
        jnp.asarray(v, jdt[ring_dtype]), jnp.asarray(sp), jnp.asarray(qp),
        window=window, heads=h, kv_heads=hkv, head_dim=hd, p_limit=p_limit,
        interpret=True, **jx)
    out = ra.ring_gqa_attention_reference(
        torch.from_numpy(q).to(tdt[q_dtype]),
        torch.from_numpy(k).to(tdt[ring_dtype]),
        torch.from_numpy(v).to(tdt[ring_dtype]), torch.from_numpy(sp),
        torch.from_numpy(qp), window=window, heads=h, kv_heads=hkv,
        head_dim=hd, n_valid_slots=p_limit, **tx)
    return out.float().numpy(), np.asarray(ref, np.float32)


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
    before = ra.ring_gqa_attention.launches
    out = ra.ring_gqa_attention(*args, **kw, extra_k=xk, extra_v=xv,
                                extra_pos=xp, n_valid_slots=torch.tensor(90))
    ref = ra.ring_gqa_attention_reference(*args, **kw, extra_k=xk, extra_v=xv,
                                          extra_pos=xp, n_valid_slots=90)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert ra.ring_gqa_attention.launches == before


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
    args, kw, _ = _decode_inputs()
    b, p = args[3].shape
    scales = torch.ones((b, kw["kv_heads"], p))
    with pytest.raises(NotImplementedError, match="fleet slice"):
        ra.ring_gqa_attention(*args, **kw, k_scale=scales, v_scale=scales)
    with pytest.raises(NotImplementedError, match="fleet slice"):
        ra.ring_attention(*args, **kw, k_scale=scales, v_scale=scales)


def test_wrapper_refuses_packed_rings():
    args, kw, _ = _decode_inputs()
    q, k, v, sp, qp = args
    half = torch.zeros(k.shape[:2] + (k.shape[2] // 2,), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int4"):
        ra.ring_gqa_attention(q, half, half, sp, qp, **kw)
    with pytest.raises(NotImplementedError, match="int4"):
        ra.ring_gqa_attention(*args, **kw, kv_packed=True)


def test_wrapper_refuses_other_modes():
    args, kw, (xk, xv, xp) = _decode_inputs()
    q, k, v, sp, qp = args
    with pytest.raises(NotImplementedError, match="S = 2"):
        ra.ring_gqa_attention(q.repeat(1, 2, 1), k, v, sp, qp.repeat(1, 2), **kw)
    with pytest.raises(ValueError, match="dtype"):
        ra.ring_gqa_attention(q.bfloat16(), k, v, sp, qp, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        ra.ring_gqa_attention(q, k, v, sp, qp, **{**kw, "head_dim": 48,
                                                  "heads": 8 * 64 // 48})
    # head_dim 16 (same widths: 32 query heads over 8 kv heads): the plain
    # version takes it on the CPU; the kernel's launch refuses it before
    # touching the card
    kw16 = {**kw, "head_dim": 16, "heads": 32, "kv_heads": 8}
    ref = ra.ring_gqa_attention_reference(*args, **kw16)
    torch.testing.assert_close(ra.ring_gqa_attention(*args, **kw16), ref,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="head_dim 16: the kernel is built"):
        ra._launch(*args, **kw16, extra_k=None, extra_v=None, extra_pos=None,
                   n_valid_slots=None)
    many = xk.repeat(1, 40, 1)
    with pytest.raises(ValueError, match="extra columns"):
        ra.ring_gqa_attention(*args, **kw, extra_k=many, extra_v=many,
                              extra_pos=xp.repeat(1, 40))
