"""K4, the port's RMSNorm (voxtral_tpu_torch.ops.norms), against the JAX
package's `rms_norm` on the same seeded inputs, on the CPU: the wrapper's
plain route, the plan that fixes the kernel's reduction order (no row
count), a numpy emulation of that order, and the refusals. The kernel
itself runs on the card (chip_smoke.py phase 1 and 10b)."""

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from voxtral_tpu.ops import norms as jnorms
from voxtral_tpu_torch.ops import norms

torch.set_num_threads(2)

EPS = 1e-5
WIDTHS = (1280, 3072, 24)                 # encoder, decoder, a tiny width
DTYPES = {"f32": (torch.float32, np.float32, jnp.float32),
          "bf16": (torch.bfloat16, ml_dtypes.bfloat16, jnp.bfloat16)}


def _inputs(shape, x_kind, w_kind, seed):
    """(x, w) as numpy arrays in the given dtypes: x N(0, 1) * 3, w 1 +
    N(0, 0.1), drawn in f32 and rounded."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32).astype(DTYPES[x_kind][1])
    w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32).astype(DTYPES[w_kind][1])
    return x, w


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _jax_stat(x):
    """JAX's f32 statistic rsqrt(mean(x^2) + eps) per row."""
    xf = jnp.asarray(x).astype(jnp.float32)
    return np.asarray(jax.lax.rsqrt(jnp.mean(xf * xf, -1) + EPS))


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 24), (2, 3, 1280)])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_wrapper_on_cpu_is_the_plain_version(shape, kind):
    """A CPU tensor takes rms_norm_plain, bit for bit, and launches nothing."""
    x, w = (_torch(a) for a in _inputs(shape, kind, "f32", 1))
    before = dict(norms.LAUNCHES)
    out = norms.rms_norm(x, w, EPS)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, norms.rms_norm_plain(x, w, EPS))
    assert norms.LAUNCHES == before


@pytest.mark.parametrize("rank3", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("w_kind", ["f32", "bf16"])
@pytest.mark.parametrize("x_kind", ["f32", "bf16"])
def test_matches_jax(x_kind, w_kind, d, rank3):
    """f32 within 1e-6 relative; bf16 within one bf16 ulp, and exact on
    every row whose f32 statistic has JAX's bits."""
    shape = (2, 3, d) if rank3 else (6, d)
    x, w = _inputs(shape, x_kind, w_kind, seed=d + 7 * rank3)
    out = norms.rms_norm(_torch(x), _torch(w), EPS)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), EPS)
    assert out.dtype == DTYPES[x_kind][0] and out.shape == shape
    got, want = _f32(out), _f32(ref)
    if x_kind == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        return
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    xf = _torch(x).float()
    stat = torch.rsqrt(torch.mean(xf * xf, -1) + EPS).numpy()
    same = stat == _jax_stat(x)
    assert same.any()
    np.testing.assert_array_equal(got[same], want[same])


def test_k4_plan_takes_no_row_count():
    """The plan's arguments are the width and the dtype alone; it covers
    the row with whole warps, 16-byte vectors where the width allows them
    and scalars where it does not, and refuses what the kernel cannot take."""
    assert list(inspect.signature(norms.k4_plan).parameters) == ["d", "dtype"]
    for d in (*WIDTHS, 1, 100, 1001, 4096, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            p = norms.k4_plan(d, dtype)
            wide = 16 // dtype.itemsize
            assert p.vec == (wide if d % wide == 0 else 1)
            assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
            assert p.threads * norms.MAX_VECS * p.vec >= d     # the row is covered
    assert norms.k4_plan(3072, torch.bfloat16) == (8, 192)
    assert norms.k4_plan(1280, torch.bfloat16) == (8, 96)
    with pytest.raises(ValueError, match="f32 or bf16"):
        norms.k4_plan(64, torch.float16)
    with pytest.raises(ValueError, match="exceeds"):
        norms.k4_plan(4097, torch.float32)          # scalar path: 1024 x 4 elements
    with pytest.raises(ValueError, match="width"):
        norms.k4_plan(0, torch.float32)


def _fma(a, b, c):
    """f32 fma: the exact a * b (f64 holds it) plus c, rounded once to f32
    (through f64; a double rounding is rare and within the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def k4_emulate(x, w, eps=EPS):
    """K4's arithmetic in its order (csrc/rms_norm.cu), from k4_plan: thread
    t sums the squares of its vectors t + j * threads, element by element,
    by fma; each warp's xor tree (16, 8, 4, 2, 1); the warps' sums in warp
    order; r = 1 / sqrt(sum / D + eps); (x * r) * w, rounded to x's dtype.
    Every row alike, so rows never see each other."""
    rows, d = x.shape
    x_dtype = torch.bfloat16 if x.dtype == ml_dtypes.bfloat16 else torch.float32
    p = norms.k4_plan(d, x_dtype)
    xf, wf = x.astype(np.float32), w.astype(np.float32)
    acc = np.zeros((rows, p.threads), np.float32)
    for j in range(norms.MAX_VECS):
        c = np.arange(p.threads) + j * p.threads
        live = c < d // p.vec
        for e in range(p.vec):
            v = xf[:, c[live] * p.vec + e]
            acc[:, live] = _fma(v, v, acc[:, live])
    lanes = acc.reshape(rows, p.threads // 32, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    total = np.zeros(rows, np.float32)
    for i in range(p.threads // 32):
        total = total + lanes[:, i, 0]
    r = np.float32(1) / np.sqrt(total / np.float32(d) + np.float32(eps))
    return ((xf * r[:, None]) * wf).astype(x.dtype)


@pytest.mark.parametrize("d", WIDTHS + (100,))
@pytest.mark.parametrize("x_kind", ["f32", "bf16"])
def test_k4_order_matches_jax_and_ignores_the_row_count(x_kind, d):
    """The emulated order is within the f32 tolerance of JAX (one bf16 ulp
    for bf16 rows), and a row has the same bits in a call of 1, 8, 16 or
    all 1280 rows."""
    x, w = _inputs((1280, d), x_kind, "f32", seed=3 * d)
    full = k4_emulate(x, w)
    want = _f32(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), EPS))
    if x_kind == "f32":
        np.testing.assert_allclose(full, want, rtol=1e-6, atol=0)
    else:
        assert np.all(np.abs(_f32(full) - want) <= _bf16_ulp(want))
    for n in (1, 8, 16):
        for lo in (0, 640 - n, 1280 - n):
            part = k4_emulate(x[lo:lo + n], w)
            np.testing.assert_array_equal(part.view(np.uint8), full[lo:lo + n].view(np.uint8))


def test_kernel_entry_refuses_cpu_and_other_devices():
    """Nothing runs K4's arithmetic on the CPU unasked: the kernel entry
    refuses a CPU tensor, and the wrapper refuses a device that is neither
    the CPU nor CUDA."""
    x, w = torch.ones(2, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        norms.rms_norm_kernel(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        norms.rms_norm(x.to("meta"), w.to("meta"))
