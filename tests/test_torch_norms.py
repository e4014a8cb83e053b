"""K4, the port's RMSNorm (voxtral_tpu_torch.ops.norms), against the JAX
package's `rms_norm` on the same seeded inputs, on the CPU: the wrapper's
plain route, the plan that fixes the kernel's reduction order (no row
count), a numpy emulation of that order, and the refusals; the same for
the fused entry `add_rms_norm` (residual add, norm, ada scale) against the
JAX chain `h + d`, `rms_norm`, `* (1 + ada)`, and the calls the models
make per token step and per chunk. The kernel itself runs on the card
(chip_smoke.py phase 1 and 10b)."""

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


def _add_inputs(shape, kind, seed):
    """(h, delta, w, ada) as numpy arrays: h and w as `_inputs` (w f32, the
    model's norm weights), delta N(0, 1) in h's dtype (a sublayer's
    output), ada N(0, 0.1) f32 (the decoder's t_ada row)."""
    h, w = _inputs(shape, kind, "f32", seed)
    rng = np.random.RandomState(seed + 1)
    delta = rng.randn(*shape).astype(np.float32).astype(DTYPES[kind][1])
    ada = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return h, delta, w, ada


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


def k4_add_emulate(h, delta, w, scale=None, eps=EPS):
    """K4's fused entry: h_new = h + delta (f32 add, rounded to h's dtype)
    element by element, then `k4_emulate`'s order on h_new; with a scale,
    the norm output (already in h's dtype) times the scale in f32, rounded
    again. Returns (h_new, x)."""
    h_new = (h.astype(np.float32) + delta.astype(np.float32)).astype(h.dtype)
    x = k4_emulate(h_new, w, eps)
    if scale is not None:
        x = (x.astype(np.float32) * scale.astype(np.float32)).astype(h.dtype)
    return h_new, x


def _scale_row(ada, kind):
    """The decoder's ada row: cast to the activation dtype, then 1 added
    in that dtype (models/decoder.py)."""
    return 1.0 + _torch(ada).to(DTYPES[kind][0])


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("rank3", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_add_wrapper_on_cpu_is_the_unfused_chain(kind, d, rank3, scaled):
    """A CPU tensor takes add_rms_norm_plain: h + delta, rms_norm_plain,
    * scale, bit for bit in both outputs, and launches nothing."""
    shape = (2, 3, d) if rank3 else (6, d)
    h, delta, w, ada = (_torch(a) for a in _add_inputs(shape, kind, d + 11 * rank3))
    scale = _scale_row(ada.numpy(), kind) if scaled else None
    before = dict(norms.LAUNCHES)
    h_new, x = norms.add_rms_norm(h, delta, w, EPS, scale)
    want_h = h + delta
    want_x = norms.rms_norm_plain(want_h, w, EPS)
    if scaled:
        want_x = want_x * scale
    for got, want in ((h_new, want_h), (x, want_x)):
        assert got.dtype == h.dtype and got.shape == h.shape
        assert torch.equal(got, want)
    assert norms.LAUNCHES == before


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("rank3", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_add_matches_jax_chain(kind, d, rank3, scaled):
    """Against the JAX chain `h + d`, `jnorms.rms_norm`, `* (1 + ada)`:
    h_new exact; x in f32 within 1e-6 relative; in bf16 exact on every row
    whose f32 statistic has JAX's bits, elsewhere within one bf16 ulp of
    the norm's output, and with the scale within that ulp times |scale|
    plus one ulp of the product (each side rounds the product once)."""
    shape = (2, 3, d) if rank3 else (6, d)
    h, delta, w, ada = _add_inputs(shape, kind, 5 * d + rank3)
    jdt = DTYPES[kind][2]
    scale = _scale_row(ada, kind) if scaled else None
    h_new, x = norms.add_rms_norm(_torch(h), _torch(delta), _torch(w), EPS, scale)
    jh = jnp.asarray(h) + jnp.asarray(delta)
    jnormed = jnorms.rms_norm(jh, jnp.asarray(w), EPS)
    jx = jnormed * (1 + jnp.asarray(ada).astype(jdt)) if scaled else jnormed
    np.testing.assert_array_equal(_f32(h_new), _f32(jh))
    got, want = _f32(x), _f32(jx)
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        return
    tol = _bf16_ulp(_f32(jnormed))
    if scaled:
        tol = tol * np.abs(_f32(scale.float())) + _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= tol)
    hf = h_new.float()
    stat = torch.rsqrt(torch.mean(hf * hf, -1) + EPS).numpy()
    same = stat == _jax_stat(np.asarray(jh))
    assert same.any()
    np.testing.assert_array_equal(got[same], want[same])


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_k4_fused_order_keeps_bits_and_matches_the_chain(kind, scaled):
    """The fused entry's emulated order equals the unfused chain's (the
    add, then K4's order on h_new, then the scale) bit for bit and is within
    the tolerances of test_add_matches_jax_chain of the JAX chain; both
    outputs keep their bits in parts of 1, 8 and 16 rows of 1280."""
    d = 1280
    h, delta, w, ada = _add_inputs((1280, d), kind, 17 + scaled)
    scale = None
    if scaled:
        st = _scale_row(ada, kind)
        scale = st.numpy() if kind == "f32" else \
            st.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    full_h, full_x = k4_add_emulate(h, delta, w, scale)
    chain = k4_emulate(full_h, w)
    if scaled:
        chain = (chain.astype(np.float32) * scale.astype(np.float32)).astype(h.dtype)
    np.testing.assert_array_equal(full_x.view(np.uint8), chain.view(np.uint8))
    jh = jnp.asarray(h) + jnp.asarray(delta)
    jnormed = jnorms.rms_norm(jh, jnp.asarray(w), EPS)
    jx = jnormed * jnp.asarray(scale) if scaled else jnormed
    np.testing.assert_array_equal(_f32(full_h), _f32(jh))
    got, want = _f32(full_x), _f32(jx)
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        tol = _bf16_ulp(_f32(jnormed))
        if scaled:
            tol = tol * np.abs(scale.astype(np.float32)) + _bf16_ulp(want)
        assert np.all(np.abs(got - want) <= tol)
    for n in (1, 8, 16):
        for lo in (0, 640 - n, 1280 - n):
            sl = slice(lo, lo + n)
            part_h, part_x = k4_add_emulate(h[sl], delta[sl], w, scale)
            np.testing.assert_array_equal(part_h.view(np.uint8), full_h[sl].view(np.uint8))
            np.testing.assert_array_equal(part_x.view(np.uint8), full_x[sl].view(np.uint8))


def test_add_entry_refusals():
    """The fused kernel entry refuses a CPU tensor; it and the wrapper
    refuse h and delta of other dtypes or shapes and a scale that is not
    [D] in h's dtype (a call site that relied on type promotion must cast
    first); the wrapper refuses a device that is neither the CPU nor CUDA."""
    h, w = torch.ones(2, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        norms.add_rms_norm_kernel(h, h.clone(), w)
    bad = {"dtype": (h.bfloat16(), None), "shape": (torch.ones(2, 1, 8), None),
           "scale dtype": (h, torch.ones(8, dtype=torch.bfloat16)),
           "scale shape": (h, torch.ones(1, 8)), "scale width": (h, torch.ones(7))}
    for case, (delta, scale) in bad.items():
        for fn in (norms.add_rms_norm, norms.add_rms_norm_kernel):
            with pytest.raises(ValueError, match="add_rms_norm: "):
                fn(h, delta, w, EPS, scale)
    with pytest.raises(ValueError, match="unsupported device"):
        norms.add_rms_norm(h.to("meta"), h.to("meta"), w.to("meta"))


def _count_calls(monkeypatch, module):
    """Wrap `module`'s rms_norm and add_rms_norm with call counters."""
    counts = {"rms_norm": 0, "add_rms_norm": 0}
    for name in counts:
        real = getattr(module, name)

        def counted(*args, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    return counts


def test_models_call_one_plain_norm_a_pass(monkeypatch):
    """At tiny_config on the CPU: every decode_scan token step calls one
    plain rms_norm (layer 0's attn_norm) and 2L add_rms_norm, every
    encoder_incremental chunk and encoder_forward the same, and
    decoder_prefill one plain and 2L - 1 fused per stream (no final norm)."""
    from voxtral_tpu_torch.config import tiny_config
    from voxtral_tpu_torch.models import decoder as tdec
    from voxtral_tpu_torch.models import encoder as tenc
    from voxtral_tpu_torch.weights import random_params
    cfg = tiny_config()
    params = random_params(cfg, seed=3, device="cpu")
    ld, le = cfg.decoder.layers, cfg.encoder.layers
    rng = np.random.RandomState(0)
    b, n = 2, 3
    dec_counts = _count_calls(monkeypatch, tdec)
    t_ada = tdec.ada_scales(params["decoder"], tdec.time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cpu"))
    state = tdec.init_decode_state(cfg, batch=b, device="cpu")
    s = 5
    state = tdec.decoder_prefill(params["decoder"], cfg, state,
                                 torch.from_numpy(rng.randn(b, s, cfg.decoder.dim)
                                                  .astype(np.float32)), t_ada)
    assert dec_counts == {"rms_norm": b, "add_rms_norm": b * (2 * ld - 1)}
    dec_counts.update(rms_norm=0, add_rms_norm=0)
    frames = torch.from_numpy(rng.randn(b, n, cfg.decoder.dim).astype(np.float32))
    tdec.decode_scan(params["decoder"], cfg, state, frames,
                     torch.full((b,), n, dtype=torch.int32), t_ada)
    assert dec_counts == {"rms_norm": n, "add_rms_norm": n * 2 * ld}
    enc_counts = _count_calls(monkeypatch, tenc)
    chunks, rows = 2, 8
    st = tenc.init_encoder_state(cfg, ring_size=48, batch=b, pending_size=rows, device="cpu")
    for _ in range(chunks):
        st, _ = tenc.encoder_incremental(
            params["encoder"], cfg, st,
            torch.from_numpy(rng.randn(b, rows, cfg.encoder.dim).astype(np.float32)))
    assert enc_counts == {"rms_norm": chunks, "add_rms_norm": chunks * 2 * le}
    enc_counts.update(rms_norm=0, add_rms_norm=0)
    tenc.encoder_forward(params["encoder"], cfg,
                         torch.from_numpy(rng.randn(rows, cfg.encoder.dim).astype(np.float32)))
    assert enc_counts == {"rms_norm": 1, "add_rms_norm": 2 * le}


def test_kernel_entry_refuses_cpu_and_other_devices():
    """Nothing runs K4's arithmetic on the CPU unasked: the kernel entry
    refuses a CPU tensor, and the wrapper refuses a device that is neither
    the CPU nor CUDA."""
    x, w = torch.ones(2, 8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        norms.rms_norm_kernel(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        norms.rms_norm(x.to("meta"), w.to("meta"))
