"""The port's Q8 weight path against the JAX package's: the quantizers (bit
for bit, against jitted JAX where XLA compiles them), the Q8 branches of
linear / embed_lookup / embed_logits, the plain version of the W8A16 kernel,
Q8 safetensors files, and the tiny pipeline on Q8 weights (same tokens)."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tools.quantize as qtool
from voxtral_tpu.config import tiny_config as jax_tiny_config
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu.ops import linear as jl
from voxtral_tpu.quant import Quantized as JaxQuantized
from voxtral_tpu.quant import dequantize as jax_dequantize
from voxtral_tpu.quant import quantize_jax, quantize_params as jax_quantize_params
from voxtral_tpu.quant import quantize_np as jax_quantize_np
from voxtral_tpu.weights import load_params as jax_load_params
from voxtral_tpu.weights import params_to_safetensors
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.ops import q8_matmul as qm
from voxtral_tpu_torch.ops.linear import embed_logits, embed_lookup, linear
from voxtral_tpu_torch.quant import (
    Quantized, dequantize, quantize_np, quantize_params, quantize_torch,
)
from voxtral_tpu_torch.tools import profile_k2_variants as k2v
from voxtral_tpu_torch.weights import from_numpy_params, load_params

torch.set_num_threads(2)


def _weight(seed, shape, zero_row=True):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * (0.01 + 3 * rng.rand())).astype(np.float32)
    if zero_row:
        w[1] = 0.0                              # an all-zero row: scale 1
        w[:, 2] = 0.0                           # an all-zero column
    return w


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _f32_bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _assert_q_equal(t: Quantized, j, what=""):
    assert t.axis == j.axis, what
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q), err_msg=what)
    np.testing.assert_array_equal(t.s.numpy().view(np.int32), _f32_bits(j.s), err_msg=what)


def _jax_q8_tree(seed=1234):
    """The JAX package's Q8 tree of its tiny random params (from a numpy
    tree, so no session fixture's buffers are donated)."""
    tree = jax_random_params(jax_tiny_config(), seed, numpy_out=True)
    return tree, jax_quantize_params(jax.tree.map(jnp.asarray, tree))


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("seed,shape", [(0, (16, 32)), (1, (40, 24)), (2, (7, 129))])
def test_quantize_np_bit_identical(seed, shape, axis):
    w = _weight(seed, shape)
    t, j = quantize_np(w, axis), jax_quantize_np(w, axis)
    assert t.q.dtype == np.int8 and t.s.dtype == np.float32 and t.axis == j.axis
    np.testing.assert_array_equal(t.q, j.q)
    np.testing.assert_array_equal(t.s.view(np.int32), j.s.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("seed,shape", [(3, (48, 64)), (4, (33, 17))])
def test_quantize_torch_matches_jitted_jax(seed, shape, axis, dtype):
    """scales = amax * f32(1/127) as XLA compiles `amax / 127.0`; the
    division by the scales stays a division."""
    w = _weight(seed, shape)
    if dtype == "bfloat16":
        wt = torch.from_numpy(w).to(torch.bfloat16)
        wj = jnp.asarray(w).astype(jnp.bfloat16)
    else:
        wt, wj = torch.from_numpy(w), jnp.asarray(w)
    j = jax.jit(lambda a: quantize_jax(a, axis))(wj)
    t = quantize_torch(wt, axis)
    _assert_q_equal(t, j)
    assert wt.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def test_quantize_params_bit_identical_and_consuming():
    tree, jq = _jax_q8_tree()
    src = from_numpy_params(tree, "cpu")
    tq = quantize_params(src)
    got, want = dict(_leaves(tq)), dict(_leaves(jq))
    assert got.keys() == want.keys()
    n_q8 = 0
    for name, j in want.items():
        t = got[name]
        if isinstance(j, JaxQuantized):
            assert isinstance(t, Quantized), name
            _assert_q_equal(t, j, name)
            n_q8 += 1
        else:
            assert not isinstance(t, Quantized), name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    cfg = tiny_config()
    assert n_q8 == 7 * (cfg.encoder.layers + cfg.decoder.layers) + 3
    assert tq["decoder"]["embed"].axis == 0
    # the input's dicts now hold the Q8 leaves: its float leaves are gone
    assert isinstance(src["decoder"]["layers"][0]["wq"], Quantized)
    assert isinstance(src["adapter"]["w0"], Quantized)
    assert not isinstance(src["decoder"]["layers"][0]["ada_down"], Quantized)


@pytest.mark.parametrize("axis", [0, -1])
def test_dequantize_matches_jax(axis):
    j = jax_quantize_np(_weight(5, (12, 20)), axis)
    t = quantize_np(_weight(5, (12, 20)), axis)
    tt = Quantized(torch.from_numpy(t.q), torch.from_numpy(t.s), t.axis)
    np.testing.assert_array_equal(dequantize(tt).numpy(), np.asarray(jax_dequantize(j)))


def _q8_pair(seed, k, n):
    j = jax.jit(lambda a: quantize_jax(a, -1))(jnp.asarray(_weight(seed, (k, n)) * 0.1))
    return Quantized(torch.from_numpy(np.array(j.q)), torch.from_numpy(np.array(j.s))), j


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_linear_matches_jax(dtype, bias):
    """f32: rtol 1e-5 (same products, another summation order). bf16: both
    round the same f32 value to bf16 except where the summation order moves
    it across a rounding boundary: at most one bf16 ulp of max|y|."""
    rng = np.random.RandomState(6)
    wt, wj = _q8_pair(7, 48, 40)
    x = rng.randn(2, 3, 48).astype(np.float32)
    b = rng.randn(40).astype(np.float32) if bias else None
    if dtype == "bfloat16":
        xt, xj = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    yt = linear(xt, wt, None if b is None else torch.from_numpy(b))
    yj = jax.jit(jl.linear)(xj, wj, None if b is None else jnp.asarray(b))
    assert yt.dtype == xt.dtype and tuple(yt.shape) == (2, 3, 40)
    yj = np.asarray(yj.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                                   atol=2.0 ** -7 * np.abs(yj).max())
    else:
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_matmul_plain_matches_jax(dtype):
    """The W8A16 kernel's plain version against JAX's Q8 linear (same
    tolerances as test_q8_linear_matches_jax), at decode-like M."""
    rng = np.random.RandomState(8)
    wt, wj = _q8_pair(9, 64, 96)
    x = rng.randn(16, 64).astype(np.float32)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    yt = qm.q8_matmul_plain(xt, wt.q, wt.s)
    yj = np.asarray(jax.jit(jl.linear)(xj, wj).astype(jnp.float32))
    assert yt.dtype == xt.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(yt.float().numpy(), yj, rtol=0,
                                   atol=2.0 ** -7 * np.abs(yj).max())
    else:
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_embed_lookup_and_logits_match_jax(dtype):
    """Lookup: the same two casts and one product as JAX, bit for bit.
    Logits: f32, rtol 1e-5 (summation order)."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j = jax.jit(lambda a: quantize_jax(a, 0))(jnp.asarray(_weight(10, (50, 32)) * 0.2))
    t = Quantized(torch.from_numpy(np.array(j.q)), torch.from_numpy(np.array(j.s)), 0)
    ids = np.array([[0, 7], [49, 1]], np.int32)
    rows_t = embed_lookup(t, torch.from_numpy(ids), tdt)
    rows_j = jl.embed_lookup(j, jnp.asarray(ids), jdt)
    assert rows_t.dtype == tdt and tuple(rows_t.shape) == (2, 2, 32)
    np.testing.assert_array_equal(rows_t.float().numpy(),
                                  np.asarray(rows_j.astype(jnp.float32)))
    h = np.random.RandomState(11).randn(3, 32).astype(np.float32)
    ht, hj = torch.from_numpy(h).to(tdt), jnp.asarray(h).astype(jdt)
    lt = embed_logits(ht, t)
    lj = np.asarray(jax.jit(jl.embed_logits)(hj, j))
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (3, 50)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-5, atol=1e-6)


def test_q8_safetensors_loads_bit_for_bit(tmp_path):
    """A Q8 file written by tools/quantize.py (every 2-D tensor Q8, the rest
    F32) loads into the same tree as the JAX package's loader: Quantized
    leaves with equal codes, scales and axis, float leaves equal."""
    jcfg = jax_tiny_config()
    tree = jax_random_params(jcfg, 1234, numpy_out=True)
    f32_path = os.path.join(tmp_path, "f32.safetensors")
    q8_path = os.path.join(tmp_path, "q8.safetensors")
    params_to_safetensors(tree, jcfg, f32_path)
    qtool.quantize_file(f32_path, q8_path, verbose=False)
    want = dict(_leaves(jax_load_params(q8_path, jcfg, device_put=False)))
    got = dict(_leaves(load_params(q8_path, tiny_config(), device="cpu")))
    assert got.keys() == want.keys()
    for name, j in want.items():
        t = got[name]
        if isinstance(j, JaxQuantized):
            assert isinstance(t, Quantized) and t.q.is_contiguous(), name
            _assert_q_equal(t, j, name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert got[".decoder.embed"].axis == 0
    assert isinstance(got[".decoder.layers.0.ada_down"], Quantized)


def test_from_numpy_params_takes_jax_q8_leaves():
    arr = (np.random.RandomState(12).randn(6, 5)).astype(np.float32)
    j = jax_quantize_np(arr, -1)
    leaf = JaxQuantized(q=j.q, s=j.s.astype(ml_dtypes.bfloat16), axis=-1)
    t = from_numpy_params({"w": leaf}, "cpu")["w"]
    assert isinstance(t, Quantized) and t.axis == -1 and t.s.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.q.numpy(), j.q)
    assert t.device.type == "cpu" and tuple(t.shape) == (6, 5)


def test_q8_pipeline_tokens_match_jax():
    """The tiny offline pipeline on the JAX package's Q8 tree, f32: the
    port's tokens equal JAX's exactly (Q8 linear everywhere, the Q8 greedy
    head, dequantized nothing)."""
    tree, jq = _jax_q8_tree()
    tq = from_numpy_params(jq, "cpu")
    audio = (np.random.RandomState(13).randn(3 * 16000) * 0.3).astype(np.float32)
    before = dict(qm.LAUNCHES)
    tokens_t, _ = transcribe_tokens_batch(tq, tiny_config(), audio, device="cpu")
    tokens_j, _ = jax_transcribe(jq, jax_tiny_config(), audio)
    assert len(tokens_t) > 10
    assert tokens_t == list(tokens_j)
    assert qm.LAUNCHES == before                 # the CPU never launches K2


# The decoder's five Q8 shapes (K, N), their slices on 2 tensor-parallel
# ranks (column slices of wq, wk/wv, w1/w3; row slices of wo, w2) and the
# adapter's first matrix.
PLAN_SHAPES = [(3072, 4096), (3072, 1024), (4096, 3072), (3072, 9216), (9216, 3072),
               (3072, 2048), (3072, 512), (2048, 3072), (3072, 4608), (4608, 3072),
               (5120, 3072)]


def _resident(per_sm):
    """Resident blocks for clusters of 1..8: `per_sm` blocks on each of 132
    SMs, fewer for clusters that do not pack the card's GPCs."""
    return [max(c, per_sm * 132 - (c - 1) * 8) for c in range(1, 9)]


@pytest.mark.parametrize("k,n", PLAN_SHAPES)
@pytest.mark.parametrize("m", [1, 16, 32, 38, 64])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 8])
def test_k2_plan_covers_k_in_one_wave(k, n, m, per_sm):
    """K2's plan: the splits cover K, none is empty, each slice is whole
    64-row stages, a column tile's splits fit one cluster (at most 8), the
    grid (a block per column tile and split) fits one wave of the resident
    blocks, and every 16-row tile of M is in the same block: M enters only
    through `resident`."""
    resident = _resident(per_sm)
    cols, stages, k_slice, splits = qm.k2_plan(m, k, n, resident)
    assert cols == 128 and stages >= 2
    assert k_slice % 64 == 0 and 1 <= splits <= 8
    assert k_slice * (splits - 1) < k <= k_slice * splits        # covered, none empty
    tiles = -(-n // cols)
    assert splits == 1 or tiles * splits <= resident[splits - 1]  # one wave of blocks
    assert all(qm.k2_plan(mm, k, n, resident) == (cols, stages, k_slice, splits)
               for mm in (1, 17, 64))
    assert qm.Q8_GEMV_MAX_ROWS == 64


def test_k2_entry_refuses_before_the_card(monkeypatch):
    """The entry refuses what the kernel cannot take (M outside 1..64, K not
    a multiple of 8, N not a multiple of 16, x, q or s not 16-byte aligned
    or not contiguous, other dtypes) with ValueError before it asks for the
    card: the library and the occupancy query are stubbed to fail."""
    def no_card(*_a, **_k):
        raise AssertionError("reached the card")

    monkeypatch.setattr(qm, "_lib", no_card)
    monkeypatch.setattr(qm, "_resident", no_card)
    bf = torch.bfloat16

    def args(m=4, k=64, n=128, dtype=bf):
        return (torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=torch.int8),
                torch.ones(n, dtype=torch.float32))

    def shifted(t, by):
        flat = torch.zeros(t.numel() + by, dtype=t.dtype)[by:]
        return flat.view(t.shape)

    x, q, s = args()
    cases = [
        (args(m=65), "1..64"),
        ((torch.zeros((0, 64), dtype=bf), q, s), "1..64"),
        (args(k=60), "multiple of 8"),
        (args(n=120), "of 16"),
        ((shifted(x, 4), q, s), "aligned"),
        ((x, shifted(q, 8), s), "aligned"),
        ((x, q, shifted(s, 2)), "aligned"),
        ((torch.zeros((64, 4), dtype=bf).t(), q, s), "contiguous"),
        (args(dtype=torch.float16), "f32 or bf16"),
        ((x, q.to(torch.int16), s), "int8"),
        ((x, q, s.to(bf)), "f32"),
        ((x, q, torch.ones(64)), "f32"),
        ((x, q, s), "CUDA"),                     # takeable, but not on a card
    ]
    for (xx, qq, ss), match in cases:
        with pytest.raises(ValueError, match=match):
            qm.w8a16_gemv(xx, qq, ss)
    with pytest.raises(ValueError, match="unsupported device"):
        qm.q8_matmul(x.to("meta"), q.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="1..64"):
        qm.k2_plan(65, 64, 128, _resident(2))


def _k2_emulate(x, q, s, resident):
    """K2's bf16 route in plain torch: x [m, k] (bf16 values), codes q [k,
    n], scales s [n]. Each split of the plan sums its slice's 16-row k-steps
    in order into an f32 accumulator (one mma per k-step), the splits'
    partials are added in split order, the sum is scaled, then rounded once.
    Returns (f32 before rounding, bf16)."""
    m, k = x.shape
    _, _, k_slice, splits = qm.k2_plan(m, k, q.shape[1], resident)
    xf, qf = x.float(), q.float()
    parts = []
    for sp in range(splits):
        acc = torch.zeros((m, q.shape[1]))
        for r0 in range(sp * k_slice, min(k, (sp + 1) * k_slice), 16):
            acc = acc + xf[:, r0:r0 + 16] @ qf[r0:r0 + 16]
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    y = total * s
    return y, y.to(torch.bfloat16)


@pytest.mark.parametrize("m", [1, 16, 38])
@pytest.mark.parametrize("per_sm", [1, 8])
def test_k2_summation_order_matches_jax(m, per_sm):
    """The emulated bf16 route (k-steps, splits merged in order, the scale
    after the sum, one rounding) against the JAX package's Q8 linear, at a
    K that is no multiple of the 64-row stage and an N that is no multiple
    of the 128-column tile, with 1 or 7 splits: f32 within 1e-5 of max|y|
    (another summation order); bf16 within one bf16 ulp of max|y|."""
    k, n = 392, 272
    wt, wj = _q8_pair(20 + m, k, n)
    rng = np.random.RandomState(30 + m)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    resident = [3] * 8 if per_sm == 1 else _resident(8)
    splits = qm.k2_plan(m, k, n, resident)[3]
    assert splits == (1 if per_sm == 1 else 7)
    y32, y16 = _k2_emulate(x, wt.q, wt.s, resident)
    xj32 = jnp.asarray(x.float().numpy())
    want32 = np.asarray(jax.jit(jl.linear)(xj32, wj))
    mx = np.abs(want32).max()
    np.testing.assert_allclose(y32.numpy(), want32, rtol=0, atol=1e-5 * mx)
    want16 = np.asarray(jax.jit(jl.linear)(xj32.astype(jnp.bfloat16), wj).astype(jnp.float32))
    np.testing.assert_allclose(y16.float().numpy(), want16, rtol=0,
                               atol=2.0 ** (np.floor(np.log2(mx)) - 7))


# --- K2's fragment mapping, emulated lane by lane (csrc/w8a16.cu) ---------

_STAGE, _COLS, _XROW, _QROW = 64, 128, 128, 128      # kStageRows, kCols, kXRow, kQRow


def _q_off(j, c):
    return (j * (_QROW // 16) + (c ^ (j & 6))) * 16


def _x_off(j, c):
    return (j * (_XROW // 16) + (c ^ (j & 7))) * 16


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes of (x, y)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16_pair(bits):
    """A 32-bit word as two bf16 values (low half first)."""
    return [float(np.array([((bits >> sh) & 0xFFFF) << 16], np.uint32).view(np.float32)[0])
            for sh in (0, 16)]


def _int8x4_to_bf16_pairs(w):
    """mma_common::int8x4_to_bf16_pairs<0, 1, 2, 3>: two words of bf16
    pairs, each (128 + (code & 127)) - (128 + (code & 128)) per half."""
    mag, sgn = w & 0x7F7F7F7F, w & 0x80808080
    out = []
    for sel in (0x4140, 0x4342):
        a = _bf16_pair(_byte_perm(mag, 0x43434343, sel))
        b = _bf16_pair(_byte_perm(sgn, 0x43434343, sel))
        out.append([a[0] - b[0], a[1] - b[1]])          # exact in bf16
    return out


def test_k2_fragment_mapping_emulated():
    """One 64-row stage of one block, as the kernel's threads see it: the
    cp.async copies write the swizzled code and x tiles (x rows past M and
    code columns past N zero-filled), each lane of each warp loads its four
    code words, interleaves and converts them, ldmatrix hands out the A
    fragments, mma.sync m16n8k16 adds them up (exactly, in f64), and the
    epilogue's partial tile must equal x @ q over the stage, column for
    column: every index of the mapping is checked here, the rounding
    elsewhere."""
    rng = np.random.RandomState(40)
    m, n_valid, mt_tiles = 20, 112, 2                   # 2 m-tiles; 16 columns past N
    codes = rng.randint(-127, 128, size=(_STAGE, _COLS)).astype(np.int8)
    codes[:, n_valid:] = 0
    x = rng.randint(-64, 64, size=(16 * mt_tiles, _STAGE)).astype(np.float64) / 8
    x[m:] = 0.0
    qmem = np.zeros(_STAGE * _QROW, np.uint8)
    xmem = np.zeros(16 * mt_tiles * _XROW // 2, np.float64)   # bf16 elements as values
    for tid in range(128):                               # the copies of `issue`
        qj, qc = tid // 8, tid % 8
        for e in range(_STAGE // 16):            # passes of 16 rows
            dst = _q_off(qj, qc) + e * 16 * _QROW
            row = qj + 16 * e
            if 16 * qc < n_valid:
                qmem[dst:dst + 16] = codes[row, 16 * qc:16 * qc + 16].view(np.uint8)
        xm, xc = tid // (_XROW // 16), tid % (_XROW // 16)
        passes = 128 // (_XROW // 16)
        for e in range(16 * mt_tiles // passes):
            dst = _x_off(xm, xc) + e * passes * _XROW
            row = xm + passes * e
            xmem[dst // 2:dst // 2 + 8] = x[row, 8 * xc:8 * xc + 8] if row < m else 0.0
    red = np.zeros((16 * mt_tiles, _COLS))
    for warp in range(4):
        acc = np.zeros((mt_tiles, 4, 32, 4))            # [mt][n-tile][lane][c0..c3]
        for kk in range(_STAGE // 16):
            b0, b1 = np.zeros((4, 32, 2)), np.zeros((4, 32, 2))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                words = []
                for r in range(4):
                    j = 2 * t + (r & 1) + 8 * (r >> 1)
                    off = _q_off(j, 2 * warp + (g >> 2)) + 4 * (g & 3) + kk * 16 * _QROW
                    words.append(int(qmem[off:off + 4].view(np.uint32)[0]))
                lo0, hi0 = (_int8x4_to_bf16_pairs(_byte_perm(words[0], words[1], sel))
                            for sel in (0x5140, 0x7362))
                lo1, hi1 = (_int8x4_to_bf16_pairs(_byte_perm(words[2], words[3], sel))
                            for sel in (0x5140, 0x7362))
                for j, (p0, p1) in enumerate(zip(lo0 + hi0, lo1 + hi1)):
                    b0[j, lane], b1[j, lane] = p0, p1
            for mt in range(mt_tiles):
                # ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8
                addr = []
                for lane in range(32):
                    lrow = (lane & 7) + ((lane >> 3) & 1) * 8
                    addr.append((_x_off(lrow, 2 * kk + (lane >> 4)) + mt * 16 * _XROW) // 2)
                a = np.zeros((32, 4, 2))
                for lane in range(32):
                    for i in range(4):
                        src = addr[8 * i + lane // 4] + 2 * (lane % 4)
                        a[lane, i] = xmem[src:src + 2]
                # mma.sync m16n8k16 on the fragments
                A, B = np.zeros((16, 16)), np.zeros((4, 16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = a[lane, 0], a[lane, 1]
                    A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = a[lane, 2], a[lane, 3]
                    for j in range(4):
                        B[j, 2 * t:2 * t + 2, g] = b0[j, lane]
                        B[j, 2 * t + 8:2 * t + 10, g] = b1[j, lane]
                for j in range(4):
                    C = A @ B[j]
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        acc[mt, j, lane] += [C[g, 2 * t], C[g, 2 * t + 1],
                                             C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
        for mt in range(mt_tiles):                       # the epilogue's partial tile
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    col = 32 * warp + 8 * t
                    red[16 * mt + g + 8 * h, col:col + 4] = acc[mt, :, lane, 2 * h]
                    red[16 * mt + g + 8 * h, col + 4:col + 8] = acc[mt, :, lane, 2 * h + 1]
    want = x @ codes.astype(np.float64)
    np.testing.assert_array_equal(red, want)
    assert want[:m, :n_valid].any()
    assert not want[m:].any() and not want[:, n_valid:].any()


def test_k2_variant_sources_change_one_choice_each(tmp_path, monkeypatch):
    """The design sweep's variant copies of w8a16.cu: a variant without
    edits (the committed one, and a change of the plan alone) is the source
    itself, every edited one differs from it and from the others, an edit
    that no longer matches the source raises, and the sweep refuses to run
    off the card."""
    dirs = k2v.variant_sources(str(tmp_path))
    with open(os.path.join(k2v._build.CSRC_DIR, "w8a16.cu")) as f:
        committed = f.read()
    texts = {v: open(os.path.join(d, "w8a16.cu")).read() for v, d in dirs.items()}
    edited = {v: t for v, t in texts.items() if k2v.VARIANTS[v][3]}
    assert all(texts[v] == committed for v in texts if v not in edited)
    assert committed not in edited.values() and len(set(edited.values())) == len(edited) >= 6
    assert all(os.path.exists(os.path.join(d, "mma_common.cuh")) for d in dirs.values())
    monkeypatch.setitem(k2v.VARIANTS, "stale", (64, 4, 8, [("no such line", "x", 1)], True))
    with pytest.raises(ValueError, match="occurs 0 times"):
        k2v.variant_sources(str(tmp_path), names=("stale",))
    with pytest.raises(ValueError, match="needs the card"):
        k2v.profile_k2_variants(device="cpu")
