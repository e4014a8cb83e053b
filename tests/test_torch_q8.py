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


@pytest.mark.parametrize("k,n", [(3072, 4096), (3072, 1024), (4096, 3072),
                                 (3072, 9216), (9216, 3072), (5120, 3072), (40, 8)])
@pytest.mark.parametrize("m", [1, 16, 38, 64])
def test_split_k_covers_k(k, n, m):
    """K2's split of K: slices of whole 16-row steps, at most 512 rows, none
    empty, together covering K; at the decode shapes the grid fills the
    card."""
    k_slice, splits = qm.split_k(m, k, n, 132)
    assert k_slice % 16 == 0 and k_slice <= 512 and splits >= 1
    assert k_slice * splits >= k and k_slice * (splits - 1) < k
    if k >= 1024:
        blocks = -(-n // 32) * -(-m // 16) * splits
        assert blocks >= 2 * 132
    assert qm.Q8_GEMV_MAX_ROWS == 64
