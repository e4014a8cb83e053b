"""The port's ops and host mel (voxtral_tpu_torch.ops, .audio.mel) against
the JAX package's on the same seeded inputs, f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from voxtral_tpu.audio import mel as jmel
from voxtral_tpu.ops import attention as jatt
from voxtral_tpu.ops import conv as jconv
from voxtral_tpu.ops import linear as jlin
from voxtral_tpu.ops import norms as jnorms
from voxtral_tpu.ops import rope as jrope
from voxtral_tpu_torch.audio import mel as tmel
from voxtral_tpu_torch.ops import attention as tatt
from voxtral_tpu_torch.ops import conv as tconv
from voxtral_tpu_torch.ops import linear as tlin
from voxtral_tpu_torch.ops import norms as tnorms
from voxtral_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

SLOT_INVALID = -(1 << 30)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_rms_norm():
    rng = np.random.RandomState(0)
    x, w = _rand(rng, 3, 7, 64), 1 + _rand(rng, 64, scale=0.1)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_rope_angles_and_apply_at_large_positions():
    rng = np.random.RandomState(1)
    pos = np.array([0, 1, 37, 8191, 250_000], np.int32)
    cos_t, sin_t = trope.rope_angles(torch.from_numpy(pos), 128, 1e6)
    cos_j, sin_j = jrope.rope_angles(jnp.asarray(pos), 128, 1e6)
    _close(cos_t.numpy(), cos_j)
    _close(sin_t.numpy(), sin_j)
    x = _rand(rng, 2, 5, 4, 128)
    _close(trope.apply_rope(torch.from_numpy(x), cos_t, sin_t).numpy(),
           jrope.apply_rope(jnp.asarray(x), cos_j, sin_j))


@pytest.mark.parametrize("stride,length", [(1, 16), (2, 16), (2, 15)])
def test_causal_conv1d(stride, length):
    rng = np.random.RandomState(2)
    x, w, b = _rand(rng, 8, length), _rand(rng, 3, 8, 12), _rand(rng, 12)
    assert tconv.causal_conv_pads(length, 3, stride) == \
        jconv.causal_conv_pads(length, 3, stride)
    out = tconv.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), stride=stride)
    ref = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              stride=stride)
    assert out.shape[1] == tconv.causal_conv_out_len(length, 3, stride)
    _close(out.numpy(), ref)


def test_linear_and_embeddings():
    rng = np.random.RandomState(3)
    x, w, b = _rand(rng, 4, 16), _rand(rng, 16, 24), _rand(rng, 24)
    _close(tlin.linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy(),
           jlin.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    emb, ids = _rand(rng, 50, 16), np.array([[0, 7, 49]], np.int32)
    _close(tlin.embed_lookup(torch.from_numpy(emb), torch.from_numpy(ids)).numpy(),
           jlin.embed_lookup(jnp.asarray(emb), jnp.asarray(ids)))
    _close(tlin.embed_logits(torch.from_numpy(x), torch.from_numpy(emb)).numpy(),
           jlin.embed_logits(jnp.asarray(x), jnp.asarray(emb)))


def test_embed_logits_bf16_table_returns_f32_accumulation():
    """A bf16 table gives f32 logits that are not rounded to bf16."""
    rng = np.random.RandomState(4)
    h, emb = _rand(rng, 3, 64), _rand(rng, 40, 64, scale=0.1)
    out = tlin.embed_logits(torch.from_numpy(h),
                            torch.from_numpy(emb).bfloat16())
    ref = jlin.embed_logits(jnp.asarray(h), jnp.asarray(emb, jnp.bfloat16))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)
    assert not torch.equal(out, out.bfloat16().float())


def test_linear_refuses_non_tensor_weights():
    """Weights are float tensors or Q8 `Quantized` leaves; anything else
    (here a numpy array, an arbitrary object) raises."""
    with pytest.raises(TypeError, match="float tensors and Q8"):
        tlin.linear(torch.zeros(2, 4), np.zeros((4, 4), np.float32))
    with pytest.raises(TypeError, match="float tensors and Q8"):
        tlin.embed_logits(torch.zeros(2, 4), object())
    with pytest.raises(TypeError, match="float tensors and Q8"):
        tlin.embed_lookup(object(), torch.zeros(2, dtype=torch.long))


@pytest.mark.parametrize("q_start,kv_start", [(0, 0), (5, 3)])
def test_windowed_attention(q_start, kv_start):
    rng = np.random.RandomState(5)
    q, k, v = _rand(rng, 12, 8, 16), _rand(rng, 14, 2, 16), _rand(rng, 14, 2, 16)
    out = tatt.windowed_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=6,
                                  q_start=q_start, kv_start=kv_start)
    ref = jatt.windowed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=6, q_start=q_start, kv_start=kv_start)
    _close(out.numpy(), ref)


def test_ring_decode_attention_with_extra_columns():
    rng = np.random.RandomState(6)
    r, sx = 40, 6
    q, k, v = _rand(rng, 1, 8, 16), _rand(rng, r, 2, 16), _rand(rng, r, 2, 16)
    sp = (70 - np.mod(70 - np.arange(r), r)).astype(np.int32)
    sp[3] = SLOT_INVALID
    xk, xv = _rand(rng, sx, 2, 16), _rand(rng, sx, 2, 16)
    xp = np.array([71, 72, 73, SLOT_INVALID, SLOT_INVALID, SLOT_INVALID], np.int32)
    t = torch.from_numpy
    out = tatt.ring_decode_attention(t(q), t(k), t(v), slot_pos=t(sp), q_pos=73,
                                     window=32, extra_kv=(t(xk), t(xv), t(xp)))
    ref = jatt.ring_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), slot_pos=jnp.asarray(sp),
        q_pos=73, window=32,
        extra_kv=(jnp.asarray(xk), jnp.asarray(xv), jnp.asarray(xp)))
    _close(out.numpy(), ref)


def test_mel_filters_and_padding_match_fixture():
    g = load_fixture("mel.npz")
    np.testing.assert_array_equal(tmel.mel_filters(), g["filters"])
    np.testing.assert_array_equal(tmel.pad_audio_offline(g["audio"]), g["padded"])


@pytest.mark.parametrize("key,src", [("mel", "audio"), ("mel_padded", "padded")])
def test_batch_mel_matches_fixture_and_jax(key, src):
    g = load_fixture("mel.npz")
    ours = tmel.batch_log_mel(g[src])
    np.testing.assert_array_equal(ours, jmel.batch_log_mel(g[src]))
    assert ours.shape == g[key].shape
    # bit-equal to the JAX package's host mel; the fixture (torch.stft in
    # the reference pipeline) differs by float32 rounding: at most 2.98e-6,
    # a few ulps of values near 1
    np.testing.assert_allclose(ours, g[key], atol=5e-6, rtol=0)
