"""The port's KV-ring quantizers (voxtral_tpu_torch.quant) against the JAX
package's, jitted as production runs them: codes and scales bit-identical on
the same f32 input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.quant import quantize_kv as jax_quantize_kv
from voxtral_tpu.quant import quantize_kv_int4 as jax_quantize_kv_int4
from voxtral_tpu.quant import unpack_int4 as jax_unpack_int4
from voxtral_tpu_torch.quant import quantize_kv, quantize_kv_int4, unpack_int4

torch.set_num_threads(2)

_JAX = {quantize_kv: jax.jit(jax_quantize_kv, static_argnums=(1, 2)),
        quantize_kv_int4: jax.jit(jax_quantize_kv_int4, static_argnums=(1, 2))}


def _input(seed, b, s, hkv, hd):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, hkv * hd) * (0.01 + 10 * rng.rand())).astype(np.float32)
    x[0, 0, :hd] = 0.0                          # an all-zero head: scale 1
    x[-1, -1, hd:2 * hd] = np.round(x[-1, -1, hd:2 * hd])
    return x


@pytest.mark.parametrize("fn", [quantize_kv, quantize_kv_int4])
@pytest.mark.parametrize("seed,shape", [(0, (2, 5, 3, 8)), (1, (3, 33, 8, 64)),
                                        (2, (1, 7, 32, 64)), (3, (2, 9, 8, 128))])
def test_quantizers_bit_identical_to_jax(fn, seed, shape):
    b, s, hkv, hd = shape
    x = _input(seed, b, s, hkv, hd)
    q, sc = fn(torch.from_numpy(x), hkv, hd)
    jq, jsc = _JAX[fn](jnp.asarray(x), hkv, hd)
    width = hkv * hd // (2 if fn is quantize_kv_int4 else 1)
    assert q.dtype == torch.int8 and tuple(q.shape) == (b, s, width)
    assert sc.dtype == torch.float32 and tuple(sc.shape) == (b, hkv, s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32))


def test_int4_pack_roundtrip():
    """Mirror of tests/test_quant.py: quantize_kv_int4 -> unpack_int4
    recovers the quantized values (halves packing), within half a scale
    step of the input, and unpack_int4 equals JAX's on every byte."""
    rng = np.random.RandomState(0)
    b, s, hkv, hd = 2, 5, 3, 8
    x = rng.randn(b, s, hkv * hd).astype(np.float32)
    packed, scales = quantize_kv_int4(torch.from_numpy(x), hkv, hd)
    assert tuple(packed.shape) == (b, s, hkv * hd // 2)
    assert tuple(scales.shape) == (b, hkv, s)
    lo, hi = unpack_int4(packed.reshape(b, s, hkv, hd // 2))
    vals = torch.cat([lo, hi], dim=-1).numpy()
    assert vals.min() >= -8 and vals.max() <= 7
    s_np = np.swapaxes(scales.numpy(), 1, 2)[..., None]
    err = np.abs((vals * s_np).reshape(b, s, -1) - x)
    assert (err <= 0.5 * s_np.max() + 1e-6).all()
    every = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    jlo, jhi = jax_unpack_int4(jnp.asarray(every.numpy()))
    tlo, thi = unpack_int4(every)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
