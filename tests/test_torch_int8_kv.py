"""The port's int8 decoder rings (voxtral_tpu_torch.models.decoder with
kv_dtype="int8") against the JAX package's, tiny config, f32 on the CPU: JAX
runs the Pallas kernel in interpret mode, the port the wrapper's plain
version. Mirrors tests/test_int8_kv.py and adds exact comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu import models as jm
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch import models as tm
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.decoder import retained_window
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"

# jitted as in production, so the fold's quantizer rounds as XLA compiles it
jax_prefill = jax.jit(jm.decoder_prefill, static_argnums=(1,))
jax_decode = jax.jit(jm.decode_scan, static_argnums=(1,),
                     static_argnames=("collect_topk", "stop_at_eos"))


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(tiny_cfg):
    return from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), CPU)


def _decode_both(cfg, tiny_cfg, params, tiny_params, kv_dtype, frames, prefix,
                 n_valid=None, chunk=8):
    """Prefill + chunked decode through both decoders (ring 64, pending 8).
    Returns (port tokens, jax tokens, port state, jax state, port aux, jax
    aux) with aux of the last chunk."""
    b, n, _ = frames.shape
    d = cfg.decoder
    t_ada = tm.ada_scales(params["decoder"], tm.time_conditioning(6, d.dim))
    j_ada = jm.ada_scales(tiny_params["decoder"], jm.time_conditioning(6, d.dim))
    st = tm.init_decode_state(cfg, batch=b, ring_size=64, pending_size=8,
                              kv_dtype=kv_dtype, device=CPU)
    js = jm.init_decode_state(tiny_cfg, batch=b, ring_size=64, pending_size=8,
                              kv_dtype=kv_dtype)
    st = tm.decoder_prefill(params["decoder"], cfg, st, torch.from_numpy(prefix), t_ada)
    js = jax_prefill(tiny_params["decoder"], tiny_cfg, js, jnp.asarray(prefix), j_ada)
    toks, jtoks = [], []
    for c0 in range(0, n, chunk):
        f = frames[:, c0:c0 + chunk]
        nv = np.full((b,), f.shape[1], np.int32) if n_valid is None else \
            np.clip(n_valid - c0, 0, f.shape[1]).astype(np.int32)
        st, t, aux = tm.decode_scan(params["decoder"], cfg, st, torch.from_numpy(f),
                                    torch.from_numpy(nv), t_ada, stop_at_eos=False,
                                    collect_topk=2)
        js, jt, jaux = jax_decode(tiny_params["decoder"], tiny_cfg, js, jnp.asarray(f),
                                  jnp.asarray(nv), j_ada, stop_at_eos=False,
                                  collect_topk=2)
        toks.append(t.numpy())
        jtoks.append(np.asarray(jt))
    return (np.concatenate(toks, 1), np.concatenate(jtoks, 1), st, js, aux, jaux)


def test_decode_int8_rings_match_jax(cfg, tiny_cfg, params, tiny_params):
    """int8 decoder rings over 48 tokens in chunks of 8 (the ring of 64
    wraps): tokens and best logits equal JAX's, and the rings equal JAX's
    code for code (the fold quantizes the float pending, the prefill
    quantizes as it writes)."""
    rng = np.random.RandomState(0)
    b, n = 2, 48
    d = cfg.decoder
    frames = (rng.randn(b, n, d.dim) * 0.1).astype(np.float32)
    prefix = (rng.randn(b, 4, d.dim) * 0.1).astype(np.float32)
    tok, jtok, st, js, aux, jaux = _decode_both(cfg, tiny_cfg, params, tiny_params,
                                                "int8", frames, prefix)
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_allclose(aux["best_logit"].numpy(), np.asarray(jaux["best_logit"]),
                               rtol=1e-5, atol=1e-5)
    for name in ("slot_pos", "pending_sp", "write_ctr", "pending_adv", "pos"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    for l in range(d.layers):
        for name in ("k_ring", "v_ring"):
            np.testing.assert_array_equal(getattr(st, name)[l].numpy(),
                                          np.asarray(getattr(js, name)[l]), err_msg=name)
        for name in ("k_scale", "v_scale", "pending_k", "pending_v"):
            np.testing.assert_allclose(getattr(st, name)[l].numpy(),
                                       np.asarray(getattr(js, name)[l]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_decode_int8_rings_track_float(cfg, params):
    """Mirror of tests/test_int8_kv.py: int8 rings track float rings."""
    rng = np.random.RandomState(0)
    b, n = 2, 24
    d = cfg.decoder
    frames = torch.from_numpy((rng.randn(b, n, d.dim) * 0.1).astype(np.float32))
    prefix = torch.from_numpy((rng.randn(b, 4, d.dim) * 0.1).astype(np.float32))
    t_ada = tm.ada_scales(params["decoder"], tm.time_conditioning(6, d.dim))
    out = {}
    for kv in ("float", "int8"):
        st = tm.init_decode_state(cfg, batch=b, ring_size=64, pending_size=8,
                                  kv_dtype=kv, device=CPU)
        st = tm.decoder_prefill(params["decoder"], cfg, st, prefix, t_ada)
        toks = []
        for c0 in range(0, n, 8):
            st, t, _ = tm.decode_scan(params["decoder"], cfg, st, frames[:, c0:c0 + 8],
                                      torch.full((b,), 8, dtype=torch.int32), t_ada,
                                      stop_at_eos=False)
            toks.append(t.numpy())
        out[kv] = np.concatenate(toks, 1)
    assert (out["float"] == out["int8"]).mean() >= 0.85


def test_retained_window_matches_jax(cfg, tiny_cfg, params, tiny_params):
    """retained_window on a batch where stream 1 idles half the time (its
    slots recycle under the shared cursor) equals the JAX package's."""
    rng = np.random.RandomState(3)
    b, n = 2, 40
    d = cfg.decoder
    frames = (rng.randn(b, n, d.dim) * 0.1).astype(np.float32)
    prefix = (rng.randn(b, 4, d.dim) * 0.1).astype(np.float32)
    n_valid = np.array([n, n // 2], np.int32)
    tok, jtok, st, js, _, _ = _decode_both(cfg, tiny_cfg, params, tiny_params,
                                           "int8", frames, prefix, n_valid=n_valid)
    np.testing.assert_array_equal(tok, jtok)
    for window in (d.window, 16, 200):
        got = retained_window(st, window)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jm.decoder.retained_window(js, window)))


def test_decoder_rejects_int4_kv(cfg):
    """int4 rings are encoder-only, as in the JAX package."""
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_decode_state(cfg, batch=1, kv_dtype="int4", device=CPU)
