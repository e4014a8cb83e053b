"""The port's incremental ring-cache encoder
(voxtral_tpu_torch.models.encoder.encoder_incremental) against its own batch
forward and against the JAX package's incremental encoder, in float, int8
and int4 ring modes, tiny config, f32 on the CPU (where the ring attention
wrapper runs its plain version and JAX runs the Pallas kernel in interpret
mode for quantized rings)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.models import encoder as jenc
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import encoder as tenc
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"

# jitted as in production (the fleet step jits it), so the KV quantizers
# round their scales as XLA compiles them
jax_incremental = jax.jit(jenc.encoder_incremental, static_argnums=(1,))


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(tiny_cfg):
    return from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), CPU)


def _run_both(cfg, tiny_cfg, params, tiny_params, chunks, *, ring_size, batch=1,
              kv_dtype="float", pending_size=128, n_valids=None):
    """Feed the same chunks ([B, S, D] numpy) through both incremental
    encoders; returns (port outs, jax outs, port state, jax state)."""
    st = tenc.init_encoder_state(cfg, ring_size=ring_size, batch=batch,
                                 pending_size=pending_size, kv_dtype=kv_dtype,
                                 device=CPU)
    js = jenc.init_encoder_state(tiny_cfg, ring_size=ring_size, batch=batch,
                                 pending_size=pending_size, kv_dtype=kv_dtype)
    outs, jouts = [], []
    for i, c in enumerate(chunks):
        nv = None if n_valids is None else n_valids[i]
        st, out = tenc.encoder_incremental(
            params["encoder"], cfg, st, torch.from_numpy(c),
            n_valid=None if nv is None else torch.tensor(nv, dtype=torch.int32))
        js, jout = jax_incremental(
            tiny_params["encoder"], tiny_cfg, js, jnp.asarray(c),
            None if nv is None else jnp.asarray(nv, jnp.int32))
        outs.append(out.numpy())
        jouts.append(np.asarray(jout))
    return outs, jouts, st, js


def _assert_rings_match(st, js):
    """Slot tables and cursors equal; rings equal code for code (quantized)
    or within 1e-5 (float); scales within 1e-5."""
    for name in ("slot_pos", "pending_sp", "write_ctr", "pending_adv", "next_pos"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    quant = st.k_scale is not None
    assert quant == (js.k_scale is not None)
    fields = ["k_ring", "v_ring", "pending_k", "pending_v"]
    if quant:
        fields += ["k_scale", "v_scale", "pending_ks", "pending_vs"]
    for name in fields:
        for t, j in zip(getattr(st, name), getattr(js, name)):
            t, j = t.numpy(), np.asarray(j)
            assert t.shape == j.shape and t.dtype == j.dtype, name
            if t.dtype == np.int8:
                np.testing.assert_array_equal(t, j, err_msg=name)
            else:
                np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=name)


def test_incremental_encoder_equals_batch(cfg, tiny_cfg, params, tiny_params):
    """Chunked ring-cache encoder == batch forward (window 24 << 96
    positions, so the ring wraps), and == the JAX incremental encoder."""
    rng = np.random.RandomState(11)
    s = 96
    h_full = rng.randn(s, cfg.encoder.dim).astype(np.float32)
    batch_out = tenc.encoder_forward(params["encoder"], cfg, torch.from_numpy(h_full))
    sizes, pos, chunks = (5, 1, 17, 3, 30, 40), 0, []
    for size in sizes:
        chunks.append(h_full[None, pos:pos + size])
        pos += size
    outs, jouts, st, js = _run_both(cfg, tiny_cfg, params, tiny_params, chunks,
                                    ring_size=64)
    inc = np.concatenate([o[0] for o in outs])
    np.testing.assert_allclose(inc, batch_out.numpy(), atol=3e-5, rtol=1e-4)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o, j, atol=1e-5, rtol=1e-5)
    _assert_rings_match(st, js)


def test_incremental_encoder_padding_mask(cfg, tiny_cfg, params, tiny_params):
    """Bucket-padded chunks (n_valid < S, padding rows poisoned) do not
    disturb results; per-stream n_valid in a batch of two matches JAX."""
    rng = np.random.RandomState(12)
    s = 40
    h_full = rng.randn(2, s, cfg.encoder.dim).astype(np.float32)
    batch_out = tenc.encoder_forward(params["encoder"], cfg,
                                     torch.from_numpy(h_full[0]))
    chunks, n_valids, pos = [], [], [0, 0]
    for size0, size1 in ((16, 9), (8, 16), (16, 0)):
        chunk = np.full((2, 16, cfg.encoder.dim), 1e3, np.float32)
        for b, size in enumerate((size0, size1)):
            chunk[b, :size] = h_full[b, pos[b]:pos[b] + size]
            pos[b] += size
        chunks.append(chunk)
        n_valids.append(np.array([size0, size1], np.int32))
    outs, jouts, st, js = _run_both(cfg, tiny_cfg, params, tiny_params, chunks,
                                    ring_size=48, batch=2, n_valids=n_valids)
    inc = np.concatenate([o[0, :n[0]] for o, n in zip(outs, n_valids)])
    np.testing.assert_allclose(inc, batch_out.numpy(), atol=3e-5, rtol=1e-4)
    for o, j, n in zip(outs, jouts, n_valids):
        for b in range(2):
            np.testing.assert_allclose(o[b, :n[b]], j[b, :n[b]], atol=1e-5, rtol=1e-5)
    _assert_rings_match(st, js)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_incremental_encoder_quantized_rings_match_jax(cfg, tiny_cfg, params,
                                                       tiny_params, kv):
    """int8 and int4-packed encoder rings (ring wrap included): outputs
    within 1e-5 of the JAX encoder on the same state and params, rings and
    scales equal to JAX's, and within quantization tolerance of the batch
    forward."""
    rng = np.random.RandomState(11)
    s = 96
    h_full = rng.randn(s, cfg.encoder.dim).astype(np.float32)
    batch_out = tenc.encoder_forward(params["encoder"], cfg, torch.from_numpy(h_full))
    chunks, pos = [], 0
    for size in (5, 1, 17, 3, 30, 40):
        chunks.append(h_full[None, pos:pos + size])
        pos += size
    outs, jouts, st, js = _run_both(cfg, tiny_cfg, params, tiny_params, chunks,
                                    ring_size=64, kv_dtype=kv)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o, j, atol=1e-5, rtol=1e-5)
    _assert_rings_match(st, js)
    inc = np.concatenate([o[0] for o in outs])
    err = np.abs(inc - batch_out.numpy()).max()
    assert err < (0.05 if kv == "int8" else 0.6), (kv, err)
    width = cfg.encoder.attn_dim // (2 if kv == "int4" else 1)
    assert st.k_ring[0].shape[-1] == width and st.k_ring[0].dtype == torch.int8


def test_encoder_int8_rings_track_float(cfg, params):
    """Mirror of tests/test_int8_kv.py: int8 rings track float rings."""
    rng = np.random.RandomState(1)
    b, s = 2, 8
    chunks = [torch.from_numpy(rng.randn(b, s, cfg.encoder.dim).astype(np.float32) * 0.3)
              for _ in range(4)]
    outs = {}
    for mode in ("float", "int8"):
        st = tenc.init_encoder_state(cfg, ring_size=48, batch=b, pending_size=8,
                                     kv_dtype=mode, device=CPU)
        acc = []
        for c in chunks:
            st, out = tenc.encoder_incremental(params["encoder"], cfg, st, c)
            acc.append(out.numpy())
        outs[mode] = np.concatenate(acc, axis=1)
    rel = np.abs(outs["int8"] - outs["float"]).max() / np.abs(outs["float"]).max()
    assert rel < 0.05, rel


def test_encoder_state_layout_and_reset_match_jax(cfg, tiny_cfg):
    """init_encoder_state's clamp and 32-row alignment, and
    reset_encoder_streams, as the JAX package's."""
    for kv in ("float", "int8", "int4"):
        st = tenc.init_encoder_state(cfg, ring_size=50, batch=3, pending_size=40,
                                     kv_dtype=kv, device=CPU)
        js = jenc.init_encoder_state(tiny_cfg, ring_size=50, batch=3,
                                     pending_size=40, kv_dtype=kv)
        for name in ("k_ring", "pending_k") + (("k_scale", "pending_ks")
                                               if kv != "float" else ()):
            assert tuple(getattr(st, name)[0].shape) == getattr(js, name)[0].shape, name
        assert tuple(st.slot_pos.shape) == js.slot_pos.shape
    with pytest.raises(ValueError, match="kv_dtype"):
        tenc.init_encoder_state(cfg, kv_dtype="int2", device=CPU)
    st = st._replace(slot_pos=torch.arange(3 * st.slot_pos.shape[1], dtype=torch.int32)
                     .reshape(3, -1), next_pos=torch.tensor([5, 6, 7], dtype=torch.int32),
                     write_ctr=torch.tensor(9, dtype=torch.int32))
    js = js._replace(slot_pos=jnp.asarray(st.slot_pos.numpy()),
                     next_pos=jnp.asarray([5, 6, 7], jnp.int32), write_ctr=jnp.int32(9))
    mask = np.array([False, True, False])
    for full in (False, True):
        r = tenc.reset_encoder_streams(st, torch.from_numpy(mask), reset_write_ctr=full)
        jr = jenc.reset_encoder_streams(js, jnp.asarray(mask), reset_write_ctr=full)
        for name in ("slot_pos", "pending_sp", "pending_adv", "write_ctr", "next_pos"):
            np.testing.assert_array_equal(getattr(r, name).numpy(),
                                          np.asarray(getattr(jr, name)), err_msg=name)


def test_incremental_encoder_refuses_oversized_chunks(cfg):
    st = tenc.init_encoder_state(cfg, ring_size=48, pending_size=8, device=CPU)
    with pytest.raises(ValueError, match="pending capacity"):
        tenc.encoder_incremental({"layers": ()}, cfg, st,
                                 torch.zeros(1, 9, cfg.encoder.dim))
    with pytest.raises(ValueError, match="exceeds ring"):
        tenc.encoder_incremental({"layers": ()}, cfg, st,
                                 torch.zeros(1, 40, cfg.encoder.dim))


def test_init_encoder_state_default_device_needs_cuda(cfg):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.init_encoder_state(cfg)

