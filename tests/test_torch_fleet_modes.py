"""The port's serving step (voxtral_tpu_torch.runtime.fleet.fleet_step_masked)
against the JAX package's over a bootstrap and 12 masked steps, in the three
ring modes (float; int8; int8 decoder with int4 encoder rings) and in the
headline serving mode (Q8 weights with int8 + int4 rings), tiny config,
f32 on the CPU: an inactive stream every fourth step, forced tokens, the
f32 and the s16 wire. JAX runs the Pallas kernel in interpret mode for
quantized rings; the port runs the ring attention's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.audio.mel import pad_audio_offline
from voxtral_tpu.models.decoder import ada_scales as jax_ada_scales
from voxtral_tpu.models.decoder import time_conditioning as jax_time_conditioning
from voxtral_tpu.quant import quantize_params as jax_quantize_params
from voxtral_tpu.runtime import fleet as jf
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
from voxtral_tpu_torch.runtime import fleet as tf
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

MODES = {"float": ("float", None), "int8": ("int8", None),
         "int8+int4": ("int8", "int4"), "q8+int8+int4": ("int8", "int4")}
T0, T = 320, 64                    # bootstrap and step chunks (mel frames)


@pytest.fixture(scope="module")
def setup(tiny_cfg, tiny_params):
    cfg = tiny_config()
    params = from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), "cpu")
    d = cfg.decoder
    t_ada = ada_scales(params["decoder"], time_conditioning(6, d.dim))
    j_ada = jax_ada_scales(tiny_params["decoder"], jax_time_conditioning(6, d.dim))
    rng = np.random.RandomState(0)
    audio = [(rng.randn(8 * 16000) * 0.3).astype(np.float32) for _ in range(2)]
    streams = np.stack([jf.pcm_stream(pad_audio_offline(a, tiny_cfg.audio,
                                                        tiny_cfg.streaming), tiny_cfg)
                        for a in audio])
    streams = np.round(streams * 32768.0) / 32768.0     # the s16 wire is exact
    return cfg, params, t_ada, j_ada, streams.astype(np.float32)


@pytest.fixture(scope="module")
def q8_params(tiny_cfg):
    """The JAX package's Q8 tree of the same random params (quantized from
    a numpy tree, so no session fixture's buffers are donated), and the
    port's copy of it. The ada MLPs stay float: t_ada is unchanged."""
    tree = jax_random_params(tiny_cfg, 1234, numpy_out=True)
    jq = jax_quantize_params(jax.tree.map(jnp.asarray, tree))
    return from_numpy_params(jq, "cpu"), jq


def _step_inputs(step, pcm, n):
    """Stream 1 idles every fourth step; forced tokens on steps 3 and 8;
    odd steps ride the packed wire (s16 on steps 1 mod 4, else f32)."""
    active = np.array([True, step % 4 != 2])
    forced = np.full((2, n), -1, np.int32)
    if step == 3:
        forced[1, 2] = 77
    if step == 8:
        forced[0, 0] = 5
    wire = None
    if step % 2:
        wire = jf.pack_wire(np.round(pcm * 32768.0).astype(np.int16)
                            if step % 4 == 1 else pcm, active, forced)
    return active, forced, wire


@pytest.mark.parametrize("mode", list(MODES))
def test_fleet_step_masked_matches_jax(setup, q8_params, tiny_cfg, tiny_params, mode):
    cfg, params, t_ada, j_ada, streams = setup
    if mode.startswith("q8"):
        params, tiny_params = q8_params
    kv, ekv = MODES[mode]
    hop, n = cfg.audio.hop_length, T // 8
    kw = dict(enc_ring=64, dec_ring=64, max_mel_chunk=T, kv_dtype=kv,
              enc_kv_dtype=ekv)
    js = jf.init_fleet_state(tiny_cfg, 2, **kw)
    ts = tf.init_fleet_state(cfg, 2, device="cpu", **kw)
    boot = np.ascontiguousarray(streams[:, :T0 * hop])
    js, jt, _ = jf.fleet_bootstrap_pcm(tiny_params, tiny_cfg, js, jnp.asarray(boot), j_ada)
    ts, tt, _ = tf.fleet_bootstrap_pcm(params, cfg, ts, torch.from_numpy(boot), t_ada)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    pos = T0 * hop
    for step in range(12):
        pcm = np.ascontiguousarray(streams[:, pos:pos + T * hop])
        pos += T * hop
        active, forced, wire = _step_inputs(step, pcm, n)
        if wire is None:
            js, jt, jaux = jf.fleet_step_masked(
                tiny_params, tiny_cfg, js, jnp.asarray(pcm), jnp.asarray(active),
                jnp.asarray(forced), j_ada, collect_topk=2)
            ts, tt, aux = tf.fleet_step_masked(
                params, cfg, ts, torch.from_numpy(pcm), torch.from_numpy(active),
                torch.from_numpy(forced), t_ada, collect_topk=2)
        else:
            js, jt, jaux = jf.fleet_step_masked(
                tiny_params, tiny_cfg, js, jnp.asarray(wire), None, None, j_ada,
                collect_topk=2, wire_packed=True)
            ts, tt, aux = tf.fleet_step_masked(
                params, cfg, ts, torch.from_numpy(wire), None, None, t_ada,
                collect_topk=2, wire_packed=True)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {step}")
        if not active[1]:
            assert (tt.numpy()[1] == -1).all()
        np.testing.assert_allclose(aux["best_logit"].numpy(), np.asarray(jaux["best_logit"]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
    assert int(tt.numpy()[0, 0]) >= 0
    for part, names in (("encoder", ("slot_pos", "pending_sp", "write_ctr",
                                     "pending_adv", "next_pos")),
                        ("decode", ("slot_pos", "pending_sp", "write_ctr",
                                    "pending_adv", "pos", "prev_token", "done"))):
        for name in names:
            np.testing.assert_array_equal(
                getattr(getattr(ts, part), name).numpy(),
                np.asarray(getattr(getattr(js, part), name)), err_msg=f"{part}.{name}")
    for name in ("pcm_tail", "mel_tail", "conv0_tail"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # Quantized rings: equal to JAX's codes up to rare one-step flips where
    # a value lies within an ulp of a rounding boundary (the two frameworks'
    # matmuls sum in different orders).
    for part in ("encoder", "decode"):
        for name in ("k_ring", "v_ring"):
            for t, j in zip(getattr(getattr(ts, part), name),
                            getattr(getattr(js, part), name)):
                t, j = t.numpy(), np.asarray(j)
                assert t.dtype == j.dtype and t.shape == j.shape
                if t.dtype != np.int8:
                    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
                    continue
                diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
                assert diff.max() <= 1 and np.count_nonzero(diff) <= diff.size // 1000
