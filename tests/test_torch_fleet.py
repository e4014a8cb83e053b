"""The port's fleet step (voxtral_tpu_torch.runtime.fleet) on the CPU, tiny
config, f32: device mel, the PCM and host-mel entry points, the split
bootstrap against the offline pipeline, int4 encoder rings, the wire, slot
resets and state ageing — each against the JAX package's counterpart
(mirrors tests/test_fleet_pcm.py). The masked serving step in the three ring
modes is in tests/test_torch_fleet_modes.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtral_tpu.audio.mel import batch_log_mel, pad_audio_offline
from voxtral_tpu.models.decoder import ada_scales as jax_ada_scales
from voxtral_tpu.models.decoder import time_conditioning as jax_time_conditioning
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu.runtime import fleet as jf
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.runtime import fleet as tf
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(tiny_cfg):
    return from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), CPU)


@pytest.fixture(scope="module")
def adas(cfg, params, tiny_cfg, tiny_params):
    d = cfg.streaming.delay_tokens
    return (ada_scales(params["decoder"], time_conditioning(d, cfg.decoder.dim)),
            jax_ada_scales(tiny_params["decoder"],
                           jax_time_conditioning(d, tiny_cfg.decoder.dim)))


def _stream(cfg, seconds, seed):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(int(seconds * 16000)) * 0.3).astype(np.float32)
    padded = pad_audio_offline(audio, cfg.audio, cfg.streaming)
    return audio, padded, np.ascontiguousarray(tf.pcm_stream(padded, cfg))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_device_mel_matches_batch_and_jax(cfg, tiny_cfg):
    """Chunked device mel over the padded stream equals batch_log_mel of
    the whole signal (as tests/test_fleet_pcm.py) and the JAX device mel."""
    _, padded, stream = _stream(cfg, 3, 0)
    ref = batch_log_mel(padded, tiny_cfg.audio)
    hop = cfg.audio.hop_length
    lap = cfg.audio.window_size - hop
    tail, jtail = torch.zeros((1, lap)), jnp.zeros((1, lap), jnp.float32)
    chunks, jchunks, step = [], [], 64 * hop
    for i in range(0, (len(stream) // step) * step, step):
        mel, tail = tf._device_log_mel(cfg, tail, _t(stream[None, i:i + step]))
        jmel, jtail = jf._device_log_mel(tiny_cfg, jtail,
                                         jnp.asarray(stream[None, i:i + step]))
        chunks.append(mel[0].numpy())
        jchunks.append(np.asarray(jmel[0]))
    got = np.concatenate(chunks, axis=1)
    np.testing.assert_allclose(got, ref[:, :got.shape[1]], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.concatenate(jchunks, axis=1), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_fleet_pcm_tokens_match_host_mel_and_jax(cfg, tiny_cfg, params, tiny_params, adas):
    """fleet_bootstrap_pcm + fleet_step_pcm give the tokens of the host-mel
    entry points (fleet_bootstrap + fleet_step) fed batch mel of the same
    audio (>= 98% agreement, as the JAX test), and exactly the JAX PCM
    fleet's tokens."""
    t_ada, j_ada = adas
    _, padded, stream = _stream(cfg, 4, 1)
    hop = cfg.audio.hop_length
    T0, T = 320, 160
    mel_full = batch_log_mel(padded, tiny_cfg.audio)
    n_steps = (min(mel_full.shape[1], len(padded) // hop) - T0) // T
    kw = dict(enc_ring=256, dec_ring=128, max_mel_chunk=T0)
    st = tf.init_fleet_state(cfg, 1, device=CPU, **kw)
    js = jf.init_fleet_state(tiny_cfg, 1, **kw)
    st, t, _ = tf.fleet_bootstrap_pcm(params, cfg, st, _t(stream[None, :T0 * hop]), t_ada)
    js, jt, _ = jf.fleet_bootstrap_pcm(tiny_params, tiny_cfg, js,
                                       jnp.asarray(stream[None, :T0 * hop]), j_ada)
    pcm_toks, jax_toks = [t.numpy()], [np.asarray(jt)]
    for c in range(n_steps):
        s0 = (T0 + c * T) * hop
        st, t, _ = tf.fleet_step_pcm(params, cfg, st, _t(stream[None, s0:s0 + T * hop]),
                                     t_ada)
        js, jt, _ = jf.fleet_step_pcm(tiny_params, tiny_cfg, js,
                                      jnp.asarray(stream[None, s0:s0 + T * hop]), j_ada)
        pcm_toks.append(t.numpy())
        jax_toks.append(np.asarray(jt))
    st = tf.init_fleet_state(cfg, 1, device=CPU, **kw)
    st, t, _ = tf.fleet_bootstrap(params, cfg, st, _t(mel_full[None, :, :T0]), t_ada)
    mel_toks = [t.numpy()]
    for c in range(n_steps):
        f0 = T0 + c * T
        st, t, _ = tf.fleet_step(params, cfg, st, _t(mel_full[None, :, f0:f0 + T]), t_ada)
        mel_toks.append(t.numpy())
    t_pcm, t_mel = np.concatenate(pcm_toks, 1)[0], np.concatenate(mel_toks, 1)[0]
    np.testing.assert_array_equal(t_pcm, np.concatenate(jax_toks, 1)[0])
    assert t_pcm.shape == t_mel.shape
    assert (t_pcm == t_mel).mean() >= 0.98, (t_pcm, t_mel)


def test_fleet_split_bootstrap_matches_batch_pipeline(cfg, tiny_cfg, params,
                                                      tiny_params, adas):
    """With max_mel_chunk=160 the 320-mel bootstrap runs its encoder in two
    pending-sized sub-chunks and still gives the offline pipeline's greedy
    tokens (port and JAX pipelines agree too)."""
    t_ada, _ = adas
    audio, _, stream = _stream(cfg, 3, 8)
    want, _ = transcribe_tokens_batch(params, cfg, audio, device=CPU)
    assert want == [int(x) for x in jax_transcribe(tiny_params, tiny_cfg, audio)[0]]
    assert len(want) > 10
    hop = cfg.audio.hop_length
    T0, T = 320, 160
    st = tf.init_fleet_state(cfg, 1, enc_ring=256, dec_ring=128, max_mel_chunk=T,
                             device=CPU)
    assert st.encoder.pending_sp.shape[1] < T0 // 2      # the split is exercised
    st, t, _ = tf.fleet_bootstrap_pcm(params, cfg, st, _t(stream[None, :T0 * hop]), t_ada)
    out = [int(x) for x in t.numpy()[0] if x >= 0]
    pos = T0 * hop
    while pos + T * hop <= len(stream):
        st, t, _ = tf.fleet_step_pcm(params, cfg, st, _t(stream[None, pos:pos + T * hop]),
                                     t_ada)
        out += [int(x) for x in t.numpy()[0] if x >= 0]
        pos += T * hop
    assert out == want[:len(out)]
    assert len(out) >= len(want) - T // 8                # tail loses < one chunk


def test_fleet_int4_encoder_rings_run_and_track_int8(cfg, tiny_cfg, params,
                                                     tiny_params, adas):
    """enc_kv_dtype="int4" (packed encoder rings, float decoder rings): the
    step runs end to end, its tokens equal the JAX fleet's, and the stream
    tracks the int8-ring stream (> 90% agreement, as the JAX test)."""
    t_ada, j_ada = adas
    rng = np.random.RandomState(0)
    hop = cfg.audio.hop_length
    pcm0 = (rng.rand(1, 320 * hop) - 0.5).astype(np.float32)
    pcm = (rng.rand(1, 40 * hop) - 0.5).astype(np.float32)
    streams = {}
    for enc_kv in ("int8", "int4"):
        kw = dict(enc_ring=48, dec_ring=None, max_mel_chunk=320, kv_dtype="float",
                  enc_kv_dtype=enc_kv)
        st = tf.init_fleet_state(cfg, 1, device=CPU, **kw)
        js = jf.init_fleet_state(tiny_cfg, 1, **kw)
        st, t, _ = tf.fleet_bootstrap_pcm(params, cfg, st, _t(pcm0), t_ada)
        js, jt, _ = jf.fleet_bootstrap_pcm(tiny_params, tiny_cfg, js, jnp.asarray(pcm0),
                                           j_ada)
        toks, jtoks = [t.numpy()], [np.asarray(jt)]
        for _ in range(3):
            st, t, _ = tf.fleet_step_pcm(params, cfg, st, _t(pcm), t_ada)
            js, jt, _ = jf.fleet_step_pcm(tiny_params, tiny_cfg, js, jnp.asarray(pcm), j_ada)
            toks.append(t.numpy())
            jtoks.append(np.asarray(jt))
        toks = np.concatenate(toks, 1)[0]
        np.testing.assert_array_equal(toks, np.concatenate(jtoks, 1)[0])
        streams[enc_kv] = [int(x) for x in toks if x >= 0]
        if enc_kv == "int4":
            assert st.encoder.k_ring[0].shape[-1] == cfg.encoder.attn_dim // 2
    a, b = streams["int8"], streams["int4"]
    assert len(a) == len(b) > 10
    assert sum(x == y for x, y in zip(a, b)) / len(a) > 0.9


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_wire_roundtrip_matches_jax(cfg, tiny_cfg, dtype):
    """pack_wire equals the JAX package's; _unpack_wire recovers pcm, active
    and forced exactly (forced ids past 2^16 and -1 included on s16)."""
    rng = np.random.RandomState(2)
    hop, n = cfg.audio.hop_length, 8
    pcm = rng.randn(3, n * 8 * hop).astype(np.float32)
    if dtype == np.int16:
        pcm = (pcm * 1000).astype(np.int16)
    active = np.array([True, False, True])
    forced = np.full((3, n), -1, np.int32)
    forced[0, 1], forced[2, 7] = 131071, 70000
    wire = tf.pack_wire(pcm, active, forced)
    np.testing.assert_array_equal(wire, jf.pack_wire(pcm, active, forced))
    p, a, f = tf._unpack_wire(cfg, _t(wire))
    jp, ja, jfz = jf._unpack_wire(tiny_cfg, jnp.asarray(wire))
    np.testing.assert_array_equal(p.numpy(), pcm)
    np.testing.assert_array_equal(a.numpy(), active)
    np.testing.assert_array_equal(f.numpy(), forced)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jfz))
    assert f.dtype == torch.int32 and a.dtype == torch.bool


def test_fleet_reset_slots_and_age_match_jax(cfg, tiny_cfg, params, tiny_params, adas):
    """fleet_reset_slots (decoder-only and full) and age_fleet_state give
    the JAX package's slot tables, cursors and tails on a fleet that has
    run a bootstrap and a step."""
    t_ada, j_ada = adas
    hop = cfg.audio.hop_length
    _, _, stream = _stream(cfg, 3, 4)
    streams = np.stack([stream, stream[::-1]])[:, :400 * hop].copy()
    kw = dict(enc_ring=64, dec_ring=64, max_mel_chunk=320, kv_dtype="int8")
    st = tf.init_fleet_state(cfg, 2, device=CPU, **kw)
    js = jf.init_fleet_state(tiny_cfg, 2, **kw)
    st, _, _ = tf.fleet_bootstrap_pcm(params, cfg, st, _t(streams[:, :320 * hop]), t_ada)
    js, _, _ = jf.fleet_bootstrap_pcm(tiny_params, tiny_cfg, js,
                                      jnp.asarray(streams[:, :320 * hop]), j_ada)
    st, _, _ = tf.fleet_step_pcm(params, cfg, st, _t(streams[:, 320 * hop:]), t_ada)
    js, _, _ = jf.fleet_step_pcm(tiny_params, tiny_cfg, js,
                                 jnp.asarray(streams[:, 320 * hop:]), j_ada)

    def same(a, b):
        for part, names in (("encoder", ("slot_pos", "pending_sp", "write_ctr",
                                         "pending_adv", "next_pos")),
                            ("decode", ("slot_pos", "pending_sp", "write_ctr",
                                        "pending_adv", "pos", "prev_token", "done"))):
            for name in names:
                np.testing.assert_array_equal(
                    getattr(getattr(a, part), name).numpy(),
                    np.asarray(getattr(getattr(b, part), name)), err_msg=f"{part}.{name}")
        for name in ("pcm_tail", "mel_tail", "conv0_tail"):
            np.testing.assert_allclose(getattr(a, name).numpy(),
                                       np.asarray(getattr(b, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=name)

    same(st, js)
    mask = np.array([False, True])
    for full in (False, True):
        r = tf.fleet_reset_slots(cfg, st, _t(mask), full=full)
        fresh = jax.tree_util.tree_map(jnp.copy, js)    # the JAX reset donates
        same(r, jf.fleet_reset_slots(tiny_cfg, fresh, jnp.asarray(mask), full=full))
        if full:
            assert (r.pcm_tail[1] == 0).all() and (r.conv0_tail[1] == 0).all()
    same(tf.age_fleet_state(cfg, st, 4096), jf.age_fleet_state(tiny_cfg, js, 4096))
    with pytest.raises(ValueError, match="do not wrap"):
        tf.age_fleet_state(cfg, st, 3)


def test_fleet_entry_points_need_cuda_by_default(cfg):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_fleet_state(cfg, 1)
