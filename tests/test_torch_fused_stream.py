"""The port's fused VoxStream backend (StreamConfig(backend="fused"): a
B = 1 FleetManager) against the JAX package's, on the CPU, tiny config,
f32: every scenario of tests/test_fused_stream.py, with the same calls on
both streams (`Pair` of tests/test_torch_stream.py: greedy stream, queue,
monitor symbols and stats counters exactly equal), and in the port fused ==
bucketed == the offline pipeline. The bucketed side's mel is pinned to
numpy (VOX_NATIVE=0); the fused side computes its mel on the device."""

import numpy as np
import pytest
import torch

import voxtral_tpu.runtime.manager as jax_manager
import voxtral_tpu_torch.runtime.manager as port_manager
from test_torch_stream import Pair, _lively
from voxtral_tpu.tokenizer import make_test_tokenizer_json
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.runtime import StreamConfig, VoxStream
from voxtral_tpu_torch.weights import from_numpy_params, random_params_host

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def numpy_mel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOX_NATIVE", "0")
        yield


@pytest.fixture(scope="module")
def weights(tiny_params):
    import jax
    import jax.numpy as jnp
    live = _lively(jax_random_params(tiny_config(), 1234, numpy_out=True))
    return {"random": (tiny_params, random_params_host(tiny_config(), 1234,
                                                       device="cpu")),
            "lively": (jax.tree.map(jnp.asarray, live),
                       from_numpy_params(live, "cpu"))}


@pytest.fixture(scope="module")
def audio():
    rng = np.random.RandomState(21)
    return (rng.randn(3 * 16000) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def batch_tokens(weights, audio):
    toks, _ = transcribe_tokens_batch(weights["random"][1], tiny_config(), audio,
                                      device="cpu")
    assert len(toks) > 10
    return toks


def _port(params, audio, backend, chunk_sizes=(1600,), **sc_kw):
    s = VoxStream(params, tiny_config(), stream_cfg=StreamConfig(
        interval=sc_kw.pop("interval", 0.5), backend=backend,
        monitor_slow_ms=1e9, **sc_kw), device="cpu")
    pos, i = 0, 0
    while pos < len(audio):
        n = min(chunk_sizes[i % len(chunk_sizes)], len(audio) - pos)
        s.feed(audio[pos:pos + n])
        pos += n
        i += 1
    s.finish()
    return s


def _fused(w, audio, chunk_sizes=(1600,), **sc_kw):
    p = Pair(w, backend="fused", **{"interval": 0.5, **sc_kw})
    p.feed_all(audio, chunk_sizes)
    p.check()
    p.finish()
    p.check()
    return p


@pytest.mark.parametrize("chunks,interval", [
    ((1600,), 0.5), ((160, 1280, 7, 4096, 999, 16000), 2.0)])
def test_fused_equals_jax_bucketed_and_batch(weights, audio, batch_tokens, chunks,
                                             interval):
    p = _fused(weights["random"], audio, chunks, interval=interval)
    assert p.t.backend == "fused" and p.t.generated_ids == batch_tokens
    b = _port(weights["random"][1], audio, "bucketed", chunks, interval=interval)
    assert b.generated_ids == batch_tokens


def test_fused_flush_midstream_matches_bucketed(weights, audio):
    """flush() pads become part of the stream; feeding continues after.
    The device-mel fused path may be one token fresher at the flush point
    than the host MelStream, which holds back the last partial window."""
    p = Pair(weights["random"], backend="fused", interval=0.5)
    p.feed(audio[:16000])
    p.flush()
    nb = p.check().n_generated
    p.feed(audio[16000:])
    p.finish()
    p.check()
    a = VoxStream(weights["random"][1], tiny_config(), stream_cfg=StreamConfig(
        interval=0.5, backend="bucketed"), device="cpu")
    a.feed(audio[:16000])
    a.flush()
    na = a.n_generated
    a.feed(audio[16000:])
    a.finish()
    assert a.generated_ids == p.t.generated_ids
    assert na > 0 and nb > 0 and abs(na - nb) <= 1


def test_fused_set_interval_midstream(weights, audio, batch_tokens):
    p = Pair(weights["random"], backend="fused", interval=0.5)
    p.feed(audio[:24000])
    p.set_interval(2.0)
    assert p.t._mgr.n == p.j._mgr.n == 25
    p.feed(audio[24000:])
    p.finish()
    assert p.check().generated_ids == batch_tokens


def test_fused_alt_queue_matches_bucketed(weights, audio, tmp_path):
    """Alt-tokens with a tokenizer on the lively weights: fused == JAX fused
    (queue with pieces and alts) and == the port's bucketed stream."""
    tok = str(tmp_path / "tekken.json")
    make_test_tokenizer_json(tok, vocab_size=256)
    p = Pair(weights["lively"], tok, backend="fused", interval=0.5, n_alt=3,
             alt_cutoff=0.95)
    p.feed_all(audio, (1600,))
    p.finish()
    f = p.check()
    b = Pair(weights["lively"], tok, interval=0.5, n_alt=3, alt_cutoff=0.95)
    b.feed_all(audio, (1600,))
    b.finish()
    b = b.check()
    assert f.generated_ids == b.generated_ids
    assert [(q[0], q[1]) for q in f.queue] == [(q[0], q[1]) for q in b.queue]
    assert [[j for j, _ in q[2]] for q in f.queue] == [[j for j, _ in q[2]] for q in b.queue]
    assert f.n_text_tokens > 0 and any(q[2] for q in f.queue)


def test_fused_continuous_watchdog_restart(weights, audio, monkeypatch):
    for mod in (jax_manager, port_manager):
        monkeypatch.setattr(mod, "MAX_DECODE_KV", 45)
    p = _fused(weights["random"], audio, continuous=True, monitor=True)
    t = p.t
    assert any(sym.startswith("⟳") for sym in t.monitor_log), t.monitor_log
    assert t.stats()["restarts"] > 0 and t.n_generated > 16


def test_fused_set_delay_matches_fresh(weights, audio):
    a = Pair(weights["random"], backend="fused", interval=1.0, delay_tokens=12)
    b = Pair(weights["random"], backend="fused", interval=1.0)
    b.set_delay(12 * 80)
    for s in (a, b):
        s.feed(audio)
        s.finish()
    assert a.check().generated_ids == b.check().generated_ids


def test_fused_stats_shape(weights, audio):
    t = _fused(weights["random"], audio).t
    st = t.stats()
    assert st["generated"] == t.n_generated > 0 and st["decoder_ms"] > 0
    assert st["encoder_ms"] is None and st["prefill_ms"] is None
    assert st["step_ms_includes_encoder"] is True
    assert st["mel_frames"] == t._mgr.slots[0].samples_done \
        // tiny_config().audio.hop_length > 0


def test_fused_enc_kv_int4_serving_config(weights, audio, batch_tokens):
    """int8 decoder rings + int4-packed encoder rings through the public
    StreamConfig: packed rings, and the tokens of the batch pipeline."""
    p = _fused(weights["random"], audio, kv_dtype="int8", enc_kv_dtype="int4")
    t = p.t
    enc, dec = t._mgr.state.encoder, t._mgr.state.decode
    assert enc.k_ring[0].shape[-1] == tiny_config().encoder.attn_dim // 2
    assert enc.k_ring[0].dtype == torch.int8
    assert dec.k_ring[0].dtype == torch.int8 and dec.k_scale is not None
    assert t.generated_ids == batch_tokens


def test_bucketed_backend_warns_on_kv_dtype(weights):
    params = weights["random"][1]
    for kw in (dict(kv_dtype="int8"), dict(enc_kv_dtype="int4")):
        with pytest.warns(UserWarning, match="fused-backend"):
            VoxStream(params, tiny_config(), stream_cfg=StreamConfig(
                backend="bucketed", **kw), device="cpu")


def test_auto_backend_follows_device(weights):
    """auto: bucketed on the CPU (fused on a CUDA device)."""
    s = VoxStream(weights["random"][1], tiny_config(), device="cpu")
    assert s.backend == "bucketed" and s._mgr is None
    with pytest.raises(ValueError, match="backend"):
        VoxStream(weights["random"][1], tiny_config(),
                  stream_cfg=StreamConfig(backend="tpu"), device="cpu")


def test_fused_finish_fails_loud_without_progress(weights, audio, monkeypatch):
    s = VoxStream(weights["random"][1], tiny_config(), stream_cfg=StreamConfig(
        backend="fused", interval=0.5), device="cpu")
    s.feed(audio[:16000])
    monkeypatch.setattr(s._mgr, "poll", lambda: 0)
    with pytest.raises(RuntimeError, match="did not drain"):
        s.finish()


def test_reference_fused_flush_adds_the_skew_of_silence(weights, audio):
    """A fault of the JAX package the port keeps (ROADMAP Queue 3): the
    fused flush pads the manager's buffer, which runs pcm_stream_skew (40)
    samples behind the audio, to a token boundary, so it inserts 40 samples
    more silence than the bucketed flush. On weights whose tokens follow
    the audio the two backends then differ after a mid-stream flush (the
    random tree above locks onto one token and hides it). Each backend
    equals the JAX package's, and the bucketed stream with those 40 zero
    samples fed to its mel equals the fused one."""
    from voxtral_tpu_torch.runtime import pcm_stream_skew

    def flushed(p, skew_pad=0):
        p.feed(audio[:16000])
        p.feed(audio[16000:32000])
        p.flush()
        if skew_pad:
            p.mel.feed(np.zeros(skew_pad, np.float32))
        p.feed(audio[32000:])
        p.finish()
        return p

    fused = flushed(Pair(weights["lively"], backend="fused", interval=0.5))
    bucketed = flushed(Pair(weights["lively"], interval=0.5))
    fused, bucketed = fused.check().generated_ids, bucketed.check().generated_ids
    first = next(i for i, (a, b) in enumerate(zip(fused, bucketed)) if a != b)
    assert first == 49, first
    padded = VoxStream(weights["lively"][1], tiny_config(), device="cpu",
                       stream_cfg=StreamConfig(interval=0.5, backend="bucketed"))
    assert flushed(padded, pcm_stream_skew(tiny_config())).generated_ids == fused
