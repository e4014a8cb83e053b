"""The port's VoxStream (voxtral_tpu_torch.runtime.stream) on the bucketed
backend against the JAX package's, on the CPU, tiny config, f32: every
scenario of tests/test_streaming.py, with the same calls on both streams.

Both must agree exactly on the full greedy stream (`generated_ids`), the
text queue (ids, pieces, alt lists), the monitor symbols (with
`monitor_slow_ms=1e9`, so wall time never enters, except where a test sets
0, which makes every decode batch slow) and stats()'s counters (not its
times). The port's stream must also equal the port's offline pipeline.
The mel backend is pinned to numpy on both sides (VOX_NATIVE=0; one case
runs both native bindings, which give the same bits). Weights: the seeded
random tree, and the same tree with the embedding rows normalized and the
adapter amplified (`lively`), whose tokens follow the audio, with a test
tokenizer and alt-tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxtral_tpu.runtime.stream as jax_stream
import voxtral_tpu_torch.runtime.stream as port_stream
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_batch
from voxtral_tpu.tokenizer import Tokenizer as JaxTokenizer
from voxtral_tpu.tokenizer import make_test_tokenizer_json
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.tokenizer import Tokenizer
from voxtral_tpu_torch.weights import from_numpy_params, random_params_host

torch.set_num_threads(2)

COUNTERS = ("mel_frames", "text_tokens", "generated", "audio_s", "restarts")


@pytest.fixture(scope="module", autouse=True)
def numpy_mel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOX_NATIVE", "0")
        yield


def _lively(tree):
    """Embedding rows normalized and the adapter amplified, so greedy
    tokens follow the audio (tests/test_manager.py:406-412)."""
    emb = np.asarray(tree["decoder"]["embed"], np.float32)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True) * 0.05
    adapter = {k: np.asarray(v, np.float32) * 4.0
               for k, v in tree["adapter"].items()}
    return {**tree, "adapter": adapter,
            "decoder": {**tree["decoder"], "embed": emb}}


@pytest.fixture(scope="module")
def weights(tiny_params):
    """name -> (JAX params, port params) of the same values."""
    tree = jax_random_params(tiny_config(), 1234, numpy_out=True)
    live = _lively(tree)
    return {"random": (tiny_params, random_params_host(tiny_config(), 1234,
                                                       device="cpu")),
            "lively": (jax.tree.map(jnp.asarray, live),
                       from_numpy_params(live, "cpu"))}


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "tekken.json"
    make_test_tokenizer_json(str(p), vocab_size=256)
    return str(p)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.RandomState(21)
    return (rng.randn(3 * 16000) * 0.3).astype(np.float32)


class Pair:
    """The JAX stream and the port's (device="cpu"; bucketed unless the
    fields say otherwise), built with the same StreamConfig fields; a call
    on the pair calls both."""

    def __init__(self, w, tok_path=None, **sc_kw):
        sc_kw = {"monitor_slow_ms": 1e9, "backend": "bucketed", **sc_kw}
        self.j = jax_stream.VoxStream(
            w[0], jax_stream_cfg(), tokenizer=JaxTokenizer(tok_path) if tok_path else None,
            stream_cfg=jax_stream.StreamConfig(**sc_kw))
        self.t = port_stream.VoxStream(
            w[1], tiny_config(), tokenizer=Tokenizer(tok_path) if tok_path else None,
            stream_cfg=port_stream.StreamConfig(**sc_kw), device="cpu")

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)

        def both(*args, **kwargs):
            rj, rt = fj(*args, **kwargs), ft(*args, **kwargs)
            assert rj == rt, (name, rj, rt)
            return rt
        return both

    def set(self, **fields):
        for k, v in fields.items():
            setattr(self.j, k, v)
            setattr(self.t, k, v)

    def feed_all(self, audio, chunk_sizes):
        pos, i = 0, 0
        while pos < len(audio):
            n = min(chunk_sizes[i % len(chunk_sizes)], len(audio) - pos)
            self.feed(audio[pos:pos + n])
            pos += n
            i += 1

    def check(self):
        j, t = self.j, self.t
        assert t.generated_ids == j.generated_ids
        assert t.queue == j.queue
        assert t.monitor_log == j.monitor_log
        for f in ("n_generated", "n_text_tokens", "eos_seen", "real_samples_fed"):
            assert getattr(t, f) == getattr(j, f), f
        sj, st = j.stats(), t.stats()
        assert sj.keys() == st.keys()
        for k in COUNTERS:
            assert st.get(k) == sj.get(k), k
        return t


def jax_stream_cfg():
    from voxtral_tpu.config import tiny_config as jax_tiny
    return jax_tiny()


def run(w, audio, chunk_sizes, tok_path=None, **sc_kw):
    p = Pair(w, tok_path, **sc_kw)
    p.feed_all(audio, chunk_sizes)
    p.check()
    p.finish()
    return p.check()


@pytest.fixture(scope="module")
def batch_tokens(weights, audio):
    toks, _ = transcribe_tokens_batch(weights["random"][1], tiny_config(), audio,
                                      device="cpu")
    assert len(toks) > 10
    return toks


def test_random_params_host_matches_jax_tree(weights, tiny_params):
    """The port's host random tree is the JAX package's, bit for bit."""
    got = jax.tree_util.tree_leaves(weights["random"][1])
    want = jax.tree_util.tree_leaves(tiny_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("chunks,interval", [
    ((16000,), 2.0), ((160, 1280, 7, 4096, 999, 16000), 2.0), ((1600,), 0.1)])
def test_stream_equals_jax_and_batch(weights, audio, batch_tokens, chunks, interval):
    t = run(weights["random"], audio, chunks, interval=interval)
    assert t.generated_ids == batch_tokens
    want, _ = jax_batch(weights["random"][0], jax_stream_cfg(), audio)
    assert t.generated_ids == [int(x) for x in want]


def test_stream_native_mel_both_sides(weights, audio, batch_tokens, monkeypatch):
    """Both packages' native bindings (same source, same flags) give the
    same tokens."""
    from voxtral_tpu.audio.native import native_available as jax_native
    from voxtral_tpu_torch.audio.native import NativeMelStream, native_available
    monkeypatch.setenv("VOX_NATIVE", "1")
    if not (native_available() and jax_native()):
        pytest.skip("the native library does not build here")
    p = Pair(weights["random"])
    assert isinstance(p.t.mel, NativeMelStream)
    p.feed_all(audio, (16000,))
    p.finish()
    assert p.check().generated_ids == batch_tokens


def test_stream_nondefault_delay_matches_batch(weights, audio):
    """flush()/finish() pad by the stream's LIVE delay (voxtral.c:1645-1648)."""
    t = run(weights["random"], audio, (16000,), delay_tokens=12)
    want, _ = transcribe_tokens_batch(weights["random"][1], tiny_config(), audio,
                                      delay_tokens=12, device="cpu")
    assert t.generated_ids == want


def test_flush_midstream_keeps_stream_open(weights, audio):
    p = Pair(weights["random"], interval=2.0)
    p.feed(audio[:32000])
    p.flush()
    early = p.check().stats()["generated"]
    p.feed(audio[32000:])
    p.finish()
    assert early > 0 and p.check().stats()["generated"] > early


def test_set_delay_matches_fresh_stream(weights, audio):
    a = Pair(weights["random"], interval=1.0, delay_tokens=12)
    b = Pair(weights["random"], interval=1.0)
    b.set_delay(12 * 80)
    assert list(a.t.prompt_ids) == list(b.t.prompt_ids) == list(b.j.prompt_ids)
    # f32 ada scales: the two GEMM libraries sum in their own order
    np.testing.assert_allclose(b.t.t_ada.numpy(), np.asarray(b.j.t_ada), rtol=1e-5, atol=1e-9)
    for s in (a, b):
        s.feed(audio)
        s.finish()
    assert a.check().generated_ids == b.check().generated_ids
    c = Pair(weights["random"])
    c.set_delay(5000)
    assert c.t.sc.delay_tokens == c.j.sc.delay_tokens == 30
    c.set_delay(0)
    assert c.t.sc.delay_tokens == 1


def test_continuous_watchdog_kv_restart(weights, audio, monkeypatch):
    for mod in (jax_stream, port_stream):
        monkeypatch.setattr(mod, "MAX_DECODE_KV", 16)
    t = run(weights["random"], audio, (16000,), continuous=True)
    assert any(sym.startswith("⟳") for sym in t.monitor_log), t.monitor_log
    assert t.n_generated > 16
    assert all("♻" in sym for sym in t.monitor_log if sym.startswith("⟳"))


def test_continuous_watchdog_nontext_streak(weights, audio, monkeypatch):
    for mod in (jax_stream, port_stream):
        monkeypatch.setattr(mod, "MAX_NON_TEXT_STREAK", 4)
        monkeypatch.setattr(mod.VoxStream, "_classify", lambda self, t: "control")
    t = run(weights["random"], audio, (16000,), continuous=True)
    streaks = [sym for sym in t.monitor_log if sym.startswith("↯")]
    assert streaks and all("♻" in sym for sym in streaks)
    assert t.n_generated > 4


def test_eos_restart_escalation_to_full(weights, audio):
    p = Pair(weights["random"], interval=2.0, continuous=True)
    p.feed(audio)
    assert p.t.decoder_started and p.j.decoder_started
    p.set(eos_seen=True)                     # textless EOS #1
    p._watchdog()
    assert p.t.monitor_log[-1] == "↺✂" and p.t.empty_restarts == 1
    assert not p.t.eos_seen and not p.t.decoder_started
    p.set(eos_seen=True)                     # textless EOS #2 -> escalate
    p._watchdog()
    assert p.t.monitor_log[-1] == "↺♻" and p.t.empty_restarts == 0
    p.feed(audio)                            # restart the decoder
    p.set(text_since_restart=True, eos_seen=True)
    p._watchdog()
    assert p.t.monitor_log[-1] == "↺✂" and p.t.empty_restarts == 0
    p.feed(audio[:20000])                    # decodes on after the resets
    p.finish()
    p.check()


def test_set_continuous(weights, audio):
    p = Pair(weights["random"], interval=2.0)
    p.set_continuous(True)
    assert p.t.sc.continuous
    p.feed(audio)
    p.set(eos_seen=True)
    p._watchdog()
    assert p.t.monitor_log[-1].startswith("↺")
    p.set_continuous(False)
    p.set(eos_seen=True)
    n = len(p.t.monitor_log)
    p._watchdog()
    assert len(p.t.monitor_log) == n
    p.check()


def test_continuous_watchdog_no_decode_timeout(weights, monkeypatch):
    for mod in (jax_stream, port_stream):
        monkeypatch.setattr(mod, "MAX_NO_DECODE_SECONDS", 1)
    p = Pair(weights["random"], interval=60.0, continuous=True)
    rng = np.random.RandomState(3)
    for _ in range(3):                       # 3 s fed, encoder never runs
        p.feed((rng.randn(16000) * 0.3).astype(np.float32))
    t = p.check()
    assert any(sym.startswith("⌚") for sym in t.monitor_log), t.monitor_log


def test_monitor_decode_symbols(weights, audio):
    t = run(weights["random"], audio, (1600,), interval=0.1, monitor=True)
    log = t.monitor_log
    assert "⌛" in log and "▶" in log and "·" in log
    assert [x for x in log if x and x[0] in "▪▸▫▹✗✘◦"], log
    t2 = run(weights["random"], audio, (16000,), monitor=True, monitor_slow_ms=0.0)
    d2 = [x for x in t2.monitor_log if x and x[0] in "▪▸▫▹✗✘◦"]
    assert d2 and all(x[0] in "▸▹✘◦" for x in d2), t2.monitor_log


def test_lively_tokenizer_alts(weights, audio, tok_path):
    """Text tokens with the test tokenizer's pieces and alt-tokens (n_alt 3,
    cutoff 0.95): the queue carries ids, pieces and alt lists."""
    t = run(weights["lively"], audio, (1600, 4096), tok_path=tok_path,
            interval=0.5, n_alt=3, alt_cutoff=0.95, monitor=True)
    assert t.n_text_tokens > 0 and any(q[2] for q in t.queue), t.queue
    want, _ = transcribe_tokens_batch(weights["lively"][1], tiny_config(), audio,
                                      device="cpu")
    assert t.generated_ids == want
    drained = t.get_alt()
    assert drained and all(isinstance(piece, str) for piece, _ in drained)


def test_stream_needs_params_on_its_device(weights):
    with pytest.raises(RuntimeError, match="params live on"):
        port_stream.VoxStream(weights["random"][1], tiny_config(), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_stream.VoxStream(weights["random"][1], tiny_config())
