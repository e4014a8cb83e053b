"""The port's FleetManager (voxtral_tpu_torch.runtime.manager) against the JAX
package's, on the CPU, tiny config, f32: lifecycle, per-stream isolation and
the wire (mirrors tests/test_manager.py; restarts, pipelining and latency
mode are in tests/test_torch_manager_watchdogs.py).

Both managers take the same calls on the same seeded audio (`Twin`), and
after every poll each slot's observable state must agree exactly: the full
greedy stream (`all_ids`), the text queue (ids, pieces and alt lists),
restarts, samples consumed, steps, `retained_kv` and the monitor symbols
(with `monitor_slow_ms=1e9`, so timing never enters). Weights: the seeded
random tree (`random`), on which greedy locks onto one control token, and
the same tree with the embedding rows normalized and the adapter amplified
(`lively`, as tests/test_manager.py's EOS case), whose tokens follow the
audio and include text tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxtral_tpu.runtime.manager as jax_manager
import voxtral_tpu_torch.runtime.manager as port_manager
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu.tokenizer import Tokenizer as JaxTokenizer
from voxtral_tpu.tokenizer import make_test_tokenizer_json
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.runtime import FleetManager
from voxtral_tpu_torch.tokenizer import Tokenizer
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

SLOT_FIELDS = ("active", "replay_left", "queue", "finishing", "finished",
               "eos_seen", "pos", "nontext_streak", "samples_since_text",
               "text_since_restart", "empty_restarts", "token_limit",
               "generated", "text_tokens", "restarts", "samples_done",
               "all_ids")


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
def weights(tiny_cfg, tiny_params):
    """name -> (JAX params, port params) of the same values."""
    tree = jax_random_params(tiny_cfg, 1234, numpy_out=True)
    live = _lively(tree)
    return {"random": (tiny_params, from_numpy_params(tree, "cpu")),
            "lively": (jax.tree.map(jnp.asarray, live),
                       from_numpy_params(live, "cpu"))}


@pytest.fixture(scope="module")
def cfgs(tiny_cfg):
    return tiny_cfg, tiny_config()


def audio(seed, seconds=3.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16000)) * 0.3).astype(np.float32)


def patch_both(monkeypatch, name, value):
    """Set a watchdog constant in both managers' modules."""
    monkeypatch.setattr(jax_manager, name, value)
    monkeypatch.setattr(port_manager, name, value)


class Twin:
    """The JAX manager and the port's (device="cpu"), driven by the same
    calls. A call on the twin calls both and asserts equal results; check()
    compares their observable state."""

    def __init__(self, w, cfgs, *, tok_path=None, monitor=False, **kw):
        self.events = ([], [])
        kw = {"monitor_slow_ms": 1e9, **kw}
        ctor = ((jax_manager.FleetManager, JaxTokenizer, {}),
                (FleetManager, Tokenizer, {"device": "cpu"}))
        self.j, self.t = (
            cls(p, cfg, tokenizer=tok(tok_path) if tok_path else None,
                monitor=(lambda sid, sym, ev=ev: ev.append((sid, sym)))
                if monitor else None,
                **extra, **kw)
            for (cls, tok, extra), p, cfg, ev
            in zip(ctor, w, cfgs, self.events))

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)

        def both(*args, **kwargs):
            rj, rt = fj(*args, **kwargs), ft(*args, **kwargs)
            assert rj == rt, (name, rj, rt)
            return rt
        return both

    def check(self):
        j, t = self.j, self.t
        assert t.steps == j.steps
        assert len(t.slots) == len(j.slots)
        for sid, (sj, st) in enumerate(zip(j.slots, t.slots)):
            for f in SLOT_FIELDS:
                assert getattr(st, f) == getattr(sj, f), (sid, f)
            assert (st.buf is None) == (sj.buf is None)
            if st.buf is not None:
                np.testing.assert_array_equal(st.buf, sj.buf)
            if st.active:
                assert t.retained_kv(sid) == j.retained_kv(sid), sid
        assert self.events[1] == self.events[0]
        sj, st = j.stats(), t.stats()
        for k in ("steps", "streams", "generated", "text_tokens", "restarts"):
            assert st[k] == sj[k], k

    def serve(self, feeds, piece=16000):
        """feeds: {sid: audio}. Feed `piece`-sample chunks round-robin,
        poll, finish, drain (tests/test_manager.py:_serve), checking both
        managers after every poll. Returns {sid: all_ids}."""
        pos = dict.fromkeys(feeds, 0)
        while any(pos[sid] < len(a) for sid, a in feeds.items()):
            for sid, a in feeds.items():
                if pos[sid] < len(a):
                    self.feed(sid, a[pos[sid]:pos[sid] + piece])
                    pos[sid] += piece
            self.poll()
            self.check()
        for sid in feeds:
            self.finish(sid)
        for _ in range(64):
            if all(self.t.is_finished(sid) for sid in feeds):
                break
            self.poll()
            self.check()
        return {sid: list(self.t.slots[sid].all_ids) for sid in feeds}

    def drain(self, sid):
        """finish() then poll until the stream reports finished."""
        self.finish(sid)
        for _ in range(64):
            if self.t.is_finished(sid):
                break
            self.poll()
            self.check()
        assert self.is_finished(sid)


def solo(w, cfgs, a, **kw):
    twin = Twin(w, cfgs, batch=1, chunk_tokens=8, dec_ring=256,
                continuous=True, **kw)
    sid = twin.attach()
    return twin.serve({sid: a})[sid]


@pytest.mark.parametrize("wname", ["random", "lively"])
def test_two_streams_match_solo(weights, cfgs, wname):
    w = weights[wname]
    a0, a1 = audio(1), audio(2, seconds=2.0)
    solo0, solo1 = solo(w, cfgs, a0), solo(w, cfgs, a1)
    twin = Twin(w, cfgs, batch=2, chunk_tokens=8, dec_ring=256,
                continuous=True, monitor=True)
    s0, s1 = twin.attach(), twin.attach()
    got = twin.serve({s0: a0, s1: a1})
    assert got[s0] == solo0 and got[s1] == solo1
    if wname == "lively":
        assert len(set(got[s0])) > 2 and twin.t.stats()["text_tokens"] > 0


def test_mid_flight_attach_matches_solo(weights, cfgs):
    w = weights["lively"]
    a0, a1 = audio(3, seconds=4.0), audio(4, seconds=2.0)
    solo1 = solo(w, cfgs, a1)
    twin = Twin(w, cfgs, batch=2, chunk_tokens=8, dec_ring=256,
                continuous=True)
    s0 = twin.attach()
    twin.feed(s0, a0[:32000])
    twin.poll()
    twin.check()
    s1 = twin.attach()          # forced prompt replay inside a live fleet
    got = twin.serve({s0: a0[32000:], s1: a1})
    assert got[s1] == solo1


def test_fleet_full_raises(weights, cfgs):
    twin = Twin(weights["random"], cfgs, batch=1, chunk_tokens=8,
                dec_ring=256)
    twin.attach()
    for mgr in (twin.j, twin.t):
        with pytest.raises(RuntimeError, match="fleet full"):
            mgr.attach()


def test_alt_tokens_surface(weights, cfgs):
    """n_alt=4, cutoff 1.0: every text token carries its alt list, and the
    lists (ids and pieces) agree with the JAX manager's."""
    twin = Twin(weights["lively"], cfgs, batch=1, chunk_tokens=8,
                dec_ring=256, n_alt=4, alt_cutoff=1.0)
    sid = twin.attach()
    a = audio(6, seconds=2.0)
    for i in range(0, len(a), 16000):
        twin.feed(sid, a[i:i + 16000])
    twin.poll()
    twin.check()
    entries = twin.get(sid)
    assert entries
    for tid, piece, alts in entries:
        assert isinstance(alts, list) and all(j != tid for j, _ in alts)
    assert any(alts for _, _, alts in entries)


def test_nondefault_delay_matches_batch(weights, cfgs):
    """delay_tokens=12: finish() takes the right pad from the live delay;
    the finished stream equals both packages' batch pipelines."""
    jp, tp = weights["lively"]
    a = audio(13, seconds=2.0)
    want, _ = transcribe_tokens_batch(tp, cfgs[1], a, delay_tokens=12,
                                      device="cpu")
    assert want == [int(t) for t in jax_transcribe(jp, cfgs[0], a,
                                                   delay_tokens=12)[0]]
    twin = Twin(weights["lively"], cfgs, batch=1, chunk_tokens=8,
                dec_ring=256, continuous=False, delay_tokens=12)
    sid = twin.attach()
    twin.feed(sid, a)
    twin.drain(sid)
    assert twin.t.slots[sid].all_ids == want


def test_set_delay_relatches_unstarted_prompt(weights, cfgs):
    """set_delay between attach and the first step re-latches the replay
    length; the ada conditioning switches for every slot."""
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=True)
    s0 = twin.attach()
    twin.feed(s0, audio(7, seconds=1.0))
    twin.poll()
    s1 = twin.attach()
    twin.set_delay(10)
    twin.check()
    assert twin.t.slots[s1].replay_left == twin.t.prompt_len - 1
    np.testing.assert_allclose(twin.t.t_ada.numpy(), np.asarray(twin.j.t_ada),
                               rtol=1e-6, atol=1e-7)
    twin.serve({s0: audio(8, seconds=2.0), s1: audio(9, seconds=2.0)})


def test_set_chunk_tokens_between_polls(weights, cfgs):
    """set_chunk_tokens raises the step size within max_chunk_tokens (the
    pending blocks were sized for it) and refuses beyond it."""
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                max_chunk_tokens=12, dec_ring=256, continuous=True)
    s0, s1 = twin.attach(), twin.attach()
    twin.feed(s0, audio(31, seconds=2.0))
    twin.poll()
    twin.check()
    twin.set_chunk_tokens(12)
    assert twin.t.chunk_samp == 12 * 8 * 160
    twin.serve({s0: audio(32, seconds=2.0), s1: audio(33, seconds=2.0)})
    with pytest.raises(ValueError, match="max_chunk_tokens"):
        twin.t.set_chunk_tokens(16)


def test_finished_stream_matches_batch_pipeline(weights, cfgs):
    """A finished non-continuous stream reproduces the batch pipeline's
    tokens exactly, tail included (finish() caps emission at the right-pad
    schedule)."""
    jp, tp = weights["lively"]
    a = audio(9, seconds=2.7)             # deliberately not chunk-aligned
    want, _ = transcribe_tokens_batch(tp, cfgs[1], a, device="cpu")
    assert want == [int(t) for t in jax_transcribe(jp, cfgs[0], a)[0]]
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=False)
    sid = twin.attach()
    twin.feed(sid, a)
    twin.drain(sid)
    assert twin.t.slots[sid].all_ids == want


def test_s16_wire_matches_f32(weights, cfgs):
    """wire_dtype='s16' is exact for s16-origin audio: the same tokens as
    the f32 wire, in both packages."""
    rng = np.random.RandomState(7)
    s16 = (rng.randn(3 * 16000) * 0.25 * 32768).clip(-32768, 32767)
    a = s16.astype(np.int16).astype(np.float32) / 32768.0
    w = weights["lively"]
    want = solo(w, cfgs, a)
    twin = Twin(w, cfgs, batch=1, chunk_tokens=8, dec_ring=256,
                continuous=True, wire_dtype="s16")
    sid = twin.attach()
    assert twin.serve({sid: a})[sid] == want


def _duty_cycle_serve(twin, x_sid, sib_sids, x_audio, sib_audio, chunk_samp,
                      duty=4):
    """Siblings fed every round, X every `duty` rounds
    (tests/test_manager.py:301)."""
    for i in range(len(sib_audio) // chunk_samp):
        for sid in sib_sids:
            twin.feed(sid, sib_audio[i * chunk_samp:(i + 1) * chunk_samp])
        if i % duty == 0:
            j = i // duty
            twin.feed(x_sid, x_audio[j * chunk_samp:(j + 1) * chunk_samp])
        twin.poll()
        twin.check()


def test_lockstep_lag_exact_within_ring_bound(weights, cfgs):
    """A 25%-duty stream in a busy fleet matches its solo run while the
    ring holds duty x window positions; retained_kv reports full windows."""
    w = weights["lively"]
    chunk_samp = 8 * 1280
    x_audio = audio(21, seconds=10.0)[:12 * chunk_samp]
    sib_audio = audio(22, seconds=40.0)[:48 * chunk_samp]
    single = Twin(w, cfgs, batch=1, chunk_tokens=8, dec_ring=256,
                  continuous=False)
    xs = single.attach()
    for j in range(12):
        single.feed(xs, x_audio[j * chunk_samp:(j + 1) * chunk_samp])
        single.poll()
    single.check()
    twin = Twin(w, cfgs, batch=3, chunk_tokens=8, dec_ring=256,
                continuous=False)
    x = twin.attach()
    sibs = [twin.attach(), twin.attach()]
    _duty_cycle_serve(twin, x, sibs, x_audio, sib_audio, chunk_samp)
    assert twin.t.slots[x].all_ids == single.t.slots[xs].all_ids
    window = min(cfgs[1].decoder.window, 256)
    pos = twin.t.state.decode.pos
    assert twin.t.retained_kv(sibs[0]) == min(int(pos[sibs[0]]), window)
    assert twin.t.retained_kv(x) >= min(int(pos[x]), window)


def test_lockstep_lag_shrink_is_measurable(weights, cfgs):
    """A ring smaller than duty x window: the laggard's retained_kv drops
    below its window (the same count in both packages, check())."""
    chunk_samp = 8 * 1280
    twin = Twin(weights["lively"], cfgs, batch=3, chunk_tokens=8,
                dec_ring=64, continuous=False)
    x = twin.attach()
    sibs = [twin.attach(), twin.attach()]
    _duty_cycle_serve(twin, x, sibs, audio(23, seconds=10.0)[:12 * chunk_samp],
                      audio(24, seconds=40.0)[:48 * chunk_samp], chunk_samp)
    dec = twin.t.state.decode
    ring = dec.k_ring[0].shape[1] - dec.pending_sp.shape[1]
    window = min(cfgs[1].decoder.window, ring)
    assert int(dec.pos[x]) > window
    assert twin.t.retained_kv(x) < window
    assert twin.t.retained_kv(sibs[0]) == min(int(dec.pos[sibs[0]]), window)


def test_noncontinuous_eos_stops_stream(weights, cfgs):
    """A non-continuous slot that emits EOS stops: nothing after it. The
    EOS is a known mid-stream greedy token re-designated as EOS
    (tests/test_manager.py:388)."""
    jp, tp = weights["lively"]
    a = audio(21, seconds=3.0)
    probe, _ = transcribe_tokens_batch(tp, cfgs[1], a, device="cpu")
    firsts = {}
    for i, t in enumerate(probe):
        if t >= cfgs[1].streaming.n_special:
            firsts.setdefault(t, i)
    t_eos, first = max(firsts.items(), key=lambda kv: kv[1])
    assert 1 <= first < len(probe) - 1
    cfgs2 = tuple(dataclasses.replace(
        c, streaming=dataclasses.replace(c.streaming, eos=t_eos))
        for c in cfgs)
    twin = Twin(weights["lively"], cfgs2, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=False, monitor=True)
    s0, s1 = twin.attach(), twin.attach()
    got = twin.serve({s0: a, s1: audio(22, seconds=3.0)})
    assert got[s0][-1] == t_eos and got[s0][:-1] == probe[:first]
    assert twin.t.slots[s0].eos_seen and twin.t.is_finished(s0)
    assert twin.events[1]


def test_manager_int4_encoder_rings(weights, cfgs):
    """Q8-free int8 decoder + int4 encoder rings through the serving path
    (JAX runs the Pallas kernel in interpret mode): packed rings, and the
    same tokens as the JAX manager."""
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8, dec_ring=64,
                kv_dtype="int8", enc_kv_dtype="int4", continuous=False)
    enc = twin.t.state.encoder
    assert enc.k_ring[0].shape[-1] == cfgs[1].encoder.attn_dim // 2
    assert enc.k_ring[0].dtype == torch.int8
    sid = twin.attach()
    assert len(twin.serve({sid: audio(5, seconds=3.0)})[sid]) > 10


def test_detached_slot_reuse_matches_solo(weights, cfgs):
    """finish() + detach() frees a slot; its re-attach serves the new
    stream like a solo run while a neighbour stays live."""
    w = weights["lively"]
    a0, a1, a2 = audio(11, seconds=2.0), audio(12, seconds=3.0), audio(13, seconds=2.0)
    solo2 = solo(w, cfgs, a2)
    twin = Twin(w, cfgs, batch=2, chunk_tokens=8, dec_ring=256,
                continuous=True)
    s0, s1 = twin.attach(), twin.attach()
    for i in range(0, len(a0), 16000):
        twin.feed(s0, a0[i:i + 16000])
        twin.feed(s1, a1[i:i + 16000])
        twin.poll()
    fed1 = (len(a0) // 16000) * 16000
    twin.drain(s0)
    twin.detach(s0)
    s2 = twin.attach()
    assert s2 == s0 and twin.t.slots[s2].all_ids == []
    got = twin.serve({s2: a2, s1: a1[fed1:]})
    assert got[s2] == solo2


def test_abrupt_detach_slot_reuse_matches_solo(weights, cfgs):
    """detach() without finish(), audio still buffered: the slot's reuse
    carries nothing of the abandoned stream."""
    w = weights["lively"]
    a0, a2 = audio(21, seconds=3.0), audio(22, seconds=2.0)
    solo2 = solo(w, cfgs, a2)
    twin = Twin(w, cfgs, batch=1, chunk_tokens=8, dec_ring=256,
                continuous=True)
    s0 = twin.attach()
    twin.feed(s0, a0[:32000])
    twin.poll()
    twin.feed(s0, a0[32000:])
    twin.detach(s0)
    s2 = twin.attach()
    assert s2 == s0
    assert twin.serve({s2: a2})[s2] == solo2


def test_text_tokens_through_a_tokenizer(weights, cfgs, tmp_path):
    """A toy tekken.json with fewer entries than the tiny vocab's text
    range: text tokens reach the queue with their pieces, and ids past the
    table decode to nothing, so they count as invalid (✗) and never reach
    the queue. Both managers agree on queues, pieces and symbols."""
    path = str(tmp_path / "tekken.json")
    make_test_tokenizer_json(path, vocab_size=120)    # ids 100..219 decode
    twin = Twin(weights["lively"], cfgs, tok_path=path, batch=2,
                chunk_tokens=8, dec_ring=256, continuous=True, monitor=True,
                n_alt=2, alt_cutoff=0.99)
    s0, s1 = twin.attach(), twin.attach()
    got = twin.serve({s0: audio(1), s1: audio(2, seconds=2.0)})
    ids = [t for sid in (s0, s1) for t in got[sid]]
    assert any(100 <= t < 220 for t in ids) and any(t >= 220 for t in ids)
    queued = twin.t.slots[s0].queue + twin.t.slots[s1].queue
    assert queued and all(100 <= tid < 220 and isinstance(piece, str)
                          for tid, piece, _ in queued)
    syms = [sym for _, sym in twin.events[1]]
    assert any(s.startswith("✗") for s in syms)
    assert any(s.startswith("▪") for s in syms)
    twin.get(s0)
    assert twin.t.slots[s0].queue == []


def test_default_device_raises_without_cuda(weights, cfgs):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetManager(weights["random"][1], cfgs[1], batch=1, chunk_tokens=8,
                     dec_ring=256)


def test_params_on_another_device_raise(weights, cfgs):
    meta = jax.tree.map(lambda t: t.to("meta"), weights["random"][1])
    with pytest.raises(RuntimeError, match="params live on meta"):
        FleetManager(meta, cfgs[1], batch=1, chunk_tokens=8, dec_ring=256,
                     device="cpu")


def test_stats_and_context_manager(weights, cfgs):
    """stats() has the JAX manager's keys; device memory is {} on the CPU;
    the manager is a context manager."""
    with FleetManager(weights["random"][1], cfgs[1], batch=2, chunk_tokens=8,
                      dec_ring=256, device="cpu") as mgr:
        mgr.attach()
        st = mgr.stats()
    assert st == {"steps": 0, "step_ms_total": 0.0, "streams": 1,
                  "generated": 0, "text_tokens": 0, "restarts": 0}
