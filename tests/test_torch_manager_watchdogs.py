"""The port's FleetManager against the JAX package's, on the CPU, tiny config,
f32: watchdog restarts (EOS, KV, streak, no-text; both reset tiers), the
pushback of staged and dispatched chunks, pipelined polls and latency mode
(mirrors tests/test_manager.py; the `Twin` harness and the weights are
tests/test_torch_manager.py's). Also the two faults of the JAX manager the
port does not copy: the monitor's slow test on overlapping pipelined step
windows, and a poll after an aborted pipelined poll."""

import dataclasses

import numpy as np
import pytest
import torch

import voxtral_tpu.runtime.manager as jax_manager
import voxtral_tpu_torch.runtime.manager as port_manager
from test_torch_manager import Twin, audio, cfgs, patch_both, weights  # noqa: F401
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
from voxtral_tpu_torch.runtime import FleetManager

torch.set_num_threads(2)


def test_watchdog_kv_restart_keeps_stream_alive(weights, cfgs, monkeypatch):
    patch_both(monkeypatch, "MAX_DECODE_KV", 40)
    twin = Twin(weights["random"], cfgs, batch=1, chunk_tokens=8,
                dec_ring=256, continuous=True, monitor=True)
    sid = twin.attach()
    twin.serve({sid: audio(5, seconds=4.0)})
    st = twin.t.stats()
    assert st["restarts"] >= 1 and st["generated"] > 0
    assert any(sym.startswith("⟳") for _, sym in twin.events[1])


def test_streak_watchdog_escalates_to_full_reset(weights, cfgs):
    """Random weights emit only control tokens: the non-text streak
    restarts the stream every 64 tokens (a full reset, ↯♻), and the
    monitor's streak severities (⚠, ☠) appear before it."""
    twin = Twin(weights["random"], cfgs, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=True, monitor=True)
    s0, s1 = twin.attach(), twin.attach()
    twin.serve({s0: audio(51, seconds=7.0), s1: audio(52, seconds=5.0)})
    syms = [sym for _, sym in twin.events[1]]
    assert "↯♻" in syms
    assert any(s.endswith("⚠") for s in syms) and any(s.endswith("☠") for s in syms)


def test_eos_restart_is_decoder_only(weights, cfgs):
    """Continuous mode: an EOS restarts the decoder only (↺✂, the second
    reset tier: fleet_reset_slots(full=False)) while text has been seen
    since the last restart; the stream keeps its audio state and goes on."""
    jp, tp = weights["lively"]
    a = audio(21, seconds=3.0)
    probe, _ = transcribe_tokens_batch(tp, cfgs[1], a, device="cpu")
    text = [t for t in probe if t >= cfgs[1].streaming.n_special]
    t_eos = text[len(text) // 2]
    cfgs2 = tuple(dataclasses.replace(
        c, streaming=dataclasses.replace(c.streaming, eos=t_eos))
        for c in cfgs)
    twin = Twin(weights["lively"], cfgs2, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=True, monitor=True)
    s0, s1 = twin.attach(), twin.attach()
    twin.serve({s0: a, s1: audio(22, seconds=3.0)})
    syms = [sym for _, sym in twin.events[1]]
    assert "↺✂" in syms
    assert twin.t.slots[s0].restarts >= 1


def test_no_text_watchdog_clock_resets(weights, cfgs, monkeypatch):
    """After a no-text full restart (⌚♻) the watchdog clock restarts too:
    no livelock re-buffering the left pad forever."""
    patch_both(monkeypatch, "MAX_NO_TEXT_SECONDS", 0.5)
    twin = Twin(weights["random"], cfgs, batch=1, chunk_tokens=8,
                dec_ring=256, continuous=True, monitor=True)
    sid = twin.attach()
    a = audio(14, seconds=4.0)
    for i in range(0, len(a), 16000):
        twin.feed(sid, a[i:i + 16000])
        for _ in range(24):
            if len(twin.t.slots[sid].buf) < twin.t.chunk_samp:
                break
            twin.poll()
            twin.check()
    assert len(twin.t.slots[sid].buf) < twin.t.chunk_samp
    assert twin.t.stats()["restarts"] >= 2
    assert "⌚♻" in [sym for _, sym in twin.events[1]]


@pytest.mark.parametrize("wname", ["random", "lively"])
def test_restart_with_staged_chunk_pushback(weights, cfgs, monkeypatch, wname):
    """A restart that hits an already staged chunk pushes its samples back
    and re-projects the replay: feeding the whole clip at once (deep
    staging) gives the tokens of feeding it in small pieces. The KV cap
    exceeds the 38-token prompt replay (at 24, as the JAX test has it, a
    full reset's left pad refills all but 40 samples of the 4 chunks each
    restart consumes, so a clip drains over thousands of steps)."""
    patch_both(monkeypatch, "MAX_DECODE_KV", 45)
    a = audio(11, seconds=4.0)

    def run(piece):
        twin = Twin(weights[wname], cfgs, batch=1, chunk_tokens=8,
                    dec_ring=256, continuous=True)
        sid = twin.attach()
        for i in range(0, len(a), piece):
            twin.feed(sid, a[i:i + piece])
            twin.poll()
            twin.check()
        twin.drain(sid)
        assert twin.t.stats()["restarts"] >= 1
        return twin.t.slots[sid].all_ids

    assert run(len(a)) == run(12000)


def test_manager_monitor_hook(weights, cfgs, monkeypatch):
    """Per-slot symbols: decode classes and a ⟳ restart with its tier, for
    the attached slot only, equal to the JAX manager's sequence (the KV
    cap above the prompt replay, as in test_restart_with_staged_chunk_pushback)."""
    patch_both(monkeypatch, "MAX_DECODE_KV", 45)
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=True, monitor=True)
    s0 = twin.attach()
    twin.serve({s0: audio(31, seconds=4.0)})
    events = twin.events[1]
    assert events and all(sid == s0 for sid, _ in events)
    syms = [sym for _, sym in events]
    assert any(x[0] in "▪▸▫▹✗✘◦" for x in syms)
    restarts = [x for x in syms if x[0] in "↺⟳↯⌚"]
    assert any(x.startswith("⟳") for x in restarts)
    assert all(len(x) == 2 and x[1] in "✂♻" for x in restarts)


def _drain_polls(twin, sid, a):
    twin.feed(sid, a)
    polls = []
    for _ in range(200):
        polls.append(twin.poll())
        twin.check()
        if polls[-1] == 0:
            break
    assert polls[-1] == 0, "backlog never drained"
    return polls


def test_max_steps_per_poll_caps_and_preserves_tokens(weights, cfgs):
    """Latency mode: each poll runs at most the cap, and repeated polls
    drain to the uncapped manager's tokens."""
    a = audio(5, seconds=3.0)
    runs = {}
    for cap in (None, 1):
        twin = Twin(weights["lively"], cfgs, batch=1, chunk_tokens=6,
                    dec_ring=64, continuous=True, max_steps_per_poll=cap)
        sid = twin.attach()
        runs[cap] = (_drain_polls(twin, sid, a), twin.t.slots[sid].all_ids)
    assert runs[1][1] == runs[None][1] and len(runs[None][1]) > 10
    assert max(runs[1][0]) <= 1 and sum(runs[1][0]) == sum(runs[None][0])


def test_max_steps_per_poll_spreads_restart_recovery(weights, cfgs,
                                                     monkeypatch):
    """A full reset's replay + pushed-back audio drains one step per poll."""
    patch_both(monkeypatch, "MAX_DECODE_KV", 45)
    twin = Twin(weights["random"], cfgs, batch=1, chunk_tokens=6,
                dec_ring=64, continuous=True, max_steps_per_poll=1)
    sid = twin.attach()
    a = audio(6, seconds=4.0)
    chunk = twin.t.chunk_samp
    polls = []
    for i in range(0, len(a), chunk):
        twin.feed(sid, a[i:i + chunk])
        while True:
            polls.append(twin.poll())
            twin.check()
            if polls[-1] == 0:
                break
    assert twin.t.slots[sid].restarts > 0 and max(polls) <= 1


@pytest.mark.parametrize("n_alt", [1, 2])
def test_pipelined_poll_matches_default(weights, cfgs, n_alt):
    """pipeline_steps=2 (step k+1 dispatched before step k's tokens are
    read) gives the serial poll's streams, with and without alt-tokens."""
    a0, a1 = audio(41, seconds=4.0), audio(42, seconds=3.0)
    got = {}
    for depth in (1, 2):
        twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                    dec_ring=256, continuous=True, n_alt=n_alt,
                    alt_cutoff=0.9 if n_alt > 1 else 0.0,
                    pipeline_steps=depth, monitor=True)
        s0, s1 = twin.attach(), twin.attach()
        got[depth] = (twin.serve({s0: a0, s1: a1}), twin.events[1])
    assert got[2] == got[1]


def test_pipelined_poll_restart_discard_matches(weights, cfgs, monkeypatch):
    """Restarts under the pipeline discard the restarting stream's
    already-dispatched row; both streams still match the serial order."""
    patch_both(monkeypatch, "MAX_DECODE_KV", 40)
    a0, a1 = audio(43, seconds=5.0), audio(44, seconds=5.0)
    got = {}
    for depth in (1, 2):
        twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                    dec_ring=256, continuous=True, pipeline_steps=depth)
        s0, s1 = twin.attach(), twin.attach()
        got[depth] = twin.serve({s0: a0, s1: a1})
        assert sum(twin.t.slots[s].restarts for s in (s0, s1)) > 0
    assert got[2] == got[1]


def test_pipelined_noncontinuous_finish_matches_batch(weights, cfgs):
    """Non-continuous + pipeline_steps=2 reproduces the batch pipeline."""
    a = audio(9, seconds=2.7)
    want, _ = transcribe_tokens_batch(weights["lively"][1], cfgs[1], a,
                                      device="cpu")
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8,
                dec_ring=256, continuous=False, pipeline_steps=2)
    sid = twin.attach()
    twin.feed(sid, a)
    twin.drain(sid)
    assert twin.t.slots[sid].all_ids == want


class _Clock:
    """perf_counter stand-in: every call advances 10 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


def test_pipelined_monitor_reads_the_clipped_step_time(weights, cfgs,
                                                       monkeypatch):
    """With pipeline_steps=2 a step's dispatch-to-retire window spans the
    previous step's retire. On a clock that advances 10 ms a call, a
    middle step's window is 30 ms but its clipped time 20 ms (8 tokens:
    3.75 against 2.5 ms a token). At 3 ms a token the JAX manager marks
    those steps slow (its fault); the port's slow test reads the clipped
    time, which is what step_ms_total adds up."""
    events = ([], [])
    mgrs, clipped = [], []
    for k, (mod, dev) in enumerate(((jax_manager, {}),
                                    (port_manager, {"device": "cpu"}))):
        monkeypatch.setattr(mod, "time", _Clock())
        p = weights["random"][k]
        mgrs.append(mod.FleetManager(
            p, cfgs[k], batch=1, chunk_tokens=8, dec_ring=256,
            continuous=True, pipeline_steps=2, monitor_slow_ms=3.0,
            monitor=lambda sid, sym, ev=events[k]: ev.append(sym), **dev))
    jm, tm = mgrs
    seen = []

    def spy(sid, sym):
        events[1].append(sym)
        seen.append((tm.steps, tm._last_step_ms, tm.step_ms_total))
    tm._monitor = spy
    a = audio(61, seconds=5.0)
    for m in mgrs:
        sid = m.attach()
        m.feed(sid, a)
        assert m.poll() >= 4
    for (k0, _, t0), (k1, last, t1) in zip(seen, seen[1:]):
        if k1 == k0 + 1:             # the share step_ms_total added
            assert t1 - t0 == pytest.approx(last)
            clipped.append(last)
    assert len(clipped) >= 2
    fast = {"▸": "▪", "✘": "✗", "▹": "▫"}
    assert any(s[0] in fast for s in events[0])    # the JAX manager: slow
    assert not any(s[0] in fast for s in events[1])
    assert [fast.get(s[0], s[0]) + s[1:] for s in events[0]] == events[1]
    assert max(clipped) == pytest.approx(20.0)


def test_poll_after_an_aborted_pipelined_poll_raises(weights, cfgs):
    """A poll that raised with a step still dispatched leaves the pipeline
    inconsistent; the next poll raises instead of retiring stale steps (the
    JAX manager overwrites the staged batch and goes on)."""
    def boom(sid, sym):
        raise KeyboardInterrupt
    a = audio(62, seconds=4.0)
    mgrs = []
    for k, (cls, dev) in enumerate(((jax_manager.FleetManager, {}),
                                    (FleetManager, {"device": "cpu"}))):
        m = cls(weights["random"][k], cfgs[k], batch=1, chunk_tokens=8,
                dec_ring=256, continuous=True, pipeline_steps=2,
                monitor=boom, **dev)
        sid = m.attach()
        m.feed(sid, a)
        with pytest.raises(KeyboardInterrupt):
            m.poll()
        assert m._dispatched            # aborted mid-pipeline
        m._monitor = None
        mgrs.append(m)
    jm, tm = mgrs
    assert jm.poll() >= 0               # the reference goes on silently
    with pytest.raises(RuntimeError, match="in flight"):
        tm.poll()


def test_fetch_queues_nothing_on_the_cpu(weights, cfgs):
    """On the CPU a step's output is already on the host: the fetch handle
    carries no event, and _put hands the rows over without a copy."""
    mgr = FleetManager(weights["random"][1], cfgs[1], batch=1, chunk_tokens=8,
                       dec_ring=256, device="cpu")
    out = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    host, done = mgr._start_fetch(out)
    assert done is None
    np.testing.assert_array_equal(mgr._fetch((host, done)), out.numpy())
    rows = np.ones((2, 3), np.float32)
    assert mgr._put(rows).data_ptr() == rows.ctypes.data
