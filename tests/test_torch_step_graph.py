"""The captured fleet step (voxtral_tpu_torch.runtime.step_graph) on the CPU,
tiny config, f32: the key of a captured step, the in-place slot reset that
captured steps need (against fleet_reset_slots and the JAX package's), the
launch accounting of replays, the refusals, and FleetManager's graph path
against the JAX manager.

CUDA graphs exist only on the card (chip_smoke.py phases 5, 8 and 9 hold
replays against eager steps bit for bit there). Here `emulate` stands in
for capture: it records the step's outputs and launches and leaves the state
as it was (capture runs no kernel), and a replay runs the same step on the
static inputs and writes its outputs where the captured ones live. So the
owner's own logic (first call eager, second captured and replayed, inputs
into static buffers, the state copied back into the tensors the step reads,
one key per static shape) runs as on the card."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_manager import Twin, audio, cfgs, patch_both, weights  # noqa: F401
from voxtral_tpu.runtime import fleet as jf
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
from voxtral_tpu_torch.ops import norms, q8_matmul, ring_attention
from voxtral_tpu_torch.quant import quantize_params
from voxtral_tpu_torch.runtime import FleetManager
from voxtral_tpu_torch.runtime import fleet as tf
from voxtral_tpu_torch.runtime import step_graph as sg
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"
T = 64                                  # mel frames a step (8 tokens)
KW = dict(enc_ring=192, dec_ring=64, max_mel_chunk=320)


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(tiny_cfg):
    return from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), CPU)


@pytest.fixture(scope="module")
def t_ada(cfg, params):
    return ada_scales(params["decoder"],
                      time_conditioning(cfg.streaming.delay_tokens, cfg.decoder.dim))


def _streams(cfg, b, frames, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(b, frames * cfg.audio.hop_length) * 0.3).astype(np.float32))


def _booted(cfg, params, t_ada, kv="int8", enc_kv=None, b=2):
    """A fleet state of b streams after a bootstrap, and the PCM after it."""
    pcm = _streams(cfg, b, 320 + 8 * T)
    hop = cfg.audio.hop_length
    st = tf.init_fleet_state(cfg, b, device=CPU, kv_dtype=kv, enc_kv_dtype=enc_kv, **KW)
    st, _, _ = tf.fleet_bootstrap_pcm(params, cfg, st, pcm[:, :320 * hop], t_ada)
    return st, pcm[:, 320 * hop:]


class _Graph:
    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


def _leaves(x) -> list:
    """The tensors of a program's outputs (tensors, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in (x.values() if isinstance(x, dict) else x) for t in _leaves(v)]


def emulate(monkeypatch):
    """Capture emulated on the CPU for every owner (see the module
    docstring). Returns the list of Captured entries the owners made."""
    made = []

    def capture(self, run, inputs):
        static = tuple(None if x is None else x.clone() for x in inputs)
        saved = [None if t is None else t.clone() for t in tf.state_leaves(self.state)]
        outputs, launches = sg.counted(lambda: self._in_place(run(*static)))
        for d, s in zip(tf.state_leaves(self.state), saved):
            if d is not None:
                d.copy_(s)

        def replay():
            for d, s in zip(_leaves(outputs), _leaves(self._in_place(run(*static)))):
                d.copy_(s)
        made.append(sg.Captured(_Graph(replay), static, outputs, launches))
        return made[-1]

    monkeypatch.setattr(sg, "check_capturable", lambda state, tp=None: None)
    monkeypatch.setattr(sg.StateGraphs, "_on_side_stream", lambda self, fn: fn())
    monkeypatch.setattr(sg.StateGraphs, "_capture", capture)
    return made


def _aged(cfg, st):
    """age_fleet_state, with a fed-back token inside the tiny vocabulary."""
    st = tf.age_fleet_state(cfg, st, 200)
    return st._replace(decode=st.decode._replace(
        prev_token=torch.full_like(st.decode.prev_token, 7)))


def _same_state(a, b):
    for x, y in zip(tf.state_leaves(a), tf.state_leaves(b)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            assert torch.equal(x, y)


def test_step_key_follows_every_static_argument(cfg, params, tiny_cfg):
    """Each static argument of a step gives another key; the same call gives
    the same key."""
    st = tf.init_fleet_state(cfg, 2, device=CPU, **KW)
    pcm = _streams(cfg, 2, T)
    kw = dict(stop_at_eos=False, collect_topk=0, wire_packed=False)
    base = sg.step_key("fleet_step_masked", params, st, pcm, **kw)
    assert sg.step_key("fleet_step_masked", params, st, pcm.clone(), **kw) == base
    q8 = quantize_params(from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True),
                                           CPU))
    others = [
        sg.step_key("fleet_step_pcm", params, st, pcm, **kw),
        sg.step_key("fleet_step_masked", params, st, _streams(cfg, 3, T), **kw),
        sg.step_key("fleet_step_masked", params, st, _streams(cfg, 2, 2 * T), **kw),
        sg.step_key("fleet_step_masked", params, st, pcm.to(torch.int16), **kw),
        sg.step_key("fleet_step_masked", params, st, pcm, **{**kw, "wire_packed": True}),
        sg.step_key("fleet_step_masked", params, st, pcm, **{**kw, "collect_topk": 1}),
        sg.step_key("fleet_step_masked", params, st, pcm, **{**kw, "stop_at_eos": True}),
        sg.step_key("fleet_step_masked", params,
                    tf.init_fleet_state(cfg, 2, device=CPU, kv_dtype="int8", **KW), pcm, **kw),
        sg.step_key("fleet_step_masked", params,
                    tf.init_fleet_state(cfg, 2, device=CPU, kv_dtype="int8",
                                        enc_kv_dtype="int4", **KW), pcm, **kw),
        sg.step_key("fleet_step_masked", q8, st, pcm, **kw),
    ]
    assert len({base, *others}) == len(others) + 1


def test_owner_runs_eager_then_captures_once_per_key(cfg, params, t_ada, monkeypatch):
    """First call at a key eager, the second captured and replayed, later
    ones replayed; a new chunk is a new key with its own first call."""
    made = emulate(monkeypatch)
    st, pcm = _booted(cfg, params, t_ada)
    graphs = sg.FleetStepGraphs(params, cfg, st)
    hop = cfg.audio.hop_length
    for i in range(4):
        out = graphs.step_pcm(pcm[:, i * T * hop:(i + 1) * T * hop], t_ada)
        assert out[0] is st
    assert len(made) == 1 and made[0].graph.replays == 3
    graphs.step_pcm(pcm[:, 4 * T * hop:6 * T * hop], t_ada)
    assert len(made) == 1
    graphs.step_pcm(pcm[:, 6 * T * hop:8 * T * hop], t_ada)
    assert len(made) == 2 and made[1].graph.replays == 1
    graphs.close()
    assert not graphs._graphs


@pytest.mark.parametrize("kv,enc_kv,wire", [("float", None, "f32"), ("int8", "int4", "s16")])
def test_emulated_replays_equal_the_eager_steps(cfg, params, t_ada, monkeypatch, kv, enc_kv,
                                                wire):
    """Masked steps through the owner (packed wire, a slot reset written in
    place between steps, an aged state loaded, a chunk change) give the
    eager chain's tokens and every state tensor bit for bit, and the owned
    state keeps its tensors."""
    emulate(monkeypatch)
    st_e, pcm = _booted(cfg, params, t_ada, kv, enc_kv)
    st_g = copy.deepcopy(st_e)
    ptrs = [None if t is None else t.data_ptr() for t in tf.state_leaves(st_g)]
    graphs = sg.FleetStepGraphs(params, cfg, st_g)
    hop = cfg.audio.hop_length
    pos = 0
    for i, n in enumerate((T, T, T, T, 2 * T, 2 * T)):
        rows = pcm[:, pos:pos + n * hop].numpy()
        pos += n * hop
        active = np.array([True, i != 2])
        forced = np.full((2, n // 8), -1, np.int32)
        forced[0, :2] = 100 + i
        if wire == "s16":
            rows = np.clip(np.rint(rows * 32768.0), -32768, 32767).astype(np.int16)
        w = torch.from_numpy(tf.pack_wire(rows, active, forced))
        if i == 3:
            mask = torch.tensor([False, True])
            st_e = tf.fleet_reset_slots(cfg, st_e, mask, full=True)
            assert tf.fleet_reset_slots_(cfg, graphs.state, mask, full=True) is st_g
        if i == 4:
            st_e = _aged(cfg, st_e)
            assert graphs.load_state(_aged(cfg, graphs.state)) is st_g
        st_e, tok_e, _ = tf.fleet_step_masked(params, cfg, st_e, w, None, None, t_ada,
                                              wire_packed=True)
        st_r, tok_g, _ = graphs.step_masked(w, None, None, t_ada, wire_packed=True)
        assert st_r is st_g
        assert torch.equal(tok_g, tok_e), i
        _same_state(st_g, st_e)
    assert ptrs == [None if t is None else t.data_ptr() for t in tf.state_leaves(st_g)]


def test_in_place_reset_matches_and_keeps_storage(cfg, params, t_ada, tiny_cfg, tiny_params):
    """fleet_reset_slots_ writes fleet_reset_slots's values (and the JAX
    package's) into the state's own tensors."""
    st, pcm = _booted(cfg, params, t_ada, "int8")
    st, _, _ = tf.fleet_step_pcm(params, cfg, st, pcm[:, :T * cfg.audio.hop_length], t_ada)
    js = jf.init_fleet_state(tiny_cfg, 2, kv_dtype="int8", **KW)
    jleaves = jax.tree_util.tree_leaves(js)
    assert len(jleaves) == sum(t is not None for t in tf.state_leaves(st))
    mask = np.array([True, False])
    for full in (False, True):
        mine = copy.deepcopy(st)
        ptrs = [None if t is None else t.data_ptr() for t in tf.state_leaves(mine)]
        want = tf.fleet_reset_slots(cfg, st, torch.from_numpy(mask), full=full)
        got = tf.fleet_reset_slots_(cfg, mine, torch.from_numpy(mask), full=full)
        assert got is mine
        assert ptrs == [None if t is None else t.data_ptr() for t in tf.state_leaves(mine)]
        _same_state(mine, want)
        # the JAX reset of the same values
        jstate = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(js),
            [jnp.asarray(t.numpy()) for t in tf.state_leaves(st) if t is not None])
        jr = jf.fleet_reset_slots(tiny_cfg, jstate, jnp.asarray(mask), full=full)
        for a, b in zip([t for t in tf.state_leaves(mine) if t is not None],
                        jax.tree_util.tree_leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_replays_count_the_captured_launches():
    """`counted` takes a capture's counts back out and keeps the change;
    each replay adds it again."""
    saved = [dict(c) for c in sg.COUNTERS]
    try:
        for mod in (ring_attention, q8_matmul, norms):
            mod.reset_launches()

        def capture():
            norms.LAUNCHES["add_rms_norm"] += 52
            ring_attention.LAUNCHES["ring_gqa_attention_int8"] += 26
            q8_matmul.LARGE_M_CALLS["q8_mm"] += 7
            return "outputs"

        out, change = sg.counted(capture)
        assert out == "outputs"
        assert change == {(4, "add_rms_norm"): 52, (0, "ring_gqa_attention_int8"): 26,
                          (2, "q8_mm"): 7}
        assert norms.LAUNCHES["add_rms_norm"] == 0 and q8_matmul.LARGE_M_CALLS["q8_mm"] == 0
        graph = _Graph(lambda: None)
        entry = sg.Captured(graph, (torch.zeros(3),), ("outputs",), change)
        for i in range(5):
            assert entry.replay((torch.full((3,), float(i)),)) == ("outputs",)
        assert graph.replays == 5 and entry.inputs[0].tolist() == [4.0] * 3
        assert norms.LAUNCHES["add_rms_norm"] == 5 * 52
        assert ring_attention.LAUNCHES["ring_gqa_attention_int8"] == 5 * 26
        assert q8_matmul.LARGE_M_CALLS["q8_mm"] == 5 * 7
        assert q8_matmul.LAUNCHES["w8a16_gemv"] == 0
    finally:
        for c, s in zip(sg.COUNTERS, saved):
            c.update(s)


def test_capture_is_refused_on_the_cpu_and_with_tp(cfg, params):
    st = tf.init_fleet_state(cfg, 2, device=CPU, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        sg.FleetStepGraphs(params, cfg, st)
    with pytest.raises(ValueError, match="tp"):
        sg.FleetStepGraphs(params, cfg, st, tp=object())
    kw = dict(batch=2, chunk_tokens=8, dec_ring=256, device=CPU)
    for extra in ({}, {"tp": object()}):
        with pytest.raises(ValueError, match="step_graphs=True"):
            FleetManager(params, cfg, step_graphs=True, **kw, **extra)
    for flag in (None, False):
        assert FleetManager(params, cfg, step_graphs=flag, **kw)._graphs is None


def test_manager_through_graphs_matches_jax(weights, cfgs, monkeypatch):
    """A CPU FleetManager dispatching through the (emulated) step graphs,
    with a mid-flight attach, a KV watchdog restart (a full reset written in
    place) and a chunk change, equals the JAX manager after every poll."""
    made = emulate(monkeypatch)
    patch_both(monkeypatch, "MAX_DECODE_KV", 40)
    twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8, max_chunk_tokens=12,
                dec_ring=256, continuous=True, monitor=True)
    mgr = twin.t
    mgr._graphs = sg.FleetStepGraphs(mgr.params, mgr.cfg, mgr.state)
    state = mgr.state
    s0 = twin.attach()
    twin.feed(s0, audio(41, seconds=1.5))
    twin.poll()
    twin.check()
    s1 = twin.attach()
    twin.serve({s0: audio(42, seconds=2.0), s1: audio(43, seconds=1.5)})
    twin.detach(s0)
    twin.detach(s1)
    twin.set_chunk_tokens(12)
    s0, s1 = twin.attach(), twin.attach()
    twin.serve({s0: audio(44, seconds=1.5), s1: audio(45, seconds=1.0)})
    assert mgr.state is state
    assert mgr.stats()["restarts"] >= 1
    assert len(made) == 2 and all(e.graph.replays for e in made)
    mgr.close()
    assert mgr._graphs is None
