"""The single-stream programs captured per bucket (voxtral_tpu_torch.runtime.
step_graph's StateGraphs and DecodeGraphs) on the CPU, tiny config, f32:
the keys of the decode scan and the bucket programs, the in-place resets
the owned states need, the offline pipeline and the bucketed VoxStream
through the owners against the JAX package, and the refusals.

CUDA graphs exist only on the card (chip_smoke.py phases 3 and 9 hold
replays against eager runs bit for bit there). Here capture is emulated as
in test_torch_step_graph.py: it records the program's outputs and launches
and leaves the state as it was, and a replay runs the same program on the
static inputs, so the owners' own logic (first call eager, second captured
and replayed, inputs into static buffers, states copied back into the
owned tensors, one key per static shape) runs as on the card."""

import copy
import gc

import numpy as np
import pytest
import torch

import voxtral_tpu.runtime.stream as jax_stream
import voxtral_tpu_torch.runtime.stream as port_stream
from test_torch_step_graph import _same_state, emulate
from test_torch_stream import Pair, audio, numpy_mel, tok_path, weights  # noqa: F401
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models import encoder as tenc
from voxtral_tpu_torch.models import pipeline as tpipe
from voxtral_tpu_torch.quant import quantize_params
from voxtral_tpu_torch.runtime import fleet as tf
from voxtral_tpu_torch.runtime import step_graph as sg

torch.set_num_threads(2)

CPU = "cpu"


def _ptrs(state):
    return [None if t is None else t.data_ptr() for t in tf.state_leaves(state)]


def _entries(graphs) -> dict:
    """{program entry: number of keys} of an owner."""
    out = {}
    for key in graphs._graphs:
        out[key[0]] = out.get(key[0], 0) + 1
    return out


def _clip(seconds, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16000)) * 0.3).astype(np.float32)


def test_scan_and_program_keys_follow_every_static_argument(weights):
    """Each static argument of a decode scan (B, steps, pending size, ring
    dtype and width, collect_topk, stop_at_eos, forced tokens, Q8) and of a
    bucket program (entry, input shapes and dtypes) gives another key; the
    same call gives the same key."""
    cfg, dec = tiny_config(), weights["random"][1]["decoder"]
    q8 = quantize_params(copy.deepcopy(weights["random"][1]))["decoder"]
    st = tdec.init_decode_state(cfg, batch=1, device=CPU)
    d = cfg.decoder.dim

    def inputs(b=1, n=8, forced=False):
        return (torch.zeros(b, n, d), torch.ones(b, dtype=torch.int32), torch.zeros(3, d),
                torch.zeros(b, n, dtype=torch.int32) if forced else None)

    kw = dict(collect_topk=0, stop_at_eos=True)
    base = sg.scan_key(dec, st, inputs(), **kw)
    assert sg.scan_key(dec, st, inputs(), **kw) == base
    others = [
        sg.scan_key(dec, tdec.init_decode_state(cfg, batch=2, device=CPU), inputs(b=2), **kw),
        sg.scan_key(dec, st, inputs(n=16), **kw),
        sg.scan_key(dec, tdec.init_decode_state(cfg, batch=1, pending_size=32, device=CPU),
                    inputs(), **kw),
        sg.scan_key(dec, tdec.init_decode_state(cfg, batch=1, kv_dtype="int8", device=CPU),
                    inputs(), **kw),
        sg.scan_key(dec, tdec.init_decode_state(cfg, batch=1, dtype=torch.bfloat16,
                                                device=CPU), inputs(), **kw),
        sg.scan_key(dec, st, inputs(), **{**kw, "collect_topk": 1}),
        sg.scan_key(dec, st, inputs(), **{**kw, "stop_at_eos": False}),
        sg.scan_key(dec, st, inputs(forced=True), **kw),
        sg.scan_key(q8, st, inputs(), **kw),
    ]
    assert len({base, *others}) == len(others) + 1
    x = (torch.zeros(128, 66),)
    prog = sg.program_key("conv0", dec, x)
    assert sg.program_key("conv0", dec, (torch.ones(128, 66),)) == prog
    assert len({prog, sg.program_key("conv1", dec, x),
                sg.program_key("conv0", dec, (torch.zeros(128, 130),)),
                sg.program_key("conv0", dec, (torch.zeros(128, 66, dtype=torch.bfloat16),)),
                sg.program_key("conv0", q8, x)}) == 5


@pytest.mark.parametrize("kv", ["float", "int8", "int4"])
def test_in_place_initial_states_match_fresh_ones(weights, kv):
    """init_decode_state_ and init_encoder_state_ write the initial values
    into a used state's own tensors: equal to a fresh state, storage kept."""
    cfg, params = tiny_config(), weights["random"][1]
    enc = tenc.init_encoder_state(cfg, ring_size=48, pending_size=8, kv_dtype=kv, device=CPU)
    enc, _ = tenc.encoder_incremental(params["encoder"], cfg, enc,
                                      torch.randn(1, 8, cfg.encoder.dim), 5)
    enc, _ = tenc.encoder_incremental(params["encoder"], cfg, enc,
                                      torch.randn(1, 8, cfg.encoder.dim), 8)
    ptrs = _ptrs(enc)
    assert tenc.init_encoder_state_(enc) is enc
    assert _ptrs(enc) == ptrs
    _same_state(enc, tenc.init_encoder_state(cfg, ring_size=48, pending_size=8,
                                             kv_dtype=kv, device=CPU))
    if kv == "int4":
        return
    dec = tdec.init_decode_state(cfg, batch=2, ring_size=64, pending_size=8, kv_dtype=kv,
                                 device=CPU)
    t_ada = torch.randn(cfg.decoder.layers, cfg.decoder.dim) * 0.1
    dec = tdec.decoder_prefill(params["decoder"], cfg, dec,
                               torch.randn(2, 5, cfg.decoder.dim), t_ada)
    dec, _, _ = tdec.decode_scan(params["decoder"], cfg, dec, torch.randn(2, 4, cfg.decoder.dim),
                                 torch.tensor([4, 2], dtype=torch.int32), t_ada)
    ptrs = _ptrs(dec)
    assert tdec.init_decode_state_(dec) is dec
    assert _ptrs(dec) == ptrs
    _same_state(dec, tdec.init_decode_state(cfg, batch=2, ring_size=64, pending_size=8,
                                            kv_dtype=kv, device=CPU))


def test_pipeline_through_graphs_matches_jax(weights, tiny_params, monkeypatch):
    """transcribe_tokens_batch through the (emulated) graphs of its cached
    owner: clips whose ragged last decode call is padded (one of them
    longer than a 64-step call), each twice, give the JAX pipeline's tokens
    and aux rows; the owner keeps one resident state, reset in place at
    each request, with at most four decode keys and one prefill key; the
    eager path gives the same bits; the owner goes with the weights."""
    cfg = tiny_config()
    params = copy.deepcopy(weights["random"][1])
    clips = [_clip(2.0, 1), _clip(6.0, 2), _clip(3.3, 3)]
    eager = [tpipe.transcribe_tokens_batch(params, cfg, clip, collect_topk=2, device=CPU,
                                           step_graphs=False) for clip in clips]
    made = emulate(monkeypatch)
    real = tpipe._request_graphs
    monkeypatch.setattr(tpipe, "_request_graphs",
                        lambda p, c, d, capture: real(p, c, d, True))
    state = None
    for rep in range(2):
        for i, clip in enumerate(clips):
            tokens, aux = tpipe.transcribe_tokens_batch(params, cfg, clip, collect_topk=2,
                                                        device=CPU)
            graphs = tpipe.request_graphs(params, cfg)
            if state is None:
                state = graphs.state
            assert graphs.state is state
            steps = aux["best_logit"].shape[1]
            assert sum(m for m, _ in tpipe.decode_calls(steps)) == steps
            if rep == 0:
                if i == 1:
                    assert steps > 64 and steps % 64
                jtokens, jaux = jax_transcribe(tiny_params, cfg_jax(), clip, collect_topk=2)
                assert tokens == jtokens
                np.testing.assert_allclose(aux["packed"].numpy(), np.asarray(jaux["packed"]),
                                           atol=1e-5, rtol=1e-5)
            assert tokens == eager[i][0]
            assert torch.equal(aux["packed"], eager[i][1]["packed"])
    entries = _entries(graphs)
    assert entries["prefill"] == 1 and 1 < entries["decode_scan"] <= 4
    assert made and all(e.graph.replays for e in made)
    ptrs = _ptrs(state)
    with torch.inference_mode():            # the request's state is an inference tensor
        tdec.init_decode_state_(graphs.state)
    _same_state(graphs.state, tdec.init_decode_state(cfg, batch=1, device=CPU))
    assert _ptrs(graphs.state) == ptrs
    # the emulated graphs hold their programs, and so the weights; real
    # graphs hold no Python reference
    graphs.close()
    made.clear()
    n = len(sg._OWNERS)
    del params, graphs, state
    gc.collect()
    assert len(sg._OWNERS) == n - 1


def cfg_jax():
    from voxtral_tpu.config import tiny_config as jax_tiny
    return jax_tiny()


def test_bucketed_stream_through_graphs_matches_jax(weights, audio, tok_path,  # noqa: F811
                                                    monkeypatch):
    """A continuous bucketed VoxStream with alt-tokens (n_alt 2) through the
    (emulated) graphs, fed in ragged pieces, with a decoder reset forced by
    the watchdog and full resets by its KV bound, equals the JAX bucketed
    VoxStream: generated_ids, the queue, the monitor and stats' counters.
    The resets write into the owned states (storage kept) and give what
    reset_streams and a fresh encoder state give; at most four decode keys,
    one prefill key and one key per mel bucket for each encoder program."""
    made = emulate(monkeypatch)
    p = Pair(weights["lively"], tok_path, interval=0.5, n_alt=2, alt_cutoff=0.95,
             continuous=True)
    t = p.t
    t._enc = sg.StateGraphs(t.enc_state)
    t._dec = sg.DecodeGraphs(t.decode_state)
    enc, dec = t.enc_state, t.decode_state
    ptrs = (_ptrs(enc), _ptrs(dec))
    p.feed_all(audio, (1600, 4096, 999))
    p.check()
    assert t.decoder_started
    want = tdec.reset_streams(copy.deepcopy(dec), torch.ones(1, dtype=torch.bool),
                              tiny_config().streaming.bos, reset_write_ctr=True)
    p.set(eos_seen=True)                     # a textless EOS: decoder reset
    p._watchdog()
    assert t.monitor_log[-1] == "↺✂"
    _same_state(t.decode_state, want)
    for mod in (jax_stream, port_stream):
        monkeypatch.setattr(mod, "MAX_DECODE_KV", 40)
    for _ in range(2):
        p.feed_all(audio, (1600, 4096, 999))
    p.check()
    assert any(sym == "⟳♻" for sym in t.monitor_log), t.monitor_log
    t._reset_full()
    p.j._reset_full()
    _same_state(t.enc_state, tenc.init_encoder_state(tiny_config(), ring_size=t.sc.ring_size,
                                                     batch=1, device=CPU))
    p.feed_all(audio, (16000,))
    p.finish()
    p.check()
    assert t.n_text_tokens > 0 and any(q[2] for q in t.queue)
    assert t.enc_state is enc and t.decode_state is dec
    assert (_ptrs(enc), _ptrs(dec)) == ptrs
    de, ee = _entries(t._dec), _entries(t._enc)
    assert de["prefill"] == 1 and de["decode_scan"] <= 4
    assert set(ee) == {"conv0", "conv1", "encoder", "adapter"}
    assert all(v <= len(port_stream.MEL_BUCKETS) for v in ee.values())
    assert made and sum(e.graph.replays for e in made) > len(made)


def test_step_graphs_true_is_refused_on_the_cpu(weights):
    cfg, params = tiny_config(), weights["random"][1]
    with pytest.raises(ValueError, match="step_graphs=True"):
        tpipe.transcribe_tokens_batch(params, cfg, _clip(1.0, 0), device=CPU,
                                      step_graphs=True)
    for backend in ("bucketed", "fused"):
        with pytest.raises(ValueError, match="step_graphs=True"):
            port_stream.VoxStream(params, cfg, device=CPU, stream_cfg=port_stream.StreamConfig(
                backend=backend, step_graphs=True))
    st = tdec.init_decode_state(cfg, device=CPU)
    for make in (lambda: sg.DecodeGraphs(st), lambda: sg.StateGraphs(st)):
        with pytest.raises(ValueError, match="CUDA"):
            make()
    for flag in (None, False):
        s = port_stream.VoxStream(params, cfg, device=CPU, stream_cfg=port_stream.StreamConfig(
            backend="bucketed", step_graphs=flag))
        assert not s._enc.capture and not s._dec.capture
