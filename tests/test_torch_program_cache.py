"""The process's program cache (voxtral_tpu_torch.runtime.step_graph's
`lease`, `release`, `weights_key`) on the CPU, tiny config, f32: owners
keyed on every tensor of the weights, the offline request's encoder half
through the owner's programs at each front remainder and ladder rung, and
bucketed streams and FleetManagers that lease one another's owners, each
against the JAX package.

CUDA graphs exist only on the card (chip_smoke.py phases 3, 8b and 9b
hold replays against eager runs there). Here capture is emulated as in
test_torch_step_graph.py, and the entry points are made to capture on the
CPU by patching their `wants_capture`. An emulated graph replays the
program it recorded, with the weights that program closed over, just as a
real graph reads the addresses of the weights its capture was given; so a
replay on the wrong owner shows as another tree's tokens."""

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxtral_tpu_torch.runtime.manager as port_manager
import voxtral_tpu_torch.runtime.stream as port_stream
from test_torch_manager import Twin, patch_both
from test_torch_step_graph import _same_state, emulate
from test_torch_stream import Pair, _lively, numpy_mel, tok_path, weights  # noqa: F401
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.models.pipeline import _pipeline_jit
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.audio.mel import batch_log_mel, pad_audio_offline
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models import pipeline as tpipe
from voxtral_tpu_torch.quant import quantize_params
from voxtral_tpu_torch.runtime import fleet as tf
from voxtral_tpu_torch.runtime import step_graph as sg
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"


def _clip(seconds, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16000)) * 0.3).astype(np.float32)


def _ptrs(state):
    return [None if t is None else t.data_ptr() for t in tf.state_leaves(state)]


def _capture_on_the_cpu(monkeypatch):
    """Emulated capture, and every entry point capturing on the CPU."""
    made = emulate(monkeypatch)
    real = tpipe._request_graphs
    monkeypatch.setattr(tpipe, "_request_graphs", lambda p, c, d, capture: real(p, c, d, True))
    for mod in (port_stream, port_manager):
        monkeypatch.setattr(mod, "wants_capture", lambda step_graphs, dev, tp=None: True)
    return made


def _tokens(tokens) -> list:
    out = []
    for t in np.asarray(tokens).tolist():
        if t < 0:
            break
        out.append(t)
    return out


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def test_trees_sharing_embed_replay_their_own_weights(monkeypatch):
    """Two trees that share the embedding table and differ in layer 0's wv
    (another seed's), each requested after the other has captured, give
    their own JAX pipeline's tokens: each tree has owners of its own.
    Values written into a tree's tensors in place are read by its
    replays. (On the tiny tree another wq moves the logits by 5e-5 and no
    token; another wv moves tokens from the 23rd on.)"""
    made = _capture_on_the_cpu(monkeypatch)
    cfg = tiny_config()
    live = _lively(jax_random_params(jax_tiny(), 1234, numpy_out=True))
    wv = jax_random_params(jax_tiny(), 99, numpy_out=True)["decoder"]["layers"][0]["wv"]
    layers_b = [{**live["decoder"]["layers"][0], "wv": wv}, *live["decoder"]["layers"][1:]]
    live_b = {**live, "decoder": {**live["decoder"], "layers": layers_b}}
    pa = from_numpy_params(live, CPU)
    wv_b = from_numpy_params(live_b, CPU)["decoder"]["layers"][0]["wv"]
    pb = {**pa, "decoder": {**pa["decoder"], "layers": [
        {**pa["decoder"]["layers"][0], "wv": wv_b}, *pa["decoder"]["layers"][1:]]}}
    assert pb["decoder"]["embed"] is pa["decoder"]["embed"]
    clip = _clip(2.0, 5)
    want = {name: jax_transcribe(jax.tree.map(jnp.asarray, tree), jax_tiny(), clip,
                                 collect_topk=2)
            for name, tree in (("a", live), ("b", live_b))}
    assert want["a"][0] != want["b"][0]
    for name, params in (("a", pa), ("a", pa), ("b", pb), ("b", pb), ("a", pa)):
        tokens, aux = tpipe.transcribe_tokens_batch(params, cfg, clip, collect_topk=2,
                                                    device=CPU)
        jtokens, jaux = want[name]
        assert tokens == jtokens, (f"tree {name}: first differing token "
                                   f"{_first_difference(tokens, jtokens)}")
        np.testing.assert_allclose(aux["packed"].numpy(), np.asarray(jaux["packed"]),
                                   atol=1e-5, rtol=1e-5)
    owner_a, owner_b = tpipe.request_graphs(pa, cfg), tpipe.request_graphs(pb, cfg)
    assert owner_a is not owner_b and not owner_a.leased and not owner_b.leased
    assert sg.weights_key(pa) != sg.weights_key(pb)
    with torch.no_grad():
        pa["decoder"]["layers"][0]["wv"].copy_(wv_b)
    tokens, _ = tpipe.transcribe_tokens_batch(pa, cfg, clip, collect_topk=2, device=CPU)
    assert tokens == want["b"][0]
    assert tpipe.request_graphs(pa, cfg) is owner_a
    assert made and all(e.graph.replays for e in made)


def test_weights_key_reads_every_tensor_and_its_place():
    """Every tensor of the tree counts (a Quantized leaf's codes and scales),
    with its place: swapping two tensors of one shape, a new tensor, or a
    view at another offset gives another key; the same tensors in a new
    tree of the same structure give the same key."""
    cfg = tiny_config()
    params = from_numpy_params(jax_random_params(jax_tiny(), 7, numpy_out=True), CPU)
    key = sg.weights_key(params)
    assert len(key) == len(sg._weight_tensors(params))
    assert sg.weights_key({**params, "decoder": dict(params["decoder"])}) == key
    lay = params["decoder"]["layers"][0]
    assert lay["wk"].shape == lay["wv"].shape
    swapped = {**lay, "wk": lay["wv"], "wv": lay["wk"]}
    others = [
        {**params, "decoder": {**params["decoder"],
                               "layers": [swapped, *params["decoder"]["layers"][1:]]}},
        {**params, "adapter": {**params["adapter"], "w0": params["adapter"]["w0"].clone()}},
        {**params, "encoder": {**params["encoder"], "conv0_b": params["encoder"]["conv0_b"][1:]}},
    ]
    assert len({key, *(sg.weights_key(p) for p in others)}) == len(others) + 1
    q8 = quantize_params(from_numpy_params(jax_random_params(jax_tiny(), 7, numpy_out=True),
                                           CPU))
    paths = [p for p, _ in sg._weight_tensors(q8)]
    assert ("decoder", "embed", "q") in paths and ("decoder", "embed", "s") in paths
    sig = sg.state_signature(tdec.init_decode_state(cfg, batch=1, device=CPU))
    assert sig == sg.state_signature(tdec.init_decode_state(cfg, batch=1, device="meta"))
    assert sig != sg.state_signature(tdec.init_decode_state(cfg, batch=2, device=CPU))


def test_encoder_ladder():
    """Every row count has a rung: at least the rows, a multiple of 8 (so of
    the downsample), under 1/8 of padding above ENCODER_MIN_ROWS, at most
    ENCODER_RUNGS rungs an octave, and non-decreasing."""
    rungs = [tpipe.encoder_rows(n) for n in range(1, 5000)]
    assert all(r >= n and r % 8 == 0 for n, r in enumerate(rungs, 1))
    assert all((r - n) * tpipe.ENCODER_RUNGS < n
               for n, r in enumerate(rungs, 1) if n > tpipe.ENCODER_MIN_ROWS)
    assert rungs == sorted(rungs)
    for lo in (128, 256, 512, 1024, 2048):
        assert len(set(rungs[lo:2 * lo])) <= tpipe.ENCODER_RUNGS
    for rows, rem in ((247, 3), (346, 2), (1697, 1)):
        mel, n_audio = tpipe.encoder_mel(torch.zeros(128, 2 * rows), 4)
        assert (mel.shape[1] // 2) % 4 == rem and n_audio == (rows - rem) // 4
        assert mel.shape[1] // 2 - rem == tpipe.encoder_rows(rows - rem)


@pytest.mark.parametrize("rem,seconds", [(0, 1.0), (1, 1.0), (2, 3.0), (3, 3.0)])
def test_offline_encoder_through_graphs_per_front_remainder(weights, monkeypatch,  # noqa: F811
                                                            rem, seconds):
    """The request's programs, its encoder half included, through a leased
    owner's (emulated) graphs, on a mel whose conv stem leaves `rem` rows
    before a multiple of the downsample (dropped at the front): tokens and
    aux equal to the JAX pipeline on the unpadded mel, bit for bit equal
    to the eager programs on each pass. A second mel, four rows shorter,
    falls on the same rung and remainder: one encoder program for both."""
    _capture_on_the_cpu(monkeypatch)
    cfg, params = tiny_config(), weights["lively"][1]
    mel = batch_log_mel(pad_audio_offline(_clip(seconds, 40 + rem), cfg.audio, cfg.streaming),
                        cfg.audio)
    rows = mel.shape[1] // 2
    rows -= (rows - rem) % 4
    rows = rem + min(rows - rem, tpipe.encoder_rows(rows - rem - 4))
    mels = [torch.from_numpy(np.ascontiguousarray(mel[:, :2 * r])) for r in (rows, rows - 4)]
    assert tpipe.encoder_rows(rows - rem) == tpipe.encoder_rows(rows - rem - 4)
    delay = cfg.streaming.delay_tokens

    @torch.inference_mode()
    def run(m, capture):
        if not capture:
            graphs = sg.DecodeGraphs(tdec.init_decode_state(cfg, batch=1, device=CPU),
                                     capture=False)
            return tpipe._pipeline(params, cfg, m, delay, 2, graphs)
        graphs = tpipe._request_graphs(params, cfg, CPU, True)
        try:
            return tpipe._pipeline(params, cfg, m, delay, 2, graphs)
        finally:
            sg.release(graphs)

    eager = [run(m, False) for m in mels]
    jtok, jaux = _pipeline_jit(weights["lively"][0], jax_tiny(), jnp.asarray(mels[0].numpy()),
                               delay, 2)
    assert _tokens(eager[0][0]) == _tokens(jtok)
    np.testing.assert_allclose(eager[0][1]["packed"].numpy(), np.asarray(jaux["packed"]),
                               atol=1e-5, rtol=1e-5)
    for _ in range(2):
        for m, (etok, eaux) in zip(mels, eager):
            tok, aux = run(m, True)
            assert torch.equal(tok, etok) and torch.equal(aux["packed"], eaux["packed"])
    owner = tpipe.request_graphs(params, cfg)
    (pad,) = {tuple(tpipe.encoder_mel(m, cfg.downsample)[0].shape) for m in mels}
    (key,) = [k for k in owner._graphs if k[0] == "encoder" and k[1][0][0] == pad]
    assert owner._graphs[key].graph.replays >= 2


def test_bucketed_streams_in_sequence_lease_one_owner(weights, tok_path, monkeypatch):  # noqa: F811
    """A bucketed stream that follows another on the same weights leases
    the first's two owners once the first is collected, captures no new
    key, and equals the JAX VoxStream, as the first did."""
    made = _capture_on_the_cpu(monkeypatch)
    audio = _clip(3.0, 21)
    owners, keys = None, None
    for run in range(2):
        p = Pair(weights["lively"], tok_path, interval=0.5)
        t = p.t
        assert t._capture and t._enc.leased and t._dec.leased
        if owners is not None:
            assert (t._enc, t._dec) == owners
        p.feed_all(audio, (1600, 4096, 999))
        p.finish()
        p.check()
        assert t.n_generated > 0
        now = (set(t._enc.capture_s), set(t._dec.capture_s))
        if keys is not None:
            assert now == keys
        owners, keys = (t._enc, t._dec), now
        del p, t                  # no gc.collect(): the stream holds no cycle
        assert not any(o.leased for o in owners)
    assert keys[0] and keys[1]
    assert all(e.graph.replays for e in made)


def test_concurrent_streams_get_their_own_owners(weights, tok_path, monkeypatch):  # noqa: F811
    """Two bucketed streams live at once lease two owners each, never the
    same one; fed in turns, both equal their JAX VoxStreams. Closed, both
    sets go back to the cache."""
    _capture_on_the_cpu(monkeypatch)
    pairs = [Pair(weights["lively"], tok_path, interval=0.5) for _ in range(2)]
    a, b = (p.t for p in pairs)
    assert len({id(a._enc), id(a._dec), id(b._enc), id(b._dec)}) == 4
    clips = [_clip(2.0, 31), _clip(3.0, 32)]
    for pos in range(0, len(clips[1]), 3200):
        for p, clip in zip(pairs, clips):
            if pos < len(clip):
                p.feed(clip[pos:pos + 3200])
    for p in pairs:
        p.finish()
        p.check()
    assert 0 < len(a.generated_ids) < len(b.generated_ids)
    for t in (a, b):
        t.close()
        assert not t._enc.leased and not t._dec.leased
        with pytest.raises(RuntimeError, match="finished"):
            t.feed(np.zeros(160, np.float32))


def test_fleet_managers_in_sequence_share_one_owner(weights, monkeypatch):  # noqa: F811
    """A FleetManager closed gives its step graphs back; the next manager
    of the same weights and shapes leases them, its state reset in place,
    captures no new key and equals the JAX manager, as the first did. A
    fused VoxStream's manager goes back when the stream is collected (its
    monitor holds no cycle); a closed manager polls no more."""
    made = _capture_on_the_cpu(monkeypatch)
    patch_both(monkeypatch, "MAX_DECODE_KV", 40)
    cfgs = (jax_tiny(), tiny_config())
    owner, keys = None, None
    for run in range(2):
        twin = Twin(weights["lively"], cfgs, batch=2, chunk_tokens=8, dec_ring=256,
                    continuous=True, monitor=True)
        mgr = twin.t
        if owner is None:
            fresh = copy.deepcopy(mgr.state)
        else:
            assert mgr._graphs is owner and mgr.state is owner.state
            _same_state(mgr.state, fresh)
        s0, s1 = twin.attach(), twin.attach()
        twin.serve({s0: _clip(1.5, 44 + run), s1: _clip(1.0, 46 + run)})
        owner = mgr._graphs
        assert owner is not None and owner.leased
        if keys is not None:
            assert set(owner.capture_s) == keys
        keys = set(owner.capture_s)
        mgr.close()
        assert not owner.leased and mgr._graphs is None
        with pytest.raises(RuntimeError, match="close"):
            mgr.poll()
    assert keys and all(e.graph.replays for e in made)
    s = port_stream.VoxStream(weights["lively"][1], tiny_config(), device=CPU,
                              stream_cfg=port_stream.StreamConfig(backend="fused",
                                                                  monitor=True))
    fused = s._mgr._graphs
    assert fused.leased and fused is not owner
    s.feed(_clip(0.5, 3))
    del s
    assert not fused.leased


def test_owner_goes_with_its_weights(weights, monkeypatch):  # noqa: F811
    """The cache drops a tree's owners when any tensor of the tree goes,
    and no owner keeps the weights alive: the owners are freed."""
    _capture_on_the_cpu(monkeypatch)
    cfg = tiny_config()
    params = from_numpy_params(jax_random_params(jax_tiny(), 3, numpy_out=True), CPU)
    make = tpipe._request_state(cfg)
    first = sg.lease(sg.DecodeGraphs, params, cfg, make, tdec.init_decode_state_)
    second = sg.lease(sg.DecodeGraphs, params, cfg, make, tdec.init_decode_state_)
    assert first is not second
    sg.release(first)
    again = sg.lease(sg.DecodeGraphs, params, cfg, make, tdec.init_decode_state_)
    assert again is first
    sg.release(first, second)
    assert sg.cached(sg.DecodeGraphs, params, cfg, make) == [first, second]
    refs = [weakref.ref(first), weakref.ref(second)]
    wkey = sg.weights_key(params)
    del first, second, again
    params["decoder"]["layers"][1]["w2"] = params["decoder"]["layers"][1]["w2"].clone()
    gc.collect()
    assert wkey not in sg._OWNERS
    assert all(r() is None for r in refs)
    assert sg.cached(sg.DecodeGraphs, params, cfg, make) == []
    owner = weakref.ref(sg.lease(sg.DecodeGraphs, params, cfg, make, tdec.init_decode_state_))
    del params
    gc.collect()
    assert owner() is None


@pytest.mark.parametrize("kv,enc_kv", [("float", None), ("int8", None), ("int8", "int4")])
def test_init_fleet_state_in_place_matches_fresh(weights, kv, enc_kv):  # noqa: F811
    """init_fleet_state_ writes init_fleet_state's values into a used
    state's own tensors, bit for bit, every storage kept."""
    cfg, params = tiny_config(), weights["lively"][1]
    kw = dict(enc_ring=192, dec_ring=64, max_mel_chunk=320, kv_dtype=kv, enc_kv_dtype=enc_kv,
              device=CPU)
    st = tf.init_fleet_state(cfg, 2, **kw)
    t_ada = tdec.ada_scales(params["decoder"], tdec.time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim))
    pcm = torch.from_numpy(np.stack([_clip(4.0, 8), _clip(4.0, 9)]))
    hop = cfg.audio.hop_length
    st, _, _ = tf.fleet_bootstrap_pcm(params, cfg, st, pcm[:, :320 * hop], t_ada)
    st, _, _ = tf.fleet_step_pcm(params, cfg, st, pcm[:, 320 * hop:384 * hop], t_ada)
    ptrs = _ptrs(st)
    assert tf.init_fleet_state_(st) is st
    assert _ptrs(st) == ptrs
    _same_state(st, tf.init_fleet_state(cfg, 2, **kw))
