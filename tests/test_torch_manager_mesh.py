"""FleetManager(tp=) on four ranks, a (data 2 x model 2) mesh over gloo on
the CPU, against the JAX package's single-device manager, exactly
(tests/test_manager.py's meshed cases, :248, :274 and :632): the tiny
config (heads, kv heads, FFN and vocabulary split in two), int8 decoder
rings, chunk 8, dec_ring 256, global batch 2, so each data rank serves one
row and its two model ranks hold the same row.

- the meshed manager: two streams, one per data rank, against one JAX
  manager serving both;
- Q8 params (the port's quantize_params of the whole tree, sliced by each
  rank): one stream on data rank 0 while data rank 1 has none and steps
  all-inactive blocks, against the JAX manager alone on the JAX Q8 tree;
- slot churn: data rank 0 finishes, detaches and re-attaches its slot
  while data rank 1's stream keeps running; both streams against the JAX
  manager taking the same calls, and the reborn stream against its solo
  JAX run.

Every model rank of a data index must return the same tokens, and every
rank the same step count. The ranks run in one spawn
(`parallel.launch.run_ranks`) with one thread each while the parent
computes the JAX references in threads; jax is imported only in the
parent's fixture.
"""

import concurrent.futures
import copy

import numpy as np
import pytest
import torch

from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.parallel import any_across_hosts, global_mesh
from voxtral_tpu_torch.parallel.launch import run_ranks
from voxtral_tpu_torch.quant import quantize_params
from voxtral_tpu_torch.runtime import FleetManager
from voxtral_tpu_torch.weights import from_numpy_params

KW = dict(batch=2, chunk_tokens=8, dec_ring=256, continuous=True, kv_dtype="int8")
TIMEOUT = 240.0


def _audio(seed, seconds=3.0):
    """tests/test_manager.py:_audio."""
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 16000)) * 0.3).astype(np.float32)


AUDIO = {"meshed": (_audio(3), _audio(4, seconds=2.0)), "q8": (_audio(15, seconds=2.0),),
         "churn": (_audio(31, seconds=2.0), _audio(32, seconds=3.0), _audio(33, seconds=2.0))}


def serve_agreed(mgr, feeds, piece=16000):
    """tests/test_manager.py:_serve on one rank of a multi-process fleet:
    feeds {local sid: audio} in `piece`-sample chunks, a poll after each
    round, then finish and drain. Every rank calls it (with its own feeds,
    possibly none), and each loop runs while any rank has work, so all
    ranks take the polls that one process serving every feed would.
    Returns {sid: all_ids}."""
    pos = dict.fromkeys(feeds, 0)
    while any_across_hosts([any(pos[s] < len(a) for s, a in feeds.items())])[0]:
        for sid, a in feeds.items():
            if pos[sid] < len(a):
                mgr.feed(sid, a[pos[sid]:pos[sid] + piece])
                pos[sid] += piece
        mgr.poll()
    for sid in feeds:
        mgr.finish(sid)
    for _ in range(64):
        if not any_across_hosts([not all(mgr.is_finished(s) for s in feeds)])[0]:
            break
        mgr.poll()
    return {sid: list(mgr.slots[sid].all_ids) for sid in feeds}


def meshed(mgr):
    """tests/test_manager.py:248's flow on the rows held here: global row r
    serves AUDIO["meshed"][r]. Returns {row: all_ids}."""
    rows = {mgr.attach(): row for row in range(mgr.row_lo, mgr.row_hi)}
    got = serve_agreed(mgr, {sid: AUDIO["meshed"][row] for sid, row in rows.items()})
    return {row: got[sid] for sid, row in rows.items()}


def churn(mgr):
    """tests/test_manager.py:632's slot churn on the rows held here (both on
    one process, one on a data rank). Row 0 (audio a0) and row 1 (a1) are
    fed 1 s pieces; row 0 finishes, drains and is detached, and its slot
    takes a2 while row 1 goes on with the rest of a1. Returns {"a2": ...,
    "a1": ...}: all_ids of the rows held here."""
    a0, a1, a2 = AUDIO["churn"]
    streams = {row: mgr.attach() for row in range(mgr.row_lo, mgr.row_hi)}
    for i in range(0, len(a0), 16000):
        for row, sid in streams.items():
            mgr.feed(sid, (a0, a1)[row][i:i + 16000])
        mgr.poll()
    fed1 = (len(a0) // 16000) * 16000
    if 0 in streams:
        mgr.finish(streams[0])
    for _ in range(64):
        if not any_across_hosts([0 in streams and not mgr.is_finished(streams[0])])[0]:
            break
        mgr.poll()
    feeds, names = {}, {}
    if 0 in streams:
        assert mgr.is_finished(streams[0])
        mgr.detach(streams[0])
        s2 = mgr.attach()
        assert s2 == streams[0]
        feeds[s2], names[s2] = a2, "a2"
    if 1 in streams:
        feeds[streams[1]], names[streams[1]] = a1[fed1:], "a1"
    got = serve_agreed(mgr, feeds)
    return {names[sid]: ids for sid, ids in got.items()}


def _rank_main(rank, world, params, q8_params):
    """One rank of the (2 x 2) mesh: the three cases. Returns (data rank,
    model rank, {case: (global row or name -> all_ids, steps)})."""
    torch.set_num_threads(1)
    tp = global_mesh(2, 2, device_type="cpu")
    cfg = tiny_config()
    d = tp.data_rank
    out = {}
    mgr = FleetManager(params, cfg, **KW, device="cpu", tp=tp)
    assert (mgr.row_lo, mgr.row_hi, mgr.local_batch) == (d, d + 1, 1)
    out["meshed"] = (meshed(mgr), mgr.steps)
    mgr = FleetManager(q8_params, cfg, **KW, device="cpu", tp=tp)
    feeds = {mgr.attach(): AUDIO["q8"][0]} if d == 0 else {}
    got = serve_agreed(mgr, feeds)
    out["q8"] = ({0: got[0]} if d == 0 else {}, mgr.steps)
    mgr = FleetManager(params, cfg, **KW, device="cpu", tp=tp)
    out["churn"] = (churn(mgr), mgr.steps)
    return d, tp.model_rank, out


def _jax_refs(tree):
    """The JAX single-device managers' results of the three cases, the
    reborn stream's solo run, and their step counts."""
    import jax
    import jax.numpy as jnp
    from voxtral_tpu.config import tiny_config as jax_tiny_config
    from voxtral_tpu.quant import quantize_params as jax_quantize_params
    from voxtral_tpu.runtime.manager import FleetManager as JaxFleetManager

    cfg = jax_tiny_config()
    params = jax.tree.map(jnp.asarray, tree)

    def meshed_one():
        mgr = JaxFleetManager(params, cfg, **KW)
        return meshed(mgr), mgr.steps

    def q8():
        mgr = JaxFleetManager(jax_quantize_params(copy.deepcopy(params)), cfg,
                              **{**KW, "batch": 1})
        sid = mgr.attach()
        return {0: serve_agreed(mgr, {sid: AUDIO["q8"][0]})[sid]}, mgr.steps

    def slot_churn():
        mgr = JaxFleetManager(params, cfg, **KW)
        return churn(mgr), mgr.steps

    def solo2():
        mgr = JaxFleetManager(params, cfg, **{**KW, "batch": 1})
        sid = mgr.attach()
        return serve_agreed(mgr, {sid: AUDIO["churn"][2]})[sid]

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        fs = {name: ex.submit(fn) for name, fn in
              (("meshed", meshed_one), ("q8", q8), ("churn", slot_churn), ("solo2", solo2))}
        return {name: f.result() for name, f in fs.items()}


@pytest.fixture(scope="module")
def runs():
    """({case: (streams, steps)} gathered over the ranks, the JAX
    references)."""
    from test_torch_manager import _lively
    from voxtral_tpu.config import tiny_config as jax_tiny_config
    from voxtral_tpu.weights import random_params as jax_random_params
    tree = _lively(jax_random_params(jax_tiny_config(), 1234, numpy_out=True))
    params = from_numpy_params(tree, "cpu")
    q8_params = quantize_params(from_numpy_params(tree, "cpu"))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        ranks = ex.submit(run_ranks, _rank_main, 4, (params, q8_params), TIMEOUT)
        ref = ex.submit(_jax_refs, tree)
        ranks, ref = ranks.result(), ref.result()
    port = {}
    for case in ("meshed", "q8", "churn"):
        by_data, steps = {}, set()
        for d, _, out in ranks:
            streams, n = out[case]
            steps.add(n)
            if d in by_data:
                assert streams == by_data[d], f"{case}: model ranks of data {d} differ"
            by_data[d] = streams
        assert len(steps) == 1, f"{case}: ranks took {steps} steps"
        port[case] = ({k: v for d in sorted(by_data) for k, v in by_data[d].items()},
                      steps.pop())
    return port, ref


def test_meshed_manager_matches_jax_single_device(runs):
    port, ref = runs
    (got, steps), (want, want_steps) = port["meshed"], ref["meshed"]
    assert sorted(got) == [0, 1]
    assert got == want
    assert steps == want_steps


def test_meshed_manager_q8_params(runs):
    port, ref = runs
    (got, steps), (want, want_steps) = port["q8"], ref["q8"]
    assert got == want
    assert steps == want_steps


def test_meshed_manager_slot_churn_matches_single_device(runs):
    port, ref = runs
    (got, steps), (want, want_steps) = port["churn"], ref["churn"]
    assert sorted(got) == ["a1", "a2"]
    assert got == want
    assert steps == want_steps
    assert got["a2"] == ref["solo2"]
