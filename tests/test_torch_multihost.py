"""Multi-process data parallelism of the port (voxtral_tpu_torch.parallel.
distributed and FleetManager(tp=)) against the JAX package's
(tests/test_multihost.py, tests/test_manager.py):

- `host_row_range`'s partition of the global batch and its refusal of a
  batch the data axis does not divide; `any_across_hosts` as the OR over 2
  ranks and the identity on one;
- two ranks (data 2 x model 1, gloo on the CPU) serving one global fleet
  of 4 streams in lockstep, the tiny config's seed-0 weights, int8 decoder
  rings, chunk 8, dec_ring 256: the JAX worker's basic flow
  (tests/multihost_worker.py) must give the JAX single-process manager's
  tokens and step count exactly, and its asymmetric churn (rank 0 churns
  global row 0 while rank 1's rows keep feeding) each stream's solo JAX
  tokens, with pipeline_steps 1 and 2;
- the guard that keeps an emptied staged block when several ranks serve
  (tests/test_manager.py:715), on one process made to believe it is one
  of two, against the JAX manager under the same pretence;
- FleetManager(tp=) refusing a batch the data axis does not divide.

The ranks run in one spawn (`parallel.launch.run_ranks`) for the whole
file, with one thread each, while the parent computes the JAX references
in threads; the ranks import this module, so jax is imported only inside
the fixtures and tests that the parent runs. Every loop exit a rank takes
is agreed through `any_across_hosts`, as the JAX worker's are.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import multihost_worker as mw
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.parallel import (
    TensorParallel, any_across_hosts, global_mesh, host_row_range, shard_params,
)
from voxtral_tpu_torch.parallel.launch import run_ranks
from voxtral_tpu_torch.runtime import FleetManager
from voxtral_tpu_torch.weights import from_numpy_params, random_params

KW = dict(batch=mw.BATCH, chunk_tokens=8, dec_ring=256, continuous=True, kv_dtype="int8")
TIMEOUT = 240.0


def basic_flow(mgr, audio_of=mw.stream_audio):
    """tests/multihost_worker.py's basic flow: every local row a stream of
    `audio_of(global row)`, finished at once, drained in agreed polls (on
    one process the agreement is the identity, so the JAX manager runs it
    too). Returns {global row: all_ids}."""
    sids = [mgr.attach() for _ in range(mgr.local_batch)]
    for sid in sids:
        mgr.feed(sid, audio_of(mgr.row_lo + sid))
        mgr.finish(sid)
    while True:
        mgr.poll()
        pending = not all(mgr.is_finished(s) for s in sids)
        if not any_across_hosts(np.array([pending]))[0]:
            break
    return {mgr.row_lo + sid: list(mgr.slots[sid].all_ids) for sid in sids}


def solo_audio():
    """Each stream of the worker's churn flow as one clip: what it hears
    in all ({0, REBORN_SEED, 1-3: audio})."""
    solo = {0: mw.stream_audio(0), mw.REBORN_SEED: mw.stream_audio(mw.REBORN_SEED)}
    for g in range(1, mw.BATCH):
        solo[g] = np.concatenate([mw.stream_audio(g),
                                  mw.stream_audio(1000 + g, mw.EXTRA_SECONDS)])
    return solo


def _rank_main(rank, world, params):
    """One rank: the agreement checks, the basic flow and the churn at
    pipeline_steps 1 and 2. Returns {case: value}."""
    torch.set_num_threads(1)
    tp = global_mesh(n_model=1, device_type="cpu")
    cfg = tiny_config()
    out = {"rows": host_row_range(tp, mw.BATCH),
           "or": any_across_hosts([rank == 0, rank == 1, False, True]).tolist(),
           "refused": []}
    for kw in (dict(n_model=3), dict(n_data=1), dict(n_data=2, n_model=2)):
        try:
            global_mesh(**kw, device_type="cpu")
        except ValueError:
            out["refused"].append(kw)
    mgr = FleetManager(params, cfg, **KW, device="cpu", tp=tp)
    out["basic"] = (basic_flow(mgr), mgr.steps, (mgr.row_lo, mgr.row_hi, mgr.local_batch))
    for depth in (1, 2):
        mgr = FleetManager(params, cfg, **KW, pipeline_steps=depth, device="cpu", tp=tp)
        streams = mw.churn_flow(mgr, np, any_across_hosts)
        out[f"churn {depth}"] = ({int(k): v for k, v in streams.items()}, mgr.steps)
    return out


def _jax_fleet(params, audio_of, batch):
    """JAX single-process manager through basic_flow: {row: all_ids} of
    `batch` streams of `audio_of(row)`, and its step count."""
    from voxtral_tpu.config import tiny_config as jax_tiny_config
    from voxtral_tpu.runtime.manager import FleetManager as JaxFleetManager
    with JaxFleetManager(params, jax_tiny_config(), **{**KW, "batch": batch}) as ref:
        return basic_flow(ref, audio_of), ref.steps


@pytest.fixture(scope="module")
def runs():
    """The two ranks' results, and the JAX references computed meanwhile:
    "basic" the 4-stream fleet, "solo" each churn stream alone."""
    import jax
    import jax.numpy as jnp
    from test_torch_manager import _lively
    from voxtral_tpu.config import tiny_config as jax_tiny_config
    from voxtral_tpu.weights import random_params as jax_random_params
    tree = _lively(jax_random_params(jax_tiny_config(), 0, numpy_out=True))
    jparams = jax.tree.map(jnp.asarray, tree)
    churn = solo_audio()
    with concurrent.futures.ThreadPoolExecutor(2 + len(churn)) as ex:
        ranks = ex.submit(run_ranks, _rank_main, 2, (from_numpy_params(tree, "cpu"),),
                          TIMEOUT)
        basic = ex.submit(_jax_fleet, jparams, mw.stream_audio, mw.BATCH)
        solo = {g: ex.submit(_jax_fleet, jparams, lambda _, a=a: a, 1)
                for g, a in churn.items()}
        return dict(ranks=ranks.result(), basic=basic.result(),
                    solo={g: f.result()[0][0] for g, f in solo.items()})


def test_host_row_range_partitions_the_batch():
    """Data ranks take disjoint contiguous ranges that cover the batch;
    model ranks of one data index share theirs; one rank takes it all."""
    ranges = {(d, m): host_row_range(TensorParallel(model_rank=m, model_size=2, data_rank=d,
                                                    data_size=4), 8)
              for d in range(4) for m in range(2)}
    assert [ranges[d, 0] for d in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(ranges[d, 1] == ranges[d, 0] for d in range(4))
    assert host_row_range(TensorParallel(), 5) == (0, 5)


def test_host_row_range_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="not a multiple of the data axis"):
        host_row_range(TensorParallel(data_rank=1, data_size=4), 6)


def test_any_across_hosts_or_over_two_ranks(runs):
    for out in runs["ranks"]:
        assert out["or"] == [True, True, False, True]


def test_global_mesh_refuses_a_mesh_that_is_not_the_world(runs):
    """On a world of 2: n_model 3 does not divide it, and (1, 1) and (2, 2)
    meshes do not hold every rank."""
    for out in runs["ranks"]:
        assert out["refused"] == [dict(n_model=3), dict(n_data=1), dict(n_data=2, n_model=2)]


def test_init_distributed_picks_gloo_without_cuda():
    """One rank joins through init_distributed with a bare host:port (gloo:
    no CUDA here), and its world mesh is the whole batch."""
    import torch.distributed as dist

    from voxtral_tpu_torch.parallel import init_distributed
    from voxtral_tpu_torch.parallel.launch import free_port
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        tp = global_mesh(device_type="cpu")
        assert (tp.data_size, tp.model_size) == (1, 1)
        assert host_row_range(tp, 3) == (0, 3)
        np.testing.assert_array_equal(any_across_hosts([False, True]), [False, True])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("hosts, ranks_per_host, cards, backend", [
    (1, 2, 2, "nccl"), (1, 2, 1, "gloo"), (1, 2, 0, "gloo"), (2, 2, 2, "nccl"),
    (2, 2, 1, "gloo")])
def test_init_distributed_backend_follows_the_cards_of_this_host(
        monkeypatch, hosts, ranks_per_host, cards, backend):
    """NCCL when this host has a card for each of its ranks (LOCAL_WORLD_SIZE
    across hosts, the world on one host), else gloo; under NCCL the world's
    gloo group that any_across_hosts runs on is made beside it. The group
    calls are recorded, not made."""
    import voxtral_tpu_torch.parallel.distributed as d
    calls = []
    monkeypatch.setattr(d.torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(d.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(d.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(d.dist, "new_group",
                        lambda backend: calls.append(("new_group", backend)) or "control")
    monkeypatch.setattr(d, "_CONTROL", None)
    if hosts > 1:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(ranks_per_host))
    else:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    world = hosts * ranks_per_host
    d.init_distributed("10.0.0.1:29500", world, world - 1)
    assert calls[0] == (backend, dict(init_method="tcp://10.0.0.1:29500", world_size=world,
                                      rank=world - 1))
    assert calls[1:] == ([("new_group", "gloo")] if backend == "nccl" else [])
    assert d._CONTROL == ("control" if backend == "nccl" else None)


def test_any_across_hosts_is_the_identity_on_one_process():
    flags = np.array([True, False, True])
    got = any_across_hosts(flags)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, flags)


def test_two_rank_dp_matches_jax_single_process(runs):
    """The worker's basic flow over two ranks: the rows are partitioned
    disjointly and completely, and every stream's tokens and the step
    count equal the JAX single-process manager's over the 4 streams."""
    want, want_steps = runs["basic"]
    ranks = runs["ranks"]
    assert [out["rows"] for out in ranks] == [(0, 2), (2, 4)]
    assert [out["basic"][2] for out in ranks] == [(0, 2, 2), (2, 4, 2)]
    got = {}
    for out in ranks:
        streams, steps, _ = out["basic"]
        assert steps == want_steps
        got.update(streams)
    assert sorted(got) == list(range(mw.BATCH))
    for g in range(mw.BATCH):
        assert got[g] == want[g], f"stream {g}"


@pytest.mark.parametrize("pipeline", [1, 2])
def test_two_rank_asymmetric_churn_matches_solo(runs, pipeline):
    """Rank 0 finishes, detaches and re-attaches global row 0 while rank
    1's rows keep feeding live audio: every stream (the first, the reborn
    one and the siblings that lived through the churn) equals its solo JAX
    run, and both ranks took the same steps."""
    got, steps = {}, set()
    for out in runs["ranks"]:
        streams, n = out[f"churn {pipeline}"]
        got.update(streams)
        steps.add(n)
    assert len(steps) == 1
    want = runs["solo"]
    assert sorted(got) == sorted(want)
    for g in sorted(want):
        assert got[g] == want[g], f"stream {g}: tokens diverge across the churn"


def test_restart_keeps_empty_staged_multiproc(tiny_cfg, tiny_params, monkeypatch):
    """tests/test_manager.py:715 on the port: a watchdog restart that
    empties this rank's staged block must not drop it when several ranks
    serve (the step is agreed over ranks). One process pretends to be one
    of two, with an agreement that is the identity; it keeps serving and
    recovers, with the JAX manager's tokens under the same pretence."""
    import voxtral_tpu.runtime.manager as jax_manager
    from voxtral_tpu.weights import random_params as jax_random_params

    import voxtral_tpu_torch.runtime.manager as port_manager
    for mod in (jax_manager, port_manager):
        monkeypatch.setattr(mod, "MAX_DECODE_KV", 45)
    port_params = from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), "cpu")
    a = np.random.RandomState(45).randn(4 * 16000).astype(np.float32) * 0.3
    results = []
    for mgr in (jax_manager.FleetManager(tiny_params, tiny_cfg, batch=1, chunk_tokens=8,
                                         dec_ring=256, continuous=True),
                FleetManager(port_params, tiny_config(), batch=1, chunk_tokens=8,
                             dec_ring=256, continuous=True, device="cpu")):
        sid = mgr.attach()
        mgr._n_procs = 2
        mgr._any_hosts = lambda flags: np.asarray(flags, bool)
        chunk = mgr.chunk_samp
        for i in range(0, len(a), 2 * chunk):
            mgr.feed(sid, a[i:i + 2 * chunk])
            mgr.poll()
        s = mgr.slots[sid]
        assert s.restarts > 0 and s.generated > 0
        results.append((list(s.all_ids), s.restarts, mgr.steps))
    assert results[1] == results[0]


def test_data_ranks_keep_the_whole_tree_uncopied():
    """A (data 2 x model 1) rank slices nothing: shard_params returns the
    caller's tree itself, and the manager serves from it (no second copy
    of the weights on a data rank)."""
    params = random_params(tiny_config(), seed=0, device="cpu")
    tp = TensorParallel(data_rank=1, data_size=2)
    assert shard_params(params, tiny_config(), tp) is params
    mgr = FleetManager(params, tiny_config(), batch=2, device="cpu", tp=tp)
    assert mgr.params is params
    assert (mgr.row_lo, mgr.row_hi, mgr.local_batch, len(mgr.slots)) == (1, 2, 1, 1)


def test_tp_manager_refuses_an_indivisible_batch():
    """FleetManager(tp=) raises before any collective when the data axis
    does not divide the global batch."""
    params = random_params(tiny_config(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the data axis"):
        FleetManager(params, tiny_config(), batch=3, device="cpu",
                     tp=TensorParallel(data_rank=0, data_size=2))
