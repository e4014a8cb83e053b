"""Programs captured once per static shape as CUDA graphs and replayed: the
port's counterpart of the JAX package's compiled, state-donating programs.

The JAX package jits its programs with the state donated and compiles one
program per static shape: the fleet step (`fleet_step_pcm`,
`fleet_step_masked`, `voxtral_tpu/runtime/fleet.py:266-267, 336-338`), the
offline pipeline (`voxtral_tpu/models/pipeline.py:40-72`) and the bucketed
stream's programs (`voxtral_tpu/runtime/stream.py:66-103`). Eager, the
port's programs are thousands of launches issued from Python, and the host,
not the card, sets their wall. `StateGraphs` owns one captured program per
key, the program's static arguments, over ONE state that it keeps:

1. The first call at a key runs the program eagerly, and its result is
   used. It builds what the program caches at first use (the mel tables
   and frame index, the zeroed scratch and SM counts, the kernels' plans
   and occupancy queries, cuBLAS's workspace), so that capture finds them.
   No throw-away warm-up: the program writes the state's rings in place,
   so one would advance the state.
2. The same call then copies the inputs into static buffers and captures
   the program on the owner's stream, into a memory pool its graphs share,
   as jit compiles at a shape's first call. The end of the captured region
   copies every state field the program returns into the state tensors it
   read (the rings are already written in place), so each replay advances
   the same state. Capture runs no kernel, so the state stays as the eager
   run left it. `capture_s` keeps each key's capture seconds.
3. Later calls, of any lessee, copy the inputs into the static buffers
   and replay on the current stream. The outputs returned live in the
   pool, and the next replay of ANY of the owner's graphs may overwrite
   them: read them (or queue their copy) before the owner's next call.

The first call and the capture run on the owner's side stream (capture
needs one), so cuBLAS sees one stream for both; replays run on the caller's
stream. Never replay on two streams: the kernels' zeroed scratch is shared.
With `capture=False` every call runs the program eagerly on the caller's
stream with the same state handling: the plain version of the replay.

Launch counts: the kernel wrappers count on the host, so capture counts
launches that did not run. `counted` takes that change back out and keeps
it, and every replay adds it again: a replay counts the launches it makes.

A program under `tp` runs gloo collectives through the host and cannot be
captured, nor can a program on the CPU: both raise (`check_capturable`). A
capture or replay that fails raises too; nothing falls back to eager.

`FleetStepGraphs` is the fleet step's owner over a FleetState.

The process's program cache (`lease`, `release`), the counterpart of jit's:
an owner's graphs read the addresses of the weights their first calls
were given, so owners are cached by `weights_key` (every tensor of the
weights: its place in the tree, address, shape, strides and dtype), then
by the owner's class, the config and the owned state's signature (each
leaf's shape and dtype). A tree whose tensors sit at the same addresses
shares the owners, and values written in place are read; a tree with any
other tensor gets owners of its own. A stream, a manager or a request
leases a free owner (its state reset in place) or captures a new one, and
gives it back when done: owners live on while idle, and go with the first
tensor of their weights that goes. No owner refers to the weights.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref

import torch

from voxtral_tpu_torch.models.decoder import decode_scan
from voxtral_tpu_torch.models.pipeline import prefill_prompt
from voxtral_tpu_torch.ops import logits_argmax, norms, q8_matmul, ring_attention
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.runtime.fleet import (
    FleetState, copy_state, fleet_step_masked, fleet_step_pcm, state_leaves,
)

# the launch counters of the kernels the programs run (and the Q8 large-M
# route's calls)
COUNTERS = (ring_attention.LAUNCHES, q8_matmul.LAUNCHES, q8_matmul.LARGE_M_CALLS,
            logits_argmax.LAUNCHES, norms.LAUNCHES)


def _device(state) -> torch.device:
    return next(t for t in state_leaves(state) if t is not None).device


def check_capturable(state, tp=None) -> None:
    """Raise unless a program on `state` can be captured: CUDA, no `tp`."""
    if tp is not None:
        raise ValueError("a program under tp runs gloo collectives through the host and "
                         "cannot be captured: run it eagerly")
    dev = _device(state)
    if dev.type != "cuda":
        raise ValueError(f"a program on {dev} cannot be captured: CUDA graphs need CUDA "
                         "tensors")


def wants_capture(step_graphs, device: torch.device, tp=None) -> bool:
    """Whether an entry point captures its programs: `step_graphs` None does
    on CUDA without `tp`, False never does, True does and raises where
    capture cannot run."""
    if step_graphs and (device.type != "cuda" or tp is not None):
        raise ValueError(f"step_graphs=True needs CUDA and no tp (device {device}, "
                         f"tp {tp is not None})")
    return step_graphs is not False and device.type == "cuda" and tp is None


def is_q8(dec_params) -> bool:
    """Whether the decoder's weights are Q8 (a static argument of a key)."""
    return isinstance(dec_params["layers"][0]["wq"], Quantized)


def step_key(entry: str, params, state: FleetState, pcm: torch.Tensor, *,
             stop_at_eos: bool, collect_topk: int, wire_packed: bool = False) -> tuple:
    """Every static argument of a step: the entry, B and the samples a row
    carries (so the chunk), the wire dtype, `wire_packed`, `collect_topk`,
    `stop_at_eos`, the rings' dtypes and widths (int4 packs two codes a byte)
    and whether the weights are Q8."""
    enc, dec = state.encoder.k_ring[0], state.decode.k_ring[0]
    return (entry, pcm.shape[0], pcm.shape[1], pcm.dtype, bool(wire_packed),
            int(collect_topk), bool(stop_at_eos), (enc.dtype, enc.shape[-1]),
            (dec.dtype, dec.shape[-1]), is_q8(params["decoder"]))


def program_key(entry: str, dec_params, inputs, **static) -> tuple:
    """Every static argument of a program over an owner's state (whose
    shapes are fixed): the entry, each input's shape and dtype (None for an
    absent input), the keyword arguments and whether the weights are Q8."""
    return (entry, tuple(None if x is None else (tuple(x.shape), x.dtype) for x in inputs),
            tuple(sorted(static.items())), is_q8(dec_params))


def scan_key(dec_params, state, inputs, *, collect_topk: int, stop_at_eos: bool) -> tuple:
    """Every static argument of a `decode_scan` call on a DecodeState: the
    inputs' shapes (frames [B, n, D]: B and the steps; whether tokens are
    forced), `collect_topk`, `stop_at_eos`, the pending block's size, the
    rings' dtype and width and whether the weights are Q8."""
    ring = state.k_ring[0]
    return program_key("decode_scan", dec_params, inputs, collect_topk=int(collect_topk),
                       stop_at_eos=bool(stop_at_eos), pending=state.pending_sp.shape[1],
                       ring=(ring.dtype, ring.shape[-1]))


def counted(fn):
    """Run `fn` and take the launches it counted back out of the counters.
    Returns (fn's result, {(counter index, name): change})."""
    before = [dict(c) for c in COUNTERS]
    out = fn()
    change = {}
    for i, (c, b) in enumerate(zip(COUNTERS, before)):
        for name, v in c.items():
            if v != b.get(name, 0):
                change[(i, name)] = v - b.get(name, 0)
            c[name] = b.get(name, 0)
    return out, change


def add_launches(change: dict) -> None:
    for (i, name), d in change.items():
        COUNTERS[i][name] += d


def _weight_tensors(node, path=()):
    """(path, tensor) of every tensor of a weight tree in tree order, a
    Quantized leaf's codes and scales as two."""
    if isinstance(node, torch.Tensor):
        return [(path, node)]
    if isinstance(node, Quantized):
        return [(path + ("q",), node.q), (path + ("s",), node.s)]
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return []
    return [pt for k, child in items for pt in _weight_tensors(child, path + (k,))]


def _key(tensors) -> tuple:
    return tuple((path, t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for path, t in tensors)


def weights_key(params) -> tuple:
    """What captured programs read of `params`: each tensor's place in the
    tree, device, address, shape, strides and dtype."""
    return _key(_weight_tensors(params))


def state_signature(state) -> tuple:
    """The owned state's static shape: its type and each leaf's shape and
    dtype (None for an absent field)."""
    return (type(state).__name__, tuple(None if t is None else (tuple(t.shape), t.dtype)
                                        for t in state_leaves(state)))


# weights_key -> {(owner class, cfg, state signature): [owners]}; an entry
# goes when any tensor of its weights does
_OWNERS: dict = {}
_LOCK = threading.RLock()          # a finalizer may run inside a lease


def _drop(wkey) -> None:
    with _LOCK:
        _OWNERS.pop(wkey, None)


def _slot(cls, params, cfg, make_state, *, create: bool):
    """The list of cached owners for this key (None if absent and not
    `create`), and the device of the weights."""
    tensors = _weight_tensors(params)
    dev = tensors[0][1].device
    sig = state_signature(make_state(torch.device("meta")))
    wkey = _key(tensors)
    owners = _OWNERS.get(wkey)
    if owners is None:
        if not create:
            return None, dev
        owners = _OWNERS[wkey] = {}
        for _, t in tensors:
            weakref.finalize(t, _drop, wkey)
    if not create:
        return owners.get((cls, cfg, sig)), dev
    return owners.setdefault((cls, cfg, sig), []), dev


def lease(cls, params, cfg, make_state, reset):
    """A free owner of class `cls` (StateGraphs or a subclass) for programs
    that read `params` under `cfg`, leased until `release`: a cached one
    whose state `make_state` would shape alike, its state reset in place by
    `reset(state)`, else a new one over `make_state(device)`, added to the
    cache. Two live leases never share an owner."""
    with _LOCK:
        owners, dev = _slot(cls, params, cfg, make_state, create=True)
        owner = next((o for o in owners if not o.leased), None)
        if owner is None:
            # normal tensors, which lessees in and out of inference mode
            # (requests, streams) may all write in place; so are the
            # static buffers of the owner's graphs
            with torch.inference_mode(False), torch.no_grad():
                owner = cls(make_state(dev))
            owners.append(owner)
        else:
            reset(owner.state)
        owner.leased = True
        return owner


def release(*owners) -> None:
    """Give leased owners back to the cache."""
    with _LOCK:
        for owner in owners:
            owner.leased = False


def cached(cls, params, cfg, make_state) -> list:
    """The cached owners (leased or free) that `lease` would pick from."""
    with _LOCK:
        owners, _ = _slot(cls, params, cfg, make_state, create=False)
        return list(owners or ())


@dataclasses.dataclass
class Captured:
    """One captured program: its graph, static inputs and outputs, and the
    launches one replay makes."""
    graph: object            # torch.cuda.CUDAGraph
    inputs: tuple            # static input buffers (None for an input that is)
    outputs: tuple           # the program's outputs, in the pool
    launches: dict           # `counted`'s change

    def replay(self, inputs) -> tuple:
        for s, x in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs


class StateGraphs:
    """Captured programs over one owned state, one per key (see the module
    docstring).

    `state` is the state (a NamedTuple of tensors, nested states and tuples
    of layers; `fleet.state_leaves`) every program reads and writes: read it
    as `self.state`, whose tensors never change. A program is a callable
    `run(*inputs) -> (new state, *outputs)` whose new state has the owned
    state's structure; `call` copies the new state into the owned tensors
    and returns the outputs. A state made elsewhere enters through
    `load_state`."""

    def __init__(self, state, *, capture: bool = True, tp=None):
        if capture:
            check_capturable(state, tp)
        self.state = state
        self.capture = capture
        self.leased = False             # held by a lessee (see `lease`)
        self.capture_s = {}             # key -> seconds its capture took
        self._graphs = {}               # key -> Captured
        self._stream = None             # the side stream, at first use
        self._pool = None

    def call(self, key, run, inputs) -> tuple:
        """run(*inputs)'s outputs; its state lands in the owned state."""
        if not self.capture:
            return self._in_place(run(*inputs))
        entry = self._graphs.get(key)
        if entry is not None:
            return entry.replay(inputs)
        out = self._on_side_stream(lambda: self._in_place(run(*inputs)))
        t0 = time.perf_counter()
        with torch.inference_mode(False), torch.no_grad():     # see `lease`
            self._graphs[key] = self._capture(run, inputs)
        self.capture_s[key] = time.perf_counter() - t0
        return out

    def load_state(self, state):
        """Copy `state`'s values into the owned state's tensors."""
        copy_state(self.state, state)
        return self.state

    def close(self) -> None:
        """Free the graphs, their outputs and their pool."""
        self._graphs.clear()
        self._pool = None

    def _in_place(self, result) -> tuple:
        """A program's (state, *outputs) -> outputs, its state copied into
        the owned state's tensors."""
        state, *outputs = result
        copy_state(self.state, state)
        return tuple(outputs)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(_device(self.state))
        return self._stream

    def _on_side_stream(self, fn):
        """fn() on the side stream, ordered after and before the current
        stream's work."""
        cur, side = torch.cuda.current_stream(_device(self.state)), self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def _capture(self, run, inputs) -> Captured:
        static = tuple(None if x is None else x.clone() for x in inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream()):
            outputs, launches = counted(lambda: self._in_place(run(*static)))
        return Captured(graph, static, outputs, launches)


class FleetStepGraphs(StateGraphs):
    """Captured fleet steps over one FleetState, one per `step_key`.

    `state` is the FleetState every step reads and writes: pass the state
    the steps start from, and afterwards read it as `self.state` (each step
    also returns it). A state made elsewhere (e.g. by `age_fleet_state`)
    enters through `load_state`. Steps take what `fleet_step_masked` and
    `fleet_step_pcm` take, the state left out. The weights come with each
    call and the owner keeps no reference to them, but its graphs read the
    tensors of the first calls': one owner serves one set of weights."""

    def step_masked(self, params, cfg, pcm, active, forced_tokens, t_ada, *,
                    stop_at_eos: bool = False, collect_topk: int = 0,
                    wire_packed: bool = False):
        """`fleet_step_masked` on the owned state; returns (state, tokens,
        aux). With `wire_packed`, `active` and `forced_tokens` are ignored."""
        kw = dict(stop_at_eos=stop_at_eos, collect_topk=collect_topk,
                  wire_packed=wire_packed)
        key = step_key("fleet_step_masked", params, self.state, pcm, **kw)
        return self._step(key, lambda p, a, f, t: fleet_step_masked(
            params, cfg, self.state, p, a, f, t, **kw), (pcm, active, forced_tokens, t_ada))

    def step_pcm(self, params, cfg, pcm, t_ada, *, stop_at_eos: bool = False,
                 collect_topk: int = 0):
        """`fleet_step_pcm` on the owned state; returns (state, tokens, aux)."""
        kw = dict(stop_at_eos=stop_at_eos, collect_topk=collect_topk)
        key = step_key("fleet_step_pcm", params, self.state, pcm, **kw)
        return self._step(key, lambda p, t: fleet_step_pcm(
            params, cfg, self.state, p, t, **kw), (pcm, t_ada))

    def _step(self, key, run, inputs):
        return (self.state, *self.call(key, run, inputs))


class DecodeGraphs(StateGraphs):
    """The prompt's prefill and `decode_scan` over one DecodeState, one
    program per key (`program_key`, `scan_key`): the decoder programs of the
    offline pipeline and of the bucketed VoxStream (the JAX stream's
    `_prefill` and `_decode`); the offline request's encoder runs through
    `call` on the same owner. The weights come with each call and the owner
    keeps no reference to them, but its graphs read the tensors of the
    first calls': one owner serves one set of weights (`lease`). A scan runs
    at most the state's pending block of steps. `state` is a DecodeState."""

    def prefill(self, dec_params, cfg, frames, prompt_ids, prev_token, t_ada) -> None:
        """`pipeline.prefill_prompt` on the owned state, which must be fresh
        or reset."""
        inputs = (frames, prompt_ids, prev_token, t_ada)
        self.call(program_key("prefill", dec_params, inputs), lambda f, p, t, a: (
            prefill_prompt(dec_params, cfg, self.state, f, p, t, a),), inputs)

    def scan(self, dec_params, cfg, frames, n_valid, t_ada, *, collect_topk: int = 0,
             stop_at_eos: bool = True, forced_tokens=None):
        """`decode_scan` on the owned state; returns (tokens, aux), in the
        pool until the owner's next call."""
        inputs = (frames, n_valid, t_ada, forced_tokens)
        kw = dict(collect_topk=collect_topk, stop_at_eos=stop_at_eos)
        return self.call(scan_key(dec_params, self.state, inputs, **kw),
                         lambda f, n, t, ft: decode_scan(dec_params, cfg, self.state, f, n, t,
                                                         forced_tokens=ft, **kw), inputs)
