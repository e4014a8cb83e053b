"""The fleet step captured once per static shape as a CUDA graph and replayed:
the port's counterpart of the JAX package's compiled, state-donating step.

The JAX package jits `fleet_step_pcm` and `fleet_step_masked` with the state
donated (`voxtral_tpu/runtime/fleet.py:266-267, 336-338`), its manager
dispatches each step as that one program (`voxtral_tpu/runtime/manager.py:410`),
and a new chunk size compiles a new program (`set_chunk_tokens`). Eager, the
port's step is thousands of launches issued from Python, and the host, not
the card, sets its wall. `FleetStepGraphs` owns one captured step per key,
the step's static arguments (`step_key`), over ONE state that it keeps:

1. The first call at a key runs the eager step, whose result is used. It
   builds what the step caches at first use (the mel tables and frame index,
   the zeroed scratch and SM counts, the kernels' plans and occupancy
   queries, cuBLAS's workspace), so that capture finds them. No throw-away
   warm-up: the step writes the rings in place, so one would advance every
   stream.
2. The second call copies the inputs into static buffers and captures the
   step on the owner's stream, into a memory pool its graphs share. The end
   of the captured region copies every state field the step returns into
   the state tensors it read (the rings are already written in place), so
   each replay advances the same state. Capture runs no kernel: the graph is
   replayed once at once.
3. Later calls copy the inputs into the static buffers and replay on the
   current stream. The outputs returned live in the pool and the next replay
   overwrites them: read them (or queue their copy) before the next step.

The first call and the capture run on the owner's side stream (capture
needs one), so cuBLAS sees one stream for both; replays run on the caller's
stream. Never replay on two streams: the kernels' zeroed scratch is shared.

Launch counts: the kernel wrappers count on the host, so capture counts
launches that did not run. `counted` takes that change back out and keeps
it, and every replay adds it again: a replay counts the launches it makes.

A step under `tp` runs gloo collectives through the host and cannot be
captured, nor can a step on the CPU: both raise (`check_capturable`). A
capture or replay that fails raises too; nothing falls back to the eager
step.
"""

from __future__ import annotations

import dataclasses

import torch

from voxtral_tpu_torch.ops import logits_argmax, norms, q8_matmul, ring_attention
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.runtime.fleet import (
    FleetState, copy_state, fleet_step_masked, fleet_step_pcm,
)

# the launch counters of the kernels a fleet step runs (and the Q8 large-M
# route's calls)
COUNTERS = (ring_attention.LAUNCHES, q8_matmul.LAUNCHES, q8_matmul.LARGE_M_CALLS,
            logits_argmax.LAUNCHES, norms.LAUNCHES)


def check_capturable(state: FleetState, tp=None) -> None:
    """Raise unless a step on `state` can be captured: CUDA, no `tp`."""
    if tp is not None:
        raise ValueError("a step under tp runs gloo collectives through the host and "
                         "cannot be captured: run it eagerly")
    dev = state.pcm_tail.device
    if dev.type != "cuda":
        raise ValueError(f"a step on {dev} cannot be captured: CUDA graphs need CUDA tensors")


def step_key(entry: str, params, state: FleetState, pcm: torch.Tensor, *,
             stop_at_eos: bool, collect_topk: int, wire_packed: bool = False) -> tuple:
    """Every static argument of a step: the entry, B and the samples a row
    carries (so the chunk), the wire dtype, `wire_packed`, `collect_topk`,
    `stop_at_eos`, the rings' dtypes and widths (int4 packs two codes a byte)
    and whether the weights are Q8."""
    enc, dec = state.encoder.k_ring[0], state.decode.k_ring[0]
    q8 = isinstance(params["decoder"]["layers"][0]["wq"], Quantized)
    return (entry, pcm.shape[0], pcm.shape[1], pcm.dtype, bool(wire_packed),
            int(collect_topk), bool(stop_at_eos), (enc.dtype, enc.shape[-1]),
            (dec.dtype, dec.shape[-1]), q8)


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


@dataclasses.dataclass
class Captured:
    """One captured step: its graph, static inputs and outputs, and the
    launches one replay makes."""
    graph: object            # torch.cuda.CUDAGraph
    inputs: tuple            # static input buffers (None for an input that is)
    outputs: tuple           # (tokens, aux), in the pool
    launches: dict           # `counted`'s change

    def replay(self, inputs) -> tuple:
        for s, x in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        return self.outputs


class FleetStepGraphs:
    """Captured fleet steps over one state, one per `step_key`.

    `state` is the FleetState every step reads and writes: pass the state
    the steps start from, and afterwards read it as `self.state` (each step
    also returns it). A state made elsewhere (e.g. by `age_fleet_state`)
    enters through `load_state`. Steps take what `fleet_step_masked` and
    `fleet_step_pcm` take after the state."""

    def __init__(self, params, cfg, state: FleetState, *, tp=None):
        check_capturable(state, tp)
        self.params, self.cfg, self.state = params, cfg, state
        self._graphs = {}               # key -> Captured, None after the eager call
        self._stream = None             # the side stream, at first use
        self._pool = None

    def step_masked(self, pcm, active, forced_tokens, t_ada, *, stop_at_eos: bool = False,
                    collect_topk: int = 0, wire_packed: bool = False):
        """`fleet_step_masked` on the owned state; returns (state, tokens,
        aux). With `wire_packed`, `active` and `forced_tokens` are ignored."""
        kw = dict(stop_at_eos=stop_at_eos, collect_topk=collect_topk,
                  wire_packed=wire_packed)
        key = step_key("fleet_step_masked", self.params, self.state, pcm, **kw)
        return self._call(key, lambda p, a, f, t: fleet_step_masked(
            self.params, self.cfg, self.state, p, a, f, t, **kw),
            (pcm, active, forced_tokens, t_ada))

    def step_pcm(self, pcm, t_ada, *, stop_at_eos: bool = False, collect_topk: int = 0):
        """`fleet_step_pcm` on the owned state; returns (state, tokens, aux)."""
        kw = dict(stop_at_eos=stop_at_eos, collect_topk=collect_topk)
        key = step_key("fleet_step_pcm", self.params, self.state, pcm, **kw)
        return self._call(key, lambda p, t: fleet_step_pcm(
            self.params, self.cfg, self.state, p, t, **kw), (pcm, t_ada))

    def load_state(self, state: FleetState) -> FleetState:
        """Copy `state`'s values into the owned state's tensors."""
        copy_state(self.state, state)
        return self.state

    def close(self) -> None:
        """Free the graphs, their outputs and their pool."""
        self._graphs.clear()
        self._pool = None

    def _call(self, key, run, inputs):
        if key not in self._graphs:
            out = self._on_side_stream(lambda: self._in_place(run(*inputs)))
            self._graphs[key] = None
            return (self.state, *out)
        entry = self._graphs[key]
        if entry is None:
            entry = self._graphs[key] = self._capture(run, inputs)
        return (self.state, *entry.replay(inputs))

    def _in_place(self, result):
        """A step's (state, tokens, aux) -> (tokens, aux), its state copied
        into the owned state's tensors."""
        state, tokens, aux = result
        copy_state(self.state, state)
        return tokens, aux

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.state.pcm_tail.device)
        return self._stream

    def _on_side_stream(self, fn):
        """fn() on the side stream, ordered after and before the current
        stream's work."""
        cur, side = torch.cuda.current_stream(self.state.pcm_tail.device), self._side_stream()
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
