"""FleetManager: the multi-stream serving runtime (counterpart of
`voxtral_tpu/runtime/manager.py`).

Hosts B concurrent transcription streams in ONE device-resident FleetState,
advanced by the masked fleet step (runtime/fleet.py::fleet_step_masked):
device mel, batched conv/encoder/adapter, lockstep greedy decode.
Concurrent streams share every weight read.

Per-stream lifecycle on shared batched state:
- attach(): claims a slot, masked full reset (fleet_reset_slots), then the
  39-token prompt enters via FORCED-TOKEN REPLAY: decode positions i <
  prompt_len-1 take frame[i] + embed(pad) with the greedy choice overridden,
  which computes what decoder_prefill computes, but per slot inside a live
  fleet.
- feed()/finish(): host-side sample buffering; a stream joins a step only
  with a FULL chunk (full-or-nothing masking keeps each stream's
  tails/cursors exact; see fleet_step_masked).
- watchdogs: the reference's stream self-healing (voxtral.c:410-420,
  1189-1239) per slot: restart on EOS, on decode KV > 2000, on >= 64
  consecutive non-text tokens, on 20 s without text; decoder-only restart
  escalating to a full reset after repeated textless restarts.
- per-slot device resets are DEFERRED to the next step boundary (no step
  runs in between, so this is the same as an immediate reset).

Caveat (models/decoder.py): the lockstep ring cursor advances with the
busiest stream, so a slot that idles while siblings run has its oldest ring
entries recycled early; bounded in practice by the 2000-token restart cap
(retained_kv() measures it).

The device side. The fleet step makes no host sync, so its launches queue
ahead of the card; the manager keeps it that way:
- uploads (the packed wire rows, the reset masks) go from pinned memory
  with `non_blocking=True` on the compute stream; PyTorch's pinned
  allocator keeps the host block alive until its copy has run, and the
  numpy rows the manager edits later are never the copy's source;
- each step's output (tokens, or the packed alt-token aux) is copied to a
  pinned host buffer without blocking at DISPATCH, with an event recorded
  behind it; the retire waits on that event only, so with
  pipeline_steps=2 step k's tokens are read while step k+1 still runs;
- every kernel launch and copy stays on the one compute stream (the
  kernels that merge through a zeroed counter buffer per card need it), so
  a reset queued while a step runs is ordered after it;
- on CUDA without `tp` the step is replayed as one CUDA graph per shape
  (runtime/step_graph.py, the counterpart of the JAX manager's one
  compiled program a step): its first call at a shape runs eagerly, the
  second captures it, later ones replay it, and a new chunk size is a new
  shape. `self.state` is then the graph's own state, which every replay
  reads and writes: the per-slot resets write into its tensors
  (fleet_reset_slots_), and whatever reads it (retained_kv, stats) reads
  it. `step_graphs=False` runs the eager step instead, the graph's plain
  version; the CPU and `tp=` (gloo collectives through the host) always
  run it;
- the eager step writes the rings in place and returns the other fields
  new: `self.state` is its return, and resets write into it in place.
On the CPU the same code runs its copies as plain copies.

Two differences from the JAX manager, both faults of the reference:
- the monitor's slow classification reads the overlap-clipped step time
  that step_ms_total adds up (the reference reads the raw dispatch-to-retire
  window, which spans the previous step's retire when pipelined);
- poll() raises when a previous poll left steps in flight (it aborted
  mid-pipeline) instead of overwriting the pipeline.

Multi-process data parallelism (the JAX manager's `mesh=`): pass `tp`,
this rank's TensorParallel on a mesh over every rank
(parallel/distributed.global_mesh). Every rank runs this manager with the
same arguments and the WHOLE param tree, which it slices to its heads,
FFN columns and vocabulary (shard_params). `batch` stays the GLOBAL stream
count; a rank serves its data index's rows [row_lo, row_hi)
(host_row_range): its slot ids are local rows, it feeds and reads only
those, and its state holds only those. The model ranks of one data index
hold the same rows, and the caller feeds them the same calls: their tokens
agree (the greedy head merges the winning logit over the model group, the
alt path all-gathers the logits), so their host control does too. The
decision that gates a step (is any stream ready on any rank?) is agreed
through any_across_hosts, so every rank runs the same sequence of steps
and of the collectives inside them; a rank with no ready stream steps an
all-inactive block. All ranks must call poll() in lockstep, and every loop
exit the caller takes must be agreed the same way. Unlike the JAX manager,
per-slot resets are applied without agreement: fleet_reset_slots runs no
collective, so a reset on one rank leaves the others' call sequence
alone (tokens are unaffected).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.decoder import (
    ada_scales, retained_window, time_conditioning,
)
from voxtral_tpu_torch.parallel.distributed import any_across_hosts, host_row_range
from voxtral_tpu_torch.parallel.sharding import shard_params
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.runtime.alts import select_alts
from voxtral_tpu_torch.runtime.fleet import (
    fleet_reset_slots_, fleet_step_masked, init_fleet_state, pack_wire,
    pcm_stream_skew,
)
from voxtral_tpu_torch.runtime.step_graph import FleetStepGraphs
from voxtral_tpu_torch.utils import device_memory_gb, resolve_device

MAX_DECODE_KV = 2000              # voxtral.c:412
MAX_NON_TEXT_STREAK = 64
MAX_NO_TEXT_SECONDS = 20.0
EMPTY_RESTARTS_FOR_FULL_RESET = 2


@dataclasses.dataclass
class _Staged:
    """A cut-and-uploaded chunk batch awaiting dispatch (see poll()).

    Staging happens while the PREVIOUS step still runs on the device, so
    the wire upload overlaps device compute. `raw` keeps the host copy of
    each slot's samples so a watchdog restart discovered when the previous
    step's tokens land can push the chunk back into the slot's buffer (the
    staged row is then masked off and re-cut after the restart, exactly
    like the unpipelined order of events)."""
    pcm_dev: object                        # device packed wire rows
    active: "np.ndarray"                   # [B] bool (host; mutable)
    forced: "np.ndarray"                   # [B, n] int32 (host copy)
    part: list                             # participating sids
    raw: dict                              # sid -> host samples row
    pcm_host: "np.ndarray" = None          # [B, chunk] wire-dtype rows
    dirty: bool = False                    # active/forced edited after the
    # wire upload (watchdog un-staging) -> re-pack + re-upload at dispatch
    out: object = None                     # (host buffer, event or None) of
    # the step's output once dispatched: the copy is queued at dispatch and
    # waited for at retire (pipeline_steps > 1 retires while the NEXT step
    # runs)
    t_dispatch: float = 0.0
    discard: set = dataclasses.field(default_factory=set)  # sids whose rows
    # were already on the device when a watchdog restart hit: their tokens
    # are dropped at retire and their samples pushed back (the queued reset
    # erases the step's state writes for those rows)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    buf: np.ndarray = None                 # pending samples
    replay_left: int = 0                   # forced prompt tokens remaining
    queue: list = None                     # [(token_id, piece)]
    finishing: bool = False
    finished: bool = False
    eos_seen: bool = False                 # non-continuous: slot is stopped
    # watchdog counters
    pos: int = 0                           # decode KV length since restart
    nontext_streak: int = 0
    samples_since_text: int = 0
    text_since_restart: bool = False
    empty_restarts: int = 0
    # finish(): number of real (non-chunk-fill) tokens this stream will have
    # emitted in total; output beyond it comes from the final chunk's fill
    # padding and is dropped (the batch pipeline's right-pad schedule)
    token_limit: int = None
    # incremental UTF-8 piece decoder (tokenizer.StreamDecoder); None
    # when the manager has no tokenizer
    sdec: object = None
    # stats
    generated: int = 0
    text_tokens: int = 0
    restarts: int = 0
    samples_done: int = 0                  # samples the device consumed
    # (incl. left-pad silence)
    # full greedy stream (text + control + eos, replay excluded); the
    # queue carries only TEXT tokens (reference semantics)
    all_ids: list = None


def _first_tensor(node):
    if isinstance(node, torch.Tensor):
        return node
    if isinstance(node, Quantized):
        return node.q
    children = node.values() if isinstance(node, dict) else node
    for child in children:
        t = _first_tensor(child)
        if t is not None:
            return t
    return None


class FleetManager:
    def __init__(self, params, cfg: VoxtralConfig, batch: int, *,
                 tokenizer=None, chunk_tokens: int = 20,
                 max_chunk_tokens: int | None = None,
                 delay_tokens: int | None = None, kv_dtype: str = "float",
                 enc_kv_dtype: str | None = None,
                 enc_ring: int | None = None, dec_ring: int = 2048,
                 continuous: bool = True, n_alt: int = 1,
                 alt_cutoff: float = 0.0,
                 wire_dtype: str = "f32", monitor=None,
                 monitor_slow_ms: float = 40.0,
                 max_steps_per_poll: int | None = None,
                 pipeline_steps: int = 1, device="cuda", tp=None,
                 step_graphs: bool | None = None):
        # monitor: optional per-slot pipeline-event hook `monitor(sid, sym)`
        # with the reference's --monitor symbol set (README.md:105-130):
        # ▪/▸ text decode fast/slow, ▫/▹ control-only, ✗/✘ invalid, ◦ EOS,
        # ⚠/☠ streak severity, ↺⟳↯⌚ restart triggers + ✂/♻ reset tier.
        # slow = step wall time per token > monitor_slow_ms.
        # wire_dtype="s16": ship PCM to the device as int16 (the native WAV/
        # mic sample format, half the upload) and convert on the device
        # (exact). Float feeds are round-tripped through int16 in this mode.
        # device: where the state lives and the steps run ("cuda" raises
        # without CUDA); `params` must already live there.
        # tp: this rank's TensorParallel for multi-process serving (see the
        # module docstring); `params` is the whole tree, sliced here, and
        # `batch` must divide by the data axis.
        # step_graphs: replay the step as CUDA graphs (None: on CUDA without
        # tp; False: the eager step; True: raises where capture cannot run).
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if step_graphs and (dev.type != "cuda" or tp is not None):
            raise ValueError(f"step_graphs=True needs CUDA and no tp (device {dev}, "
                             f"tp {tp is not None})")
        p_dev = _first_tensor(params).device
        if p_dev != dev:
            raise RuntimeError(
                f"params live on {p_dev}, the manager runs on {dev}: move them "
                "(weights.from_numpy_params / random_params take device=)")
        self.device = dev
        self.tp = tp
        self._n_procs = 1
        self.row_lo, self.row_hi = 0, batch
        if tp is not None:
            self.row_lo, self.row_hi = host_row_range(tp, batch)
            params = shard_params(params, cfg, tp)
            self._n_procs = tp.data_size * tp.model_size
        self.local_batch = self.row_hi - self.row_lo
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        # alt-tokens (vox_stream_set_alt, voxtral.c:1329-1353): up to n_alt-1
        # alternatives within probability cutoff of the best token
        self.n_alt = max(1, min(4, n_alt))
        self.alt_cutoff = alt_cutoff
        self.batch = batch
        self.n = chunk_tokens                       # decode tokens per step
        self.chunk_mel = chunk_tokens * 8
        self.chunk_samp = self.chunk_mel * cfg.audio.hop_length
        # max_chunk_tokens sizes the device pending blocks so
        # set_chunk_tokens can later raise the step size without touching
        # device state
        self.max_chunk_tokens = max(chunk_tokens, max_chunk_tokens or 0)
        self.continuous = continuous
        st = cfg.streaming
        self.delay = st.delay_tokens if delay_tokens is None else delay_tokens
        self.prompt_len = 1 + st.n_left_pad_tokens + self.delay
        self.t_ada = self._ada()
        enc_ring = enc_ring or (cfg.encoder.window
                                + self.max_chunk_tokens * 4 + 8)
        # enc_kv_dtype="int4": nibble-packed encoder rings; the serving
        # configuration is Q8 weights + int8 decoder + int4 encoder rings
        self.state = init_fleet_state(
            cfg, batch=batch, enc_ring=enc_ring, dec_ring=dec_ring,
            max_mel_chunk=self.max_chunk_tokens * 8, kv_dtype=kv_dtype,
            enc_kv_dtype=enc_kv_dtype, device=dev, tp=tp)
        self._graphs = None
        if step_graphs is not False and dev.type == "cuda" and tp is None:
            self._graphs = FleetStepGraphs(params, cfg, self.state)
        # slot ids are LOCAL rows (the global rows on one process)
        self.slots = [_Slot() for _ in range(self.local_batch)]
        self._pending_resets: dict = {}    # local sid -> full: bool
        self.left_pad = (st.n_left_pad_tokens * cfg.audio.raw_audio_per_token
                         - pcm_stream_skew(cfg))
        self.steps = 0
        if wire_dtype not in ("f32", "s16"):
            raise ValueError(f"wire_dtype {wire_dtype!r}: 'f32' or 's16'")
        self.wire_dtype = wire_dtype
        self._staged_next = None       # staged, not yet dispatched (<= 1)
        self._dispatched = []          # dispatched _Staged awaiting retire
        self._inflight_sids = set()    # raw-sample owners still in flight
        # pipeline_steps=2: dispatch step k+1 BEFORE fetching step k's
        # tokens. Token streams are identical: a watchdog restart discovered
        # in step k's tokens DISCARDS the restarting stream's already-running
        # step-k+1 row (samples pushed back, replayed after the queued
        # reset); all other rows are unaffected. Trade-off: up to one extra
        # step of recovery delay and per-poll latency.
        self.pipeline_steps = max(1, pipeline_steps)
        self._monitor = monitor
        self.monitor_slow_ms = monitor_slow_ms
        self._last_step_ms = 0.0
        # cumulative wall time inside device steps (dispatch -> tokens
        # fetched, pipelined windows clipped so they do not overlap): poll()
        # wall minus this is the host-side share (stage-entry upload,
        # resets, consume); read through stats()["step_ms_total"]
        self.step_ms_total = 0.0
        # Latency mode: bound each poll() to this many device steps; the
        # remaining backlog (e.g. a watchdog full reset's prompt replay +
        # pushed-back audio) drains across SUBSEQUENT polls instead of one
        # multi-step burst. The same steps run in the same order.
        self.max_steps_per_poll = max_steps_per_poll

    def _ada(self):
        return ada_scales(self.params["decoder"], time_conditioning(
            self.delay, self.cfg.decoder.dim, device=self.device))

    # -- lifecycle ----------------------------------------------------------

    def attach(self) -> int:
        """Claim a free slot; returns the stream id. The stream's padded
        sample stream starts with the left-pad silence (minus the device
        skew, see fleet.py:pcm_stream_skew). The slot's device rows reset
        at the next step boundary (_apply_resets)."""
        for sid, s in enumerate(self.slots):
            if not s.active:
                break
        else:
            raise RuntimeError("fleet full")
        self.slots[sid] = _Slot(
            active=True, buf=np.zeros(self.left_pad, np.float32), queue=[],
            replay_left=self.prompt_len - 1, all_ids=[],
            sdec=self.tok.stream_decoder() if self.tok else None)
        self._queue_reset(sid, full=True)
        return sid

    def detach(self, sid: int):
        self.slots[sid].active = False

    def set_chunk_tokens(self, chunk_tokens: int):
        """Change the step size (tokens per step). Device state is
        untouched: the pending blocks were sized by max_chunk_tokens at
        init, so any chunk up to that bound folds exactly. With step graphs
        a new size is a new shape: its first step runs eagerly and its
        second is captured, as the JAX manager compiles a new program. Must
        be called between polls (no staged chunk in flight)."""
        if self._staged_next is not None or self._dispatched:
            raise RuntimeError("chunk change with a step in flight")
        if chunk_tokens > self.max_chunk_tokens:
            raise ValueError(
                f"chunk_tokens {chunk_tokens} exceeds max_chunk_tokens "
                f"{self.max_chunk_tokens} the device state was sized for")
        self.n = chunk_tokens
        self.chunk_mel = chunk_tokens * 8
        self.chunk_samp = self.chunk_mel * self.cfg.audio.hop_length

    def set_delay(self, delay_tokens: int):
        """Change the transcription delay (vox_set_delay semantics,
        voxtral.c:1681-87): the per-layer ada conditioning switches
        immediately; the prompt length applies to FUTURE prompt builds
        (attach / watchdog full resets). A slot whose prompt replay was
        latched at attach but has not consumed any of it yet re-latches to
        the new length."""
        old_lp = self.prompt_len
        self.delay = delay_tokens
        st = self.cfg.streaming
        self.prompt_len = 1 + st.n_left_pad_tokens + self.delay
        self.t_ada = self._ada()
        for s in self.slots:
            if s.active and s.pos == 0 and s.replay_left == old_lp - 1:
                s.replay_left = self.prompt_len - 1

    def feed(self, sid: int, samples: np.ndarray):
        s = self.slots[sid]
        if not s.active or s.finishing:
            raise RuntimeError(f"feed() on stream {sid}: detached or finishing")
        samples = np.asarray(samples, np.float32).reshape(-1)
        s.buf = np.concatenate([s.buf, samples])
        s.samples_since_text += samples.size

    def finish(self, sid: int):
        """Append right padding + pad the final partial chunk; the slot
        drains on subsequent polls and then reports finished."""
        s = self.slots[sid]
        if s.finishing:
            return
        mult = self.cfg.audio.raw_audio_per_token
        # right pad follows the manager's delay override, not the config
        # default (voxtral.c:1645-1648 computes it from the live delay)
        n_right = self.delay + 1 + self.cfg.streaming.extra_right_pad_tokens
        total = len(s.buf)
        align = (mult - (total % mult)) % mult
        pad = align + n_right * mult
        # tokens beyond the exact right-pad schedule come from rounding the
        # final chunk up to the step size: cap the emitted stream so a
        # finished slot's output matches the batch pipeline token for token
        real_remaining = (total + pad) // mult
        # finish() runs outside poll(), so nothing is in flight: `generated`
        # is exact, and replay_left frames of the remainder emit no tokens
        s.token_limit = s.generated + real_remaining - max(s.replay_left, 0)
        rem = (total + pad) % self.chunk_samp
        if rem:
            pad += self.chunk_samp - rem
        s.buf = np.concatenate([s.buf, np.zeros(pad, np.float32)])
        s.finishing = True

    def get(self, sid: int):
        """Drain (token_id, piece) pairs (text tokens only)."""
        s = self.slots[sid]
        out, s.queue = s.queue, []
        return out

    def is_finished(self, sid: int) -> bool:
        return self.slots[sid].finished

    # -- stepping -----------------------------------------------------------

    def ready(self) -> bool:
        return any(s.active and len(s.buf) >= self.chunk_samp
                   for s in self.slots)

    @torch.no_grad()
    def poll(self):
        """Run lockstep steps while any stream has a full chunk buffered.

        Double-buffered: while step k runs on the device, step k+1's chunks
        are cut and uploaded. Step k+1's forced-replay rows are projected
        past step k's in-flight replay, so results are identical to the
        serial order; a restart discovered in step k's tokens pushes the
        staged slot's samples back and masks its row off.

        Returns the number of device steps taken. With max_steps_per_poll
        set (latency mode), at most that many steps run per call and the
        rest of the backlog waits for the next poll: call again until 0 to
        drain. Raises RuntimeError if a previous poll aborted with steps
        still in flight.

        Multi-process (tp=): every rank must call poll() at the same time;
        whether a step runs is agreed through _any_hosts, so all ranks take
        the same steps even when only one of them has ready streams."""
        if self._dispatched or self._staged_next is not None:
            raise RuntimeError(
                "poll() with a step still in flight: a previous poll aborted "
                "mid-pipeline, so the stream state is no longer consistent")
        cap = self.max_steps_per_poll
        cap = max(1, cap) if cap is not None else None
        depth = self.pipeline_steps
        topk = self.n_alt - 1 if self.n_alt > 1 else 0
        steps_done = dispatched = 0
        t_last_retire = time.perf_counter()
        self._staged_next = self._stage_sync({})
        while self._staged_next is not None or self._dispatched:
            # dispatch while the pipeline has room and the cap allows.
            # Non-continuous streams stop decoding at EOS ON DEVICE (the
            # per-slot `done` flag freezes the slot until reset);
            # continuous mode restarts via the host watchdog instead.
            while (self._staged_next is not None
                   and len(self._dispatched) < depth
                   and (cap is None or dispatched < cap)):
                self._apply_resets()       # queued attach/watchdog resets
                st = self._staged_next
                self._staged_next = None
                if st.dirty:
                    # a watchdog restart edited the staged rows after their
                    # wire upload: re-pack and upload anew (rare path)
                    st.pcm_dev = self._put(
                        pack_wire(st.pcm_host, st.active, st.forced))
                    st.dirty = False
                st.t_dispatch = time.perf_counter()
                kw = dict(collect_topk=topk, stop_at_eos=not self.continuous,
                          wire_packed=True)
                if self._graphs is not None:
                    self.state, tokens, aux = self._graphs.step_masked(
                        st.pcm_dev, None, None, self.t_ada, **kw)
                else:
                    self.state, tokens, aux = fleet_step_masked(
                        self.params, self.cfg, self.state, st.pcm_dev,
                        None, None, self.t_ada, tp=self.tp, **kw)
                st.out = self._start_fetch(aux["packed"] if topk else tokens)
                self._dispatched.append(st)
                dispatched += 1
                if cap is None or dispatched < cap:
                    # stage the next chunk batch NOW: its upload overlaps
                    # the running step
                    self._staged_next = self._stage_sync(self._inflight_replay())
            # retire the oldest in-flight step
            staged = self._dispatched.pop(0)
            self._inflight_sids = set()
            for g in self._dispatched:
                self._inflight_sids |= set(g.raw)
            if self._staged_next is not None:
                self._inflight_sids |= set(self._staged_next.raw)
            alts = None
            if topk:
                # ONE download: tokens + best + top-k vals/idx ride a
                # single packed f32 array (int32 cols as bit patterns)
                pk = self._fetch(staged.out)
                tokens = np.ascontiguousarray(pk[:, :, 0]).view(np.int32)
                k = self.n_alt - 1
                alts = (pk[:, :, 2:2 + k],
                        np.ascontiguousarray(pk[:, :, 2 + k:2 + 2 * k])
                        .view(np.int32),
                        pk[:, :, 1])
            else:
                tokens = self._fetch(staged.out)       # wait for the step
            now = time.perf_counter()
            # pipelined steps' windows overlap: clip each to start at the
            # previous retire, so step_ms_total (poll wall minus it is the
            # host-side residual) and the monitor read non-overlapping time
            self._last_step_ms = (now - max(staged.t_dispatch,
                                            t_last_retire)) * 1e3
            self.step_ms_total += self._last_step_ms
            t_last_retire = now
            self.steps += 1
            steps_done += 1
            for sid in staged.part:
                if sid in staged.discard:
                    continue       # restarted after this row was on device:
                    # samples were pushed back, tokens are void
                self.slots[sid].samples_done += staged.pcm_host.shape[1]
                self._consume(sid, tokens[sid], staged.forced[sid],
                              None if alts is None else
                              (alts[0][sid], alts[1][sid], alts[2][sid]))
            if (self._staged_next is None
                    and (cap is None or dispatched < cap)):
                # a restart may have re-buffered samples during consume
                self._staged_next = self._stage_sync(self._inflight_replay())
        self._apply_resets()   # resets from the final consume
        return steps_done

    def _inflight_replay(self) -> dict:
        """sid -> forced-replay tokens already claimed by dispatched,
        not-yet-retired steps (discarded rows excluded): staging projects
        the next chunk's forced rows past these so results are identical
        to the serial order."""
        out = {}
        for st in self._dispatched:
            for sid in st.part:
                if sid in st.discard:
                    continue
                n = int((st.forced[sid] >= 0).sum())
                if n:
                    out[sid] = out.get(sid, 0) + n
        return out

    def _put(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows -> the device, queued on the compute stream. On CUDA
        the copy's source is a pinned copy of `rows` (kept alive by the
        pinned allocator until the copy has run), so the caller may edit
        `rows` at once."""
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_fetch(self, out: torch.Tensor):
        """Queue the step output's copy to the host behind the step: a
        pinned buffer and an event recorded after the copy (no wait).
        On the CPU the output is already on the host."""
        if out.device.type == "cpu":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def _fetch(out) -> np.ndarray:
        """A step output as numpy: waits for its copy's event only (with
        pipeline_steps=2 the next step keeps running)."""
        host, done = out
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _any_hosts(self, flags) -> np.ndarray:
        """Elementwise OR of `flags` over every rank (one process: flags)."""
        if self._n_procs == 1:
            return np.asarray(flags, bool)
        return any_across_hosts(flags)

    def _stage_sync(self, inflight: dict):
        """_stage, gated by the ready flag agreed over every rank: None iff
        no rank has a full chunk buffered; a rank with nothing ready still
        stages an all-inactive block, so it takes part in the agreed step."""
        if not self._any_hosts([self.ready()])[0]:
            return None
        return self._stage(inflight)

    def _stage(self, inflight: dict):
        """Cut a full chunk from every ready local slot and start its
        upload. inflight: sid -> number of forced-replay tokens in the
        steps that are dispatched but not retired; replay projection keeps
        the staged forced rows identical to what the serial order would
        compute."""
        b, n = self.local_batch, self.n
        wire = np.int16 if self.wire_dtype == "s16" else np.float32
        pcm = np.zeros((b, self.chunk_samp), wire)
        active = np.zeros(b, bool)
        forced = np.full((b, n), -1, np.int32)
        part, raw = [], {}
        for sid, s in enumerate(self.slots):
            if not s.active or len(s.buf) < self.chunk_samp:
                continue
            row = s.buf[:self.chunk_samp]
            s.buf = s.buf[self.chunk_samp:]
            raw[sid] = row
            if wire is np.int16:
                pcm[sid] = np.clip(np.rint(row * 32768.0), -32768, 32767)
            else:
                pcm[sid] = row
            active[sid] = True
            part.append(sid)
            rl = s.replay_left - inflight.get(sid, 0)
            if rl > 0:
                forced[sid, :min(rl, n)] = self.cfg.streaming.streaming_pad
        # ONE upload per step: pcm + active + forced packed into a single
        # row block (pack_wire)
        return _Staged(pcm_dev=self._put(pack_wire(pcm, active, forced)),
                       active=active, forced=forced, part=part, raw=raw,
                       pcm_host=pcm)

    def _queue_reset(self, sid: int, *, full: bool):
        """Defer a per-slot device reset to the next step boundary (full
        wins over decoder-only); no step runs in between."""
        self._pending_resets[sid] = full or self._pending_resets.get(
            sid, False)

    def _apply_resets(self):
        """Apply the queued per-slot resets: at most one full and one
        decoder-only fleet_reset_slots call, written into the state's own
        tensors (a captured step reads those). Unlike the JAX manager's,
        they are not agreed over ranks: the reset runs no collective."""
        if not self._pending_resets:
            return
        dec = np.zeros(self.local_batch, bool)
        full = np.zeros(self.local_batch, bool)
        for sid, f in self._pending_resets.items():
            (full if f else dec)[sid] = True
        self._pending_resets.clear()
        if full.any():
            fleet_reset_slots_(self.cfg, self.state, self._put(full), full=True)
        if dec.any():
            fleet_reset_slots_(self.cfg, self.state, self._put(dec), full=False)

    def _mon_decode(self, sid: int, s: _Slot, steps: int, text: int,
                    control: int, invalid: int, eos_step: bool):
        """Per-slot decode-batch monitor symbol (voxtral.c:1151-1181); slow
        reads the overlap-clipped step time."""
        slow = self._last_step_ms / max(self.n, 1) > self.monitor_slow_ms
        if text > 0:
            sym = "▸" if slow else "▪"
        elif invalid > 0:
            sym = "✘" if slow else "✗"
        elif control > 0:
            sym = "▹" if slow else "▫"
        elif eos_step:
            sym = "◦"
        else:
            sym = "▪"
        sev = ""
        if text == 0 and (control > 0 or invalid > 0):
            if s.nontext_streak >= MAX_NON_TEXT_STREAK - 8:
                sev = "☠"
            elif s.nontext_streak >= MAX_NON_TEXT_STREAK // 2:
                sev = "⚠"
        self._monitor(sid, sym + sev)

    def _restart(self, s: _Slot, sid: int, *, full: bool,
                 trigger: str | None = None):
        s.restarts += 1
        if not s.text_since_restart:
            s.empty_restarts += 1
        full = full or s.empty_restarts >= EMPTY_RESTARTS_FOR_FULL_RESET
        if self._monitor is not None and trigger is not None:
            self._monitor(sid, {"eos": "↺", "kv": "⟳", "streak": "↯",
                                "full": "⌚"}[trigger]
                          + ("♻" if full else "✂"))
        # un-stage: chunks already cut for FUTURE steps were cut under
        # pre-restart assumptions (forced rows, audio continuity for full
        # resets): push their samples back (newest generation first so
        # chronological order is restored) and mask/discard their rows;
        # they are re-cut after the reset. A generation already DISPATCHED
        # (pipeline_steps > 1) cannot be edited on the device: its tokens
        # for this stream are dropped at retire and the queued reset erases
        # its state writes.
        gens = list(self._dispatched)
        if self._staged_next is not None:
            gens.append(self._staged_next)
        for g in reversed(gens):
            if sid not in g.raw:
                continue
            s.buf = np.concatenate([g.raw.pop(sid), s.buf])
            if g.out is not None:          # dispatched: discard at retire
                g.discard.add(sid)
                continue
            g.active[sid] = False
            g.part.remove(sid)
            g.forced[sid] = -1
            g.dirty = True       # wire already uploaded: re-pack at
            # dispatch (poll) so the device sees the edited rows
            if not g.part and self._n_procs == 1:
                # several ranks keep an empty staged block: the step is
                # agreed over ranks (others' rows may take part), and
                # dropping it on one rank only would desync the sequence
                # of collectives
                self._staged_next = None
        self._queue_reset(sid, full=full)
        s.replay_left = self.prompt_len - 1
        s.pos = 0
        s.nontext_streak = 0
        if s.sdec is not None:       # drop any dangling partial character
            s.sdec = self.tok.stream_decoder()
        s.samples_since_text = 0     # restart the watchdog clock too
        # (voxtral.c:1237): else a silent stream full-restarts forever
        s.text_since_restart = False
        if full:
            s.empty_restarts = 0
            s.buf = np.concatenate(
                [np.zeros(self.left_pad, np.float32), s.buf])

    def _alts(self, vals, idxs, best_logit):
        """Alternatives within 1 - p_i/p_best <= cutoff: full-vocab scan
        semantics (voxtral.c:955-1010) via the device-side top-k
        (models/decoder.py:alt_candidates) + the host cutoff walk."""
        return [(j, self.tok.decode([j]) if self.tok else None)
                for j in select_alts(best_logit, vals, idxs,
                                     self.n_alt, self.alt_cutoff)]

    def _consume(self, sid: int, toks: np.ndarray, forced: np.ndarray,
                 alt_info=None):
        cfg = self.cfg
        s = self.slots[sid]
        n_special = cfg.streaming.n_special
        eos = cfg.streaming.eos
        restart = None
        replay_used = 0
        n_text = n_control = n_invalid = n_steps = 0
        eos_step = False
        for i, t in enumerate(toks):
            t = int(t)
            if forced[i] >= 0:
                replay_used += 1
                continue
            if t < 0:
                continue
            if s.token_limit is not None and s.generated >= s.token_limit:
                continue               # final chunk's fill padding
            s.generated += 1
            s.all_ids.append(t)
            s.pos += 1
            n_steps += 1
            if t == eos:
                restart = restart or "eos"
                s.nontext_streak += 1
                eos_step = True
            elif t >= n_special:
                if self.tok is not None and not self.tok.token_bytes(t):
                    # reference STREAM_TOK_INVALID (voxtral.c:524-539): an
                    # empty decode is never enqueued and counts toward the
                    # non-text streak
                    s.nontext_streak += 1
                    n_invalid += 1
                    continue
                piece = s.sdec.piece(t) if s.sdec else None
                if alt_info is not None:
                    s.queue.append((t, piece, self._alts(
                        alt_info[0][i], alt_info[1][i], alt_info[2][i])))
                else:
                    s.queue.append((t, piece))
                s.text_tokens += 1
                s.nontext_streak = 0
                s.samples_since_text = 0
                s.text_since_restart = True
                n_text += 1
            else:
                s.nontext_streak += 1
                n_control += 1
        s.pos += replay_used
        if n_steps and self._monitor is not None:
            self._mon_decode(sid, s, n_steps, n_text, n_control, n_invalid,
                             eos_step)
        s.replay_left -= replay_used
        in_flight = sid in self._inflight_sids
        if not self.continuous:
            if restart == "eos":
                # the device-side `done` flag (stop_at_eos=True) already
                # froze the slot; record it so callers can observe the stop
                s.eos_seen = True
            if s.finishing and len(s.buf) < self.chunk_samp and not in_flight:
                self._finish_slot(s)
            return
        if s.pos > MAX_DECODE_KV:
            restart = restart or "kv"
        if s.nontext_streak >= MAX_NON_TEXT_STREAK:
            restart = restart or "streak"
        no_text_s = s.samples_since_text / cfg.audio.sample_rate
        if no_text_s > MAX_NO_TEXT_SECONDS:
            restart = "full"
        if restart and not s.finishing:
            # triggers >= 2 (kv / streak / timeout) are FULL resets in the
            # reference (voxtral.c:1210-1213); only EOS is decoder-only
            self._restart(s, sid, full=(restart != "eos"), trigger=restart)
            in_flight = False          # _restart un-stages the slot
        if s.finishing and len(s.buf) < self.chunk_samp and not in_flight:
            self._finish_slot(s)

    def _finish_slot(self, s: _Slot):
        s.finished = True
        if s.sdec is not None:
            rem = s.sdec.flush()       # stream ended mid-character
            if rem:
                s.queue.append((-1, rem))

    def retained_kv(self, sid: int) -> int:
        """In-window decode-KV entries slot `sid` actually holds on the
        device (models/decoder.py:retained_window): min(pos, window, ring)
        for a stream that participates in every step; smaller for a
        laggard whose oldest slots the shared cursor recycled."""
        dec = self.state.decode
        ring = dec.k_ring[0].shape[1] - dec.pending_sp.shape[1]
        window = min(self.cfg.decoder.window, ring)
        return int(retained_window(dec, window)[sid])

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "step_ms_total": round(self.step_ms_total, 1),
            "streams": sum(s.active for s in self.slots),
            "generated": sum(s.generated for s in self.slots),
            "text_tokens": sum(s.text_tokens for s in self.slots),
            "restarts": sum(s.restarts for s in self.slots),
            **device_memory_gb(self.device),
        }

    def close(self):
        """Free the step's graphs and their pool. The JAX manager's mesh
        context has no counterpart here, and the process group belongs to
        the caller."""
        if self._graphs is not None:
            self._graphs.close()
            self._graphs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
