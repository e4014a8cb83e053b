"""Streaming engine: one transcription stream (counterpart of
`voxtral_tpu/runtime/stream.py`).

The reference stream state machine (voxtral.c:457-1240) with the host doing
control flow and bookkeeping and the math on `device`. Two backends give
the same tokens:

- "bucketed", the general path: the host MelStream (native C++ when it
  builds), the conv0/conv1 chunk functions with carried tails
  (voxtral.c:569-759 semantics; the tails start as zeros, so the first
  chunk takes the same path and drops the outputs the zero pad
  contaminated), the ring-cache incremental encoder and the adapter, then
  the decoder prefill and `decode_scan` over the adapter backlog. Row
  counts are padded up to fixed buckets (`MEL_BUCKETS`, `DECODE_BUCKETS`)
  with zero rows: they fix the row count of every product (and so the
  route of a Q8 product and the order of its sums) whatever the feed sizes.
  Each bucket's program (conv0, conv1, the encoder chunk and the adapter
  per mel bucket, the prefill, the decode per decode bucket: the JAX
  stream's jitted programs) is captured as a CUDA graph on CUDA and
  replayed (runtime/step_graph.py; `StreamConfig.step_graphs=False`:
  eager), over the stream's encoder and decoder states, which resets
  write in place. Tails, residual carries, the backlog and the watchdog
  stay on the host;
- "fused", a B = 1 `FleetManager` (runtime/manager.py): device mel and one
  fleet step per chunk.

`backend="auto"` takes fused on a CUDA device and bucketed on the CPU.
The device state is written in place (the rings of the encoder and decoder
states); each decode call brings its tokens to the host once.

Watchdog/self-healing semantics (EOS restart, KV cap, non-text streak,
no-decode timeout, decoder-reset vs full-reset escalation) mirror
voxtral.c:410-420 and :1189-1239.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from voxtral_tpu_torch.audio.native import make_mel_stream
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    ada_scales, init_decode_state, reset_streams, time_conditioning,
)
from voxtral_tpu_torch.models.encoder import (
    encoder_incremental, init_encoder_state, init_encoder_state_,
)
from voxtral_tpu_torch.models.pipeline import DECODE_BUCKETS, bucket
from voxtral_tpu_torch.ops.conv import causal_conv1d
from voxtral_tpu_torch.runtime.alts import select_alts
from voxtral_tpu_torch.runtime.manager import FleetManager, _first_tensor
from voxtral_tpu_torch.runtime.step_graph import DecodeGraphs, StateGraphs, program_key
from voxtral_tpu_torch.utils import resolve_device

# Shape buckets (mel frames per conv call; decode steps per decode call).
# Bucket caps are bounded by the pending-KV block sizes: 256 mel frames ->
# <= 128 encoder positions (the encoder's pending block), 64 decode steps
# (the decoder's).
MEL_BUCKETS = (64, 128, 256)
FIRST_CHUNK_MIN_MEL = 312        # covers the 39-token prompt (voxtral.c:405)
MAX_DECODE_KV = 2000             # forced-restart KV bound (voxtral.c:412)
MAX_NON_TEXT_STREAK = 64
MAX_NO_DECODE_SECONDS = 20
EMPTY_RESTARTS_FOR_FULL_RESET = 2


def _conv0_chunk(w, b, x):
    """x: [mel_bins, 2+M] (2-frame tail + new frames). Returns [enc_dim, M]:
    causal conv + exact GELU, first 2 outputs (zero-pad contaminated)
    dropped."""
    return F.gelu(causal_conv1d(x, w, b, stride=1))[:, 2:]


def _conv1_chunk(w, b, x):
    """x: [enc_dim, 2+F] (2-frame tail + F fed outputs, F even). Returns
    [enc_dim, F//2]: stride-2 causal conv + GELU, first output dropped."""
    return F.gelu(causal_conv1d(x, w, b, stride=2))[:, 1:]


@dataclasses.dataclass
class StreamConfig:
    interval: float = 2.0            # seconds between encoder runs
    delay_tokens: int = 6            # transcription delay (x80 ms)
    continuous: bool = False         # live mode: watchdog auto-restarts
    n_alt: int = 1                   # alternatives per token (1 = off)
    alt_cutoff: float = 0.0
    ring_size: int = 1280            # encoder KV ring (>= window + max chunk)
    monitor: bool = False
    # decode-batch "slow" threshold for the monitor's ▸/▹/✘ variants; the
    # reference hard-codes 40 ms/step (voxtral.c:1153)
    monitor_slow_ms: float = 40.0
    # "fused": a B=1 FleetManager (device mel, one fleet step per chunk);
    # "bucketed": the general ragged-slice path; "auto": fused on a CUDA
    # device, bucketed on the CPU. The token streams are identical.
    backend: str = "auto"            # auto | fused | bucketed
    # KV ring storage for the fused backend ("float" keeps weight
    # precision; "int8" halves the decoder rings like the serving fleet)
    kv_dtype: str = "float"
    # ENCODER ring storage for the fused backend (None follows kv_dtype):
    # "int4" nibble-packs the encoder rings, the serving configuration's
    # (Q8 weights + int8 decoder rings + int4 encoder rings)
    enc_kv_dtype: str | None = None
    # replay the bucketed programs (and the fused backend's step) as CUDA
    # graphs: None on CUDA, False eager, True raises off CUDA
    step_graphs: bool | None = None


class VoxStream:
    """One transcription stream. API mirrors voxtral.h:274-324:
    feed() / flush() / finish() / get() / get_alt() / set_interval().
    Runs on `device` ("cuda" raises without CUDA); `params` must live
    there."""

    def __init__(self, params, cfg: VoxtralConfig, tokenizer=None,
                 stream_cfg: StreamConfig | None = None, device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        p_dev = _first_tensor(params).device
        if p_dev != dev:
            raise RuntimeError(
                f"params live on {p_dev}, the stream runs on {dev}: move them "
                "(weights.from_numpy_params / random_params take device=)")
        self.device = dev
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        # incremental UTF-8 piece decoder: a character split across tokens
        # concatenates correctly (see tokenizer.StreamDecoder)
        self._sdec = tokenizer.stream_decoder() if tokenizer else None
        self.sc = stream_cfg or StreamConfig()
        sc = self.sc
        st = cfg.streaming
        self.prompt_ids = np.asarray(
            [st.bos] + [st.streaming_pad] * (st.n_left_pad_tokens
                                             + sc.delay_tokens), np.int32)
        self.t_ada = self._ada()
        self.min_new_mel = max(int(sc.interval * 100.0), 1)
        self.real_samples_fed = 0
        self.finished = False
        # token queue: list of (token_id, piece, [(alt_id, alt_piece), ...])
        self.queue: list = []
        # stats
        self.n_generated = 0
        # full greedy stream (text + control + eos), for tests/inspection;
        # the queue itself carries only TEXT tokens (reference semantics)
        self.generated_ids: list[int] = []
        self.n_text_tokens = 0
        self.encoder_s = 0.0
        self.decoder_s = 0.0
        self.prefill_s = 0.0
        self.monitor_log: list[str] = []
        self.eos_seen = False
        if sc.step_graphs and dev.type != "cuda":
            raise ValueError(f"step_graphs=True needs CUDA (device {dev})")
        self._capture = sc.step_graphs is not False and dev.type == "cuda"
        self._enc = self._dec = None      # the bucketed programs' owners
        backend = sc.backend
        if backend == "auto":
            backend = "fused" if dev.type == "cuda" else "bucketed"
        if backend not in ("fused", "bucketed"):
            raise ValueError(f"backend {sc.backend!r}: auto, fused or bucketed")
        self.backend = backend
        if backend == "bucketed" and (
                sc.kv_dtype != "float"
                or sc.enc_kv_dtype not in (None, "float")):
            # the bucketed path always runs float rings; ignoring a
            # quantization request silently would misreport the serving
            # configuration, so warn (backend="auto" on the CPU still runs)
            warnings.warn(
                "kv_dtype/enc_kv_dtype are fused-backend options; the "
                "bucketed backend runs float KV rings", stacklevel=2)
        self._mgr = None
        if backend == "fused":
            self._init_fused()
        else:
            self._init_audio_state()
            self._init_decoder_state()

    def _ada(self):
        return ada_scales(self.params["decoder"], time_conditioning(
            self.sc.delay_tokens, self.cfg.decoder.dim, device=self.device))

    # -- fused backend (B=1 FleetManager delegate) --------------------------

    _FUSED_CHUNK_CAP = 64      # tokens; bounds set_interval without reinit

    @staticmethod
    def _interval_tokens(seconds: float) -> int:
        return max(1, min(int(round(seconds * 12.5)),
                          VoxStream._FUSED_CHUNK_CAP))

    def _init_fused(self):
        """The B=1 instance of the serving fleet (device mel, fused
        conv/encoder/adapter/decode, prompt entry via forced-token replay).
        The manager's finished stream equals the batch pipeline's tokens,
        so the fused stream's equal the bucketed path's."""
        cfg, sc = self.cfg, self.sc
        self._mgr = FleetManager(
            self.params, cfg, batch=1, tokenizer=self.tok,
            chunk_tokens=self._interval_tokens(sc.interval),
            max_chunk_tokens=self._FUSED_CHUNK_CAP,
            delay_tokens=sc.delay_tokens, kv_dtype=sc.kv_dtype,
            enc_kv_dtype=sc.enc_kv_dtype,
            dec_ring=cfg.decoder.window + self._FUSED_CHUNK_CAP,
            continuous=sc.continuous, n_alt=sc.n_alt,
            alt_cutoff=sc.alt_cutoff,
            monitor=lambda sid, sym: self._mon(sym),
            monitor_slow_ms=sc.monitor_slow_ms, device=self.device,
            step_graphs=sc.step_graphs)
        self._mgr.attach()
        self._drained_ids = 0

    def _poll_fused(self):
        t0 = time.perf_counter()
        self._mgr.poll()
        self.decoder_s += time.perf_counter() - t0
        self._drain_fused()

    def _drain_fused(self):
        s = self._mgr.slots[0]
        self.generated_ids.extend(s.all_ids[self._drained_ids:])
        self._drained_ids = len(s.all_ids)
        self.n_generated = len(s.all_ids)
        self.n_text_tokens = s.text_tokens
        self.eos_seen = s.eos_seen
        for e in s.queue:
            tid, piece = e[0], e[1]
            alts = e[2] if len(e) > 2 else []
            if piece is None:
                piece = f"<{tid}>"
            self.queue.append(
                (tid, piece,
                 [(j, p if p is not None else f"<{j}>") for j, p in alts]))
        s.queue = []

    # -- state management ---------------------------------------------------

    @property
    def enc_state(self):
        return self._enc.state

    @property
    def decode_state(self):
        return self._dec.state

    def _init_audio_state(self):
        """The host's audio state, and the encoder state at its initial
        values (written in place after the first time)."""
        cfg, dev = self.cfg, self.device
        mult = cfg.audio.raw_audio_per_token
        self.mel = make_mel_stream(
            left_pad_samples=cfg.streaming.n_left_pad_tokens * mult,
            cfg=cfg.audio)
        self.mel_cursor = 0
        self.conv_initialized = False
        self.mel_tail = np.zeros((cfg.audio.mel_bins, 2), np.float32)
        self.conv0_tail = torch.zeros((cfg.encoder.dim, 2),
                                      dtype=cfg.compute_dtype, device=dev)
        self.conv0_residual = None        # [enc_dim, 1] tensor or None
        if self._enc is None:
            self._enc = StateGraphs(init_encoder_state(cfg, ring_size=self.sc.ring_size,
                                                       batch=1, device=dev),
                                    capture=self._capture)
        else:
            init_encoder_state_(self._enc.state)
        self.enc_residual: list = []      # tensors, total rows <= 3
        self.enc_residual_rows = 0

    def _init_decoder_state(self):
        self._dec = DecodeGraphs(init_decode_state(self.cfg, batch=1, device=self.device),
                                 capture=self._capture)
        self.backlog: list = []           # tensors [n_i, dec_dim]
        self.backlog_rows = 0
        self.decoder_started = False
        self.eos_seen = False
        self.kv_len = 0
        self.nontext_streak = 0
        self.text_since_restart = False
        self.empty_restarts = 0
        self.last_decode_sample = self.real_samples_fed
        self._waiting_prompt = False     # ⌛ emitted once per wait episode

    def _reset_decoder(self):
        """Hard decoder reset (voxtral.c:778-794): drop backlog + context.
        Ring contents stay: pos := 0 masks them out."""
        self._dec.load_state(reset_streams(
            self.decode_state,
            torch.ones((1,), dtype=torch.bool, device=self.device),
            self.cfg.streaming.bos, reset_write_ctr=True))
        self.backlog = []
        self.backlog_rows = 0
        self.decoder_started = False
        self.eos_seen = False
        self.kv_len = 0
        self.nontext_streak = 0
        self.text_since_restart = False
        if self.tok is not None:   # drop any dangling partial character
            self._sdec = self.tok.stream_decoder()

    def _reset_full(self):
        """Full stream reset (voxtral.c:797-824): mel/conv/encoder/decoder."""
        self._init_audio_state()
        self._reset_decoder()
        self.empty_restarts = 0

    # -- public API ---------------------------------------------------------

    def set_interval(self, seconds: float):
        self.min_new_mel = max(int(seconds * 100.0), 1)
        if self._mgr is not None:
            # new step size only; device state was sized for the cap
            self._mgr.set_chunk_tokens(self._interval_tokens(seconds))

    def set_continuous(self, enable: bool):
        """Enable/disable live mode (vox_stream_set_continuous,
        voxtral.h:306-317 / voxtral.c:1677): watchdog auto-restarts on EOS,
        KV overflow, non-text streaks, and no-decode timeouts. Off (the
        default), EOS ends decoding, fine for finite files."""
        self.sc.continuous = bool(enable)
        if self._mgr is not None:
            self._mgr.continuous = bool(enable)

    def set_delay(self, delay_ms: int):
        """Change the transcription delay (vox_set_delay, voxtral.c:1681-87):
        clamp to 80..2400 ms at 80 ms granularity, recompute the per-layer
        ada scales, and (like the reference) apply to FUTURE prompt builds:
        an already-prefilled stream keeps decoding with the new conditioning
        but its prompt length is fixed."""
        delay_ms = max(80, min(2400, int(delay_ms)))
        self.sc.delay_tokens = delay_ms // 80
        st = self.cfg.streaming
        self.prompt_ids = np.asarray(
            [st.bos] + [st.streaming_pad] * (st.n_left_pad_tokens
                                             + self.sc.delay_tokens), np.int32)
        self.t_ada = self._ada()
        if self._mgr is not None:
            self._mgr.set_delay(self.sc.delay_tokens)

    def feed(self, samples: np.ndarray):
        if self.finished:
            raise RuntimeError("stream already finished")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size == 0:
            return
        self.real_samples_fed += samples.size
        if self._mgr is not None:
            self._mgr.feed(0, samples)
            self._poll_fused()
            return
        self.mel.feed(samples)
        self._run_encoder()
        self._run_decoder()

    def flush(self):
        """Push right padding so delayed tokens drain; stream stays open
        (voxtral.c:1640-1667)."""
        if self.finished:
            return
        mult = self.cfg.audio.raw_audio_per_token
        st = self.cfg.streaming
        # the right pad follows the stream's LIVE delay (set_delay), as the
        # reference computes it from ctx->delay_tokens (voxtral.c:1645-1648)
        n_right = self.sc.delay_tokens + 1 + st.extra_right_pad_tokens
        if self._mgr is not None:
            # pad to a token boundary + the delay-drain right pad, then
            # drain the sub-chunk tail exactly with 1-token steps (the pad
            # is part of the audio stream, so the tokens equal what the
            # bucketed path emits at the same positions)
            s = self._mgr.slots[0]
            align = (mult - (len(s.buf) % mult)) % mult
            self._mgr.feed(0, np.zeros(align + n_right * mult, np.float32))
            self._poll_fused()
            prev = self._mgr.n
            if prev != 1 and len(s.buf):
                self._mgr.set_chunk_tokens(1)
                try:
                    self._poll_fused()
                finally:
                    self._mgr.set_chunk_tokens(prev)
            return
        align = (mult - (self.real_samples_fed % mult)) % mult
        # fed directly to the mel context: flush padding is not "real" audio
        self.mel.feed(np.zeros(align + n_right * mult, np.float32))
        saved = self.min_new_mel
        self.min_new_mel = 1
        self._run_encoder()
        self._run_decoder()
        self.min_new_mel = saved

    def finish(self):
        if self.finished:
            return
        if self._mgr is not None:
            # manager finish = right pad + exact token_limit cap; a
            # finished B=1 slot equals the batch pipeline, so no separate
            # flush is needed
            self.finished = True
            self._mgr.finish(0)
            while not self._mgr.is_finished(0):
                before = self._mgr.steps
                self._poll_fused()
                if self._mgr.steps == before:   # no progress: fail loud
                    raise RuntimeError("fused finish() did not drain")
            self._drain_fused()
            return
        self.flush()
        self.finished = True
        self.mel.finish()
        saved = self.min_new_mel
        self.min_new_mel = 1
        self._run_encoder()
        self._run_decoder()
        self.min_new_mel = saved
        if self._sdec is not None:
            rem = self._sdec.flush()   # stream ended mid-character
            if rem and self.queue:
                tid, piece, alts = self.queue[-1]
                self.queue[-1] = (tid, piece + rem, alts)
            elif rem:
                self.queue.append((-1, rem, []))

    def get(self, max_tokens: int = 1 << 30) -> list[str]:
        """Drain best-token pieces (text tokens only, like vox_stream_get)."""
        out = []
        while self.queue and len(out) < max_tokens:
            tid, piece, _ = self.queue.pop(0)
            out.append(piece)
        return out

    def get_alt(self, max_tokens: int = 1 << 30):
        """Drain (piece, [alt pieces]) tuples."""
        out = []
        while self.queue and len(out) < max_tokens:
            tid, piece, alts = self.queue.pop(0)
            out.append((piece, [p for _, p in alts]))
        return out

    def get_ids(self, max_tokens: int = 1 << 30) -> list[int]:
        out = []
        while self.queue and len(out) < max_tokens:
            tid, piece, _ = self.queue.pop(0)
            out.append(tid)
        return out

    # -- encoder side -------------------------------------------------------

    @torch.no_grad()
    def _run_encoder(self):
        total_mel = self.mel.frame_offset + self.mel.n_frames
        new_mel = total_mel - self.mel_cursor
        need = (FIRST_CHUNK_MIN_MEL if not self.conv_initialized
                else self.min_new_mel)
        if new_mel < need and not self.finished:
            return
        if new_mel <= 0:
            return
        t0 = time.perf_counter()
        frames = self.mel.frames()
        start = self.mel_cursor - self.mel.frame_offset
        pos = start
        while pos < start + new_mel:
            m = min(start + new_mel - pos, MEL_BUCKETS[-1])
            self._encode_slice(frames[pos:pos + m])
            pos += m
        self.mel_cursor = total_mel
        self.mel.discard_before(self.mel_cursor)
        self.encoder_s += time.perf_counter() - t0
        self._mon("▶")

    def _enc_program(self, entry: str, run, *inputs) -> torch.Tensor:
        """run(*inputs) -> (encoder state, output) as the encoder side's
        program `entry` (one per input shape), its output copied out of
        the graphs' pool (the next replay may overwrite it)."""
        (out,) = self._enc.call(program_key(entry, self.params["decoder"], inputs), run,
                                inputs)
        return out.clone()

    def _encode_slice(self, mel_slice: np.ndarray):
        """Run one slice (<= MEL_BUCKETS[-1] = 256 frames) through conv
        stem + encoder + adapter."""
        cfg, dev = self.cfg, self.device
        enc = self.params["encoder"]
        self.conv_initialized = True
        m = mel_slice.shape[0]
        mb = bucket(m, MEL_BUCKETS)
        # conv0: [mel_bins, 2 + mb] with tail prepended, zero pad to bucket
        x = np.zeros((cfg.audio.mel_bins, 2 + mb), np.float32)
        x[:, :2] = self.mel_tail
        x[:, 2:2 + m] = mel_slice.T
        y = self._enc_program("conv0", lambda x: (self.enc_state, _conv0_chunk(
            enc["conv0_w"], enc["conv0_b"], x)), torch.from_numpy(x).to(dev))[:, :m]
        # update mel tail (last 2 valid frames; shift if m == 1)
        if m >= 2:
            self.mel_tail = mel_slice[-2:].T
        else:
            self.mel_tail = np.concatenate(
                [self.mel_tail[:, 1:], mel_slice.T], axis=1)

        # stride-parity alignment for conv1 (even feed count)
        prev_res = 0 if self.conv0_residual is None else 1
        total = prev_res + m
        new_res = total & 1
        feed_from_new = m - new_res
        parts = []
        if prev_res:
            parts.append(self.conv0_residual)
        if feed_from_new > 0:
            parts.append(y[:, :feed_from_new])
        self.conv0_residual = y[:, m - 1:m] if new_res else None
        feed_total = prev_res + feed_from_new
        if feed_total <= 0:
            return
        feed = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

        fb = bucket(feed_total, MEL_BUCKETS)
        x1 = torch.zeros((cfg.encoder.dim, 2 + fb), dtype=feed.dtype, device=dev)
        x1[:, :2] = self.conv0_tail
        x1[:, 2:2 + feed_total] = feed
        self.conv0_tail = feed[:, -2:]
        c = self._enc_program("conv1", lambda x: (self.enc_state, _conv1_chunk(
            enc["conv1_w"], enc["conv1_b"], x)), x1)[:, :feed_total // 2]
        s = feed_total // 2

        # incremental encoder (bucketed, masked); h_pad is a fresh
        # contiguous buffer, never the transposed view c.t()
        sb = bucket(s, MEL_BUCKETS)
        h_pad = torch.zeros((sb, cfg.encoder.dim), dtype=cfg.compute_dtype,
                            device=dev)
        h_pad[:s] = c.t()
        enc_out = self._enc_program(
            "encoder", lambda h, nv: encoder_incremental(enc, cfg, self.enc_state, h, nv),
            h_pad[None], torch.full((1,), s, dtype=torch.int32, device=dev))[0][:s]

        # 4x-downsample alignment with residual carry (voxtral.c:869-934)
        total_enc = self.enc_residual_rows + s
        usable = (total_enc // cfg.downsample) * cfg.downsample
        if usable > 0:
            pieces = list(self.enc_residual)
            take_new = usable - self.enc_residual_rows
            pieces.append(enc_out[:take_new])
            ab = bucket(usable, MEL_BUCKETS)
            cpad = torch.zeros((ab, cfg.encoder.dim), dtype=enc_out.dtype,
                               device=dev)
            cpad[:usable] = torch.cat(pieces)
            adapter = self._enc_program("adapter", lambda x: (self.enc_state, adapter_forward(
                self.params["adapter"], cfg, x)), cpad)
            self.backlog.append(adapter[:usable // cfg.downsample])
            self.backlog_rows += usable // cfg.downsample
            leftover = total_enc - usable
            self.enc_residual = [enc_out[take_new:s]] if leftover else []
            self.enc_residual_rows = leftover
        else:
            self.enc_residual.append(enc_out)
            self.enc_residual_rows = total_enc

    # -- decoder side -------------------------------------------------------

    def _take_backlog(self, n: int):
        """Pop the first n adapter frames from the backlog (device concat)."""
        out, got = [], 0
        while got < n:
            head = self.backlog[0]
            need = n - got
            if head.shape[0] <= need:
                out.append(head)
                got += head.shape[0]
                self.backlog.pop(0)
            else:
                out.append(head[:need])
                self.backlog[0] = head[need:]
                got += need
        self.backlog_rows -= n
        return out[0] if len(out) == 1 else torch.cat(out)

    @torch.no_grad()
    def _run_decoder(self):
        cfg, dev = self.cfg, self.device
        lp = len(self.prompt_ids)
        if not self.decoder_started:
            if self.backlog_rows < lp:
                if not self._waiting_prompt:
                    # ⌛ = waiting for enough adapter tokens to prefill
                    # (voxtral.c:1024-1030, once per wait episode)
                    self._mon("⌛")
                    self._waiting_prompt = True
                return
            t0 = time.perf_counter()
            frames = self._take_backlog(lp - 1)
            prompt = torch.from_numpy(self.prompt_ids).to(dev)
            self._dec.prefill(self.params["decoder"], cfg, frames, prompt[:lp - 1],
                              prompt[lp - 1:], self.t_ada)
            self.decoder_started = True
            self.kv_len = lp - 1
            dt = time.perf_counter() - t0
            self.prefill_s += dt
            self.decoder_s += dt
            self._waiting_prompt = False
            self._mon("·")

        if self.decoder_started and not self.eos_seen and self.backlog_rows > 0:
            t0 = time.perf_counter()
            n_text = n_control = n_invalid = n_steps = 0
            eos_step = False
            topk = self.sc.n_alt - 1 if self.sc.n_alt > 1 else 0
            while self.backlog_rows > 0 and not self.eos_seen:
                n = min(self.backlog_rows, DECODE_BUCKETS[-1])
                nb = bucket(n, DECODE_BUCKETS)
                frames = self._take_backlog(n)
                fpad = torch.zeros((nb, cfg.decoder.dim), dtype=frames.dtype,
                                   device=dev)
                fpad[:n] = frames
                tokens, aux = self._dec.scan(
                    self.params["decoder"], cfg, fpad[None],
                    torch.full((1,), n, dtype=torch.int32, device=dev),
                    self.t_ada, collect_topk=topk, stop_at_eos=True)
                # ONE device->host copy per decode call, read before the next
                # replay: the tokens, or the packed aux (tokens + best logit
                # + top-k) with alt-tokens
                if topk:
                    pk = aux["packed"][0, :n].cpu().numpy()
                    toks = np.ascontiguousarray(pk[:, 0]).view(np.int32)
                    tbest = pk[:, 1]
                    tvals = pk[:, 2:2 + topk]
                    tidx = np.ascontiguousarray(pk[:, 2 + topk:]).view(np.int32)
                else:
                    toks = tokens[0, :n].cpu().numpy()
                self.last_decode_sample = self.real_samples_fed
                for i, t in enumerate(toks):
                    if t < 0:
                        break
                    t = int(t)
                    self.n_generated += 1
                    self.generated_ids.append(t)
                    self.kv_len += 1
                    n_steps += 1
                    if t == cfg.streaming.eos:
                        self.eos_seen = True
                        eos_step = True
                        break
                    cls = self._emit(t, tbest[i] if topk else None,
                                     tvals[i] if topk else None,
                                     tidx[i] if topk else None)
                    if cls == "text":
                        n_text += 1
                    elif cls == "invalid":
                        n_invalid += 1
                    else:
                        n_control += 1
            dt = time.perf_counter() - t0
            self.decoder_s += dt
            if n_steps:
                self._mon_decode(dt, n_steps, n_text, n_control, n_invalid,
                                 eos_step)

        self._watchdog()

    def _classify(self, token_id: int) -> str:
        st = self.cfg.streaming
        if token_id == st.eos:
            return "eos"
        if token_id < st.n_special:
            return "control"
        if self.tok is not None:
            return "text" if self.tok.token_bytes(token_id) else "invalid"
        return "text"

    def _mon_decode(self, dt: float, steps: int, text: int, control: int,
                    invalid: int, eos_step: bool):
        """Per-decode-batch monitor symbol (voxtral.c:1151-1181): ▪/▸ text
        decode fast/slow (vs monitor_slow_ms per step), ✗/✘ invalid, ▫/▹
        control-only, ◦ EOS-only; ⚠/☠ appended to textless control/invalid
        batches by non-text-streak severity."""
        if not self.sc.monitor:
            return
        slow = dt * 1000.0 / steps > self.sc.monitor_slow_ms
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
            if self.nontext_streak >= MAX_NON_TEXT_STREAK - 8:
                sev = "☠"
            elif self.nontext_streak >= MAX_NON_TEXT_STREAK // 2:
                sev = "⚠"
        self._mon(sym + sev)

    def _emit(self, token_id: int, best_logit, topk_vals, topk_idx) -> str:
        cls = self._classify(token_id)
        if cls == "text":
            piece = (self._sdec.piece(token_id) if self.tok
                     else f"<{token_id}>")
            alts = []
            if topk_vals is not None and self.sc.n_alt > 1:
                for j in select_alts(best_logit, topk_vals, topk_idx,
                                     self.sc.n_alt, self.sc.alt_cutoff):
                    p = (self.tok.decode_piece(j) if self.tok else f"<{j}>")
                    alts.append((j, p))
            self.queue.append((token_id, piece, alts))
            self.n_text_tokens += 1
            self.text_since_restart = True
            self.empty_restarts = 0
            self.nontext_streak = 0
        else:
            self.nontext_streak += 1
        return cls

    def _watchdog(self):
        """Liveness restarts for continuous streams (voxtral.c:1189-1239)."""
        if not self.sc.continuous:
            return
        sr = self.cfg.audio.sample_rate
        need = 0
        if self.eos_seen:
            need = 1
        elif self.decoder_started and self.kv_len > MAX_DECODE_KV:
            need = 2
        elif self.decoder_started and self.nontext_streak >= MAX_NON_TEXT_STREAK:
            need = 3
        elif (not self.finished and
              (self.real_samples_fed - self.last_decode_sample)
              >= MAX_NO_DECODE_SECONDS * sr):
            need = 4
        if not need:
            return
        if self.text_since_restart:
            self.empty_restarts = 0
        else:
            self.empty_restarts += 1
        full = need >= 2 or self.empty_restarts >= EMPTY_RESTARTS_FOR_FULL_RESET
        self._mon({1: "↺", 2: "⟳", 3: "↯", 4: "⌚"}[need]
                  + ("♻" if full else "✂"))
        if full:
            self._reset_full()
        else:
            self._reset_decoder()
        self.last_decode_sample = self.real_samples_fed

    def _mon(self, sym: str):
        if self.sc.monitor:
            sys.stderr.write(sym)
            sys.stderr.flush()
        self.monitor_log.append(sym)

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        gen_s = self.decoder_s - self.prefill_s
        steps = max(self.n_generated - 1, 1)
        if self._mgr is not None:
            s = self._mgr.slots[0]
            return {
                # fused: one step covers mel->conv->encode->decode, so
                # encoder/prefill time is not separable: those phases
                # report None and decoder_ms/ms_per_step carry the WHOLE
                # step, flagged by step_ms_includes_encoder
                "mel_frames": s.samples_done // self.cfg.audio.hop_length,
                "text_tokens": self.n_text_tokens,
                "generated": self.n_generated,
                "encoder_ms": None,
                "decoder_ms": self.decoder_s * 1e3,
                "prefill_ms": None,
                "step_ms_includes_encoder": True,
                "ms_per_step": gen_s * 1e3 / steps,
                "audio_s": self.real_samples_fed / self.cfg.audio.sample_rate,
                "restarts": s.restarts,
            }
        return {
            "mel_frames": self.mel_cursor,
            "text_tokens": self.n_text_tokens,
            "generated": self.n_generated,
            "encoder_ms": self.encoder_s * 1e3,
            "decoder_ms": self.decoder_s * 1e3,
            "prefill_ms": self.prefill_s * 1e3,
            "ms_per_step": gen_s * 1e3 / steps,
            "audio_s": self.real_samples_fed / self.cfg.audio.sample_rate,
        }
