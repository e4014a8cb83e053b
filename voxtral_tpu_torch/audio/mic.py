"""Microphone capture (Linux): a copy of `voxtral_tpu/audio/mic.py`,
mirroring the reference mic layer (voxtral_mic.h:13-23,
voxtral_mic_macos.c): non-blocking reads of 16 kHz mono f32 samples from a
background capture source.

The reference uses AudioQueue on macOS and a stub elsewhere; here the
capture backend is a subprocess (`arecord` ALSA, or `ffmpeg` with pulse/alsa
input) feeding a pipe — portable and dependency-free. If no backend binary
exists, MicSource raises at start(), matching the stub's -1.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time

import numpy as np

RATE = 16000


def _capture_cmds(rate: int):
    """Candidate capture commands, tried in order (a backend binary may
    exist but have no usable device — start() health-checks each)."""
    out = []
    if shutil.which("arecord"):
        out.append(["arecord", "-q", "-f", "S16_LE", "-r", str(rate),
                    "-c", "1", "-t", "raw"])
    if shutil.which("ffmpeg"):
        for dev in (["-f", "pulse", "-i", "default"],
                    ["-f", "alsa", "-i", "default"]):
            out.append(["ffmpeg", "-loglevel", "quiet"] + dev +
                       ["-f", "s16le", "-ar", str(rate), "-ac", "1", "-"])
    return out


class MicSource:
    """start() spawns the capture subprocess; read() returns whatever
    samples are available right now (possibly empty), like vox_mic_read."""

    def __init__(self, rate: int = RATE):
        self.rate = rate
        self.proc = None

    def start(self):
        cmds = _capture_cmds(self.rate)
        if not cmds:
            raise RuntimeError(
                "no microphone backend (need `arecord` or `ffmpeg`)")
        for cmd in cmds:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL)
            # health check: a backend with no capture device exits at once
            # (the reference's vox_mic_start returns -1 there)
            time.sleep(0.25)
            if proc.poll() is None:
                self.proc = proc
                os.set_blocking(self.proc.stdout.fileno(), False)
                self._pending = b""
                return
            proc.wait()
        raise RuntimeError(
            "all microphone backends exited immediately "
            f"(tried: {', '.join(c[0] for c in cmds)})")

    def read(self) -> np.ndarray:
        if self.proc is None:
            return np.zeros(0, np.float32)
        try:
            data = self.proc.stdout.read()
        except (BlockingIOError, ValueError):
            data = None
        if data:
            self._pending += data
        elif self.proc.poll() is not None and not self._pending:
            raise RuntimeError(
                f"capture process exited (code {self.proc.returncode})")
        n = len(self._pending) // 2
        if n == 0:
            return np.zeros(0, np.float32)
        raw, self._pending = self._pending[:n * 2], self._pending[n * 2:]
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0

    def stop(self):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self.proc.kill()
            self.proc = None


def mic_loop(stream, drain, rate: int = RATE, *,
             silence_rms: float = 0.002, silence_flush_s: float = 0.6,
             over_buffer_s: float = 5.0, log=lambda m: None):
    """The reference's live mic loop (main.c:211-303): per-10ms RMS gate,
    voice -> feed; >600 ms of silence -> one flush; if capture outruns the
    engine by >5 s, skip to the last 1 s (catch-up)."""
    mic = MicSource(rate)
    mic.start()
    win = rate // 100                       # 10 ms
    silent_for = 0.0
    flushed = True
    buf = np.zeros(0, np.float32)
    log("listening (ctrl-c to stop)")
    try:
        while True:
            chunk = mic.read()
            if chunk.size:
                buf = np.concatenate([buf, chunk])
            if buf.size > over_buffer_s * rate:
                log(f"over-buffer: skipping {buf.size/rate - 1.0:.1f}s")
                buf = buf[-rate:]
                # discarded audio must not drive the silence gate
                # (main.c:247-249 zeroes silence_count after catch-up)
                silent_for = 0.0
                flushed = False
            take = (buf.size // win) * win
            if take == 0:
                drain(stream)
                time.sleep(0.01)
                continue
            frames, buf = buf[:take], buf[take:]
            for i in range(0, take, win):
                w = frames[i:i + win]
                rms = float(np.sqrt(np.mean(w * w)))
                if rms >= silence_rms:
                    silent_for = 0.0
                    flushed = False
                    stream.feed(w)
                else:
                    silent_for += win / rate
                    # pass silence through only up to the flush threshold;
                    # a long silent stretch is NOT fed (main.c:268-292 —
                    # the engine would otherwise keep stepping on silence)
                    if silent_for < silence_flush_s:
                        stream.feed(w)
            if silent_for >= silence_flush_s and not flushed:
                stream.flush()
                flushed = True
            drain(stream)
    except KeyboardInterrupt:
        pass
    except RuntimeError as e:
        log(f"mic: {e}")
    finally:
        mic.stop()
        stream.finish()
        drain(stream)
