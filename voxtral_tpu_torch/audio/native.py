"""ctypes binding for the native C++ audio frontend (native/voxaudio.cpp),
the counterpart of `voxtral_tpu/audio/native.py`.

Builds the shared library at first use with g++ and the JAX binding's flags
into `build/native/` at the root of the checkout (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and a built one reused. Nothing is written into `native/`: the library
there belongs to the JAX binding. Exposes `NativeMelStream`, API-identical
to the numpy `MelStream`. `make_mel_stream()` picks the native
implementation when the library builds and VOX_NATIVE != 0, and the numpy
one otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from voxtral_tpu_torch.audio.mel import (
    MelStream, dft_matrices, hann_window, mel_filters,
)
from voxtral_tpu_torch.audio.wav import resample_linear
from voxtral_tpu_torch.config import AudioConfig

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_REPO_ROOT, "native", "voxaudio.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")   # as the Makefile's

_lock = threading.Lock()
_lib = None
_lib_failed = False


def lib_path() -> str:
    """Where the library built from the current source lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvoxaudio-{h.hexdigest()[:12]}.so")


def _build_if_needed() -> str | None:
    if not os.path.exists(SRC):
        return None
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, path)          # atomic: a reader never sees half a file
    return path


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_if_needed()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.voxmel_create.restype = ctypes.c_void_p
        lib.voxmel_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, ctypes.c_float, ctypes.c_int64]
        lib.voxmel_free.restype = None
        lib.voxmel_free.argtypes = [ctypes.c_void_p]
        lib.voxmel_feed.restype = ctypes.c_int64
        lib.voxmel_feed.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
        for name in ("voxmel_finish", "voxmel_n_frames", "voxmel_frame_offset"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.voxmel_frames.restype = None
        lib.voxmel_frames.argtypes = [ctypes.c_void_p, f32p]
        lib.voxmel_discard_before.restype = None
        lib.voxmel_discard_before.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.voxwav_resample_linear.restype = ctypes.c_int64
        lib.voxwav_resample_linear.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, f32p,
            ctypes.c_int64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return os.environ.get("VOX_NATIVE", "1") != "0" and _load() is not None


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeMelStream:
    """Drop-in replacement for audio.mel.MelStream backed by C++."""

    def __init__(self, left_pad_samples: int, cfg: AudioConfig = AudioConfig()):
        lib = _load()
        if lib is None:
            raise RuntimeError("native voxaudio library unavailable")
        self.cfg = cfg
        self._lib = lib
        hann = np.ascontiguousarray(hann_window(cfg.window_size))
        cosm, sinm = dft_matrices(cfg)
        filt = np.ascontiguousarray(mel_filters(cfg))
        self._h = lib.voxmel_create(
            cfg.window_size, cfg.hop_length, cfg.freq_bins, cfg.mel_bins,
            _fptr(hann), _fptr(np.ascontiguousarray(cosm)),
            _fptr(np.ascontiguousarray(sinm)), _fptr(filt),
            ctypes.c_float(cfg.log_mel_max), left_pad_samples)
        if not self._h:
            raise RuntimeError("voxmel_create failed")
        self.finished = False

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.voxmel_free(h)
            self._h = None

    @property
    def n_frames(self) -> int:
        return int(self._lib.voxmel_n_frames(self._h))

    @property
    def frame_offset(self) -> int:
        return int(self._lib.voxmel_frame_offset(self._h))

    def frames(self) -> np.ndarray:
        n = self.n_frames
        out = np.empty((n, self.cfg.mel_bins), np.float32)
        if n:
            self._lib.voxmel_frames(self._h, _fptr(out))
        return out

    def feed(self, samples: np.ndarray) -> int:
        """Append samples; returns the number of new frames."""
        if self.finished:
            raise RuntimeError("MelStream already finished")
        s = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
        return int(self._lib.voxmel_feed(self._h, _fptr(s), s.size))

    def finish(self) -> int:
        n = int(self._lib.voxmel_finish(self._h))
        self.finished = True
        return n

    def discard_before(self, global_frame: int) -> None:
        self._lib.voxmel_discard_before(self._h, global_frame)


def resample_linear_native(samples: np.ndarray, rate_in: int,
                           rate_out: int) -> np.ndarray:
    lib = _load()
    s = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    if lib is None:
        return resample_linear(s, rate_in, rate_out)
    n_out = int(round(s.size * rate_out / rate_in)) + 8
    out = np.empty(n_out, np.float32)
    n = lib.voxwav_resample_linear(_fptr(s), s.size, rate_in, rate_out,
                                   _fptr(out), n_out)
    if n < 0:
        raise RuntimeError("resample buffer overflow")
    return out[:n]


def make_mel_stream(left_pad_samples: int, cfg: AudioConfig = AudioConfig()):
    """Native if the library builds (VOX_NATIVE=0 forces numpy), else numpy."""
    if native_available():
        return NativeMelStream(left_pad_samples, cfg)
    return MelStream(left_pad_samples, cfg)
