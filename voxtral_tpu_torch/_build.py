"""Build and load the port's CUDA kernels.

Each source under `voxtral_tpu_torch/csrc/` is compiled with nvcc for
`sm_90a` into a shared library with a plain `extern "C"` launcher, loaded
with ctypes (no PyTorch headers, so a build takes seconds). Libraries go to
`build/kernels/` at the root of the checkout (listed in .gitignore), named
by a hash of the source, the shared headers and the flags, so an edited
source or header is rebuilt and a built one is reused. Building happens at
first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("ring_attention.cu", "ring_attention_enc.cu", "w8a16.cu",
           "logits_argmax.cu", "read_ceiling.cu", "bf16_matmul.cu", "layout_attention.cu",
           "ring_layout.cu", "rms_norm.cu")
HEADERS = ("ring_common.cuh", "mma_common.cuh")   # included by the sources

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _lib_path(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:12]}.so")


def _start(source: str) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), tmp


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source that has no library yet, one nvcc per source,
    all started together. Returns {source: library path}; raises with the
    compiler's output if a build fails."""
    paths = {s: _lib_path(s) for s in sources}
    t0 = time.perf_counter()
    jobs = {s: _start(s) for s, p in paths.items() if not os.path.exists(p)}
    errors = []
    for s, (proc, tmp) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {s}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[s])      # atomic: a reader never sees half a file
            build_seconds[s] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The ctypes library built from `source` (building it if needed)."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(build_all((source,))[source])
    return _loaded[source]
