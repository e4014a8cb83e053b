"""Which of K2's design choices hold? K2 (`csrc/w8a16.cu`, the W8A16 GEMV
of the Q8 decode step) is built as committed and as variant copies that
change one choice each: 128-row stages, a ring of 3, 5 or 6 stages, at most
4 splits of K, non-portable clusters of up to 16 splits, and two ablations
that give wrong results on purpose (no stages at all: the launch, the
split merge and the stores alone; the codes used without their
conversion to bf16). Each variant is timed through the wrapper
`ops.q8_matmul.w8a16_gemv` at the decoder's five Q8 shapes at M = 16 and
w1/w3 at M = 1, 32, 38 and 64, over weight copies that exceed the L2
(`_timing.device_ms`: one CUDA graph of `iters` calls between two
events), in `rounds` rounds that visit the variants in turn; every
non-ablation variant is held against the plain version first (bf16: one
ulp plus 1e-5 of max|y|). The result is each variant's median us per case
and its share of the byte bound (codes, scales, x and y once, 3.35 TB/s).

    python -m voxtral_tpu_torch.tools.profile_k2_variants

The variant sources go to `build/k2_variants/` at the root of the
checkout (ignored by git); the wrapper is pointed at each variant's
library and plan constants in turn and restored afterwards. Needs the
card and nvcc.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import statistics
import sys

import torch

from voxtral_tpu_torch import _build
from voxtral_tpu_torch.ops import q8_matmul as qm
from voxtral_tpu_torch.quant import quantize_torch
from voxtral_tpu_torch.tools._timing import copies_beyond_l2, device_info, device_ms, l2_bytes
from voxtral_tpu_torch.utils import resolve_device

HBM_BYTES_PER_S = 3.35e12
SHAPES = {"wq": (3072, 4096), "wk/wv": (3072, 1024), "wo": (4096, 3072),
          "w1/w3": (3072, 9216), "w2": (9216, 3072)}
CASES = [(name, 16) for name in SHAPES] + [("w1/w3", m) for m in (1, 32, 38, 64)]
VARIANT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "k2_variants")

_STAGE_LINE = "constexpr int kStageRows = 64;"
_STAGES_LINE = "constexpr int kStages = 4;"
_SPLITS_LINE = "constexpr int kMaxSplits = 8;"
_SMEM_LINE = "cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<MT>());"
_N_STAGES_LINE = "const int n_stages = (slice_rows + kStageRows - 1) / kStageRows;"
_CONVERT = "int8x4_to_bf16_pairs<0, 1, 2, 3>("
_USING = "using ring_common::from_float;"

# name: (stage rows, stages, most splits, edits of w8a16.cu as (text, its
# replacement, the times the text occurs), checked)
VARIANTS = {
    "committed": (64, 4, 8, [], True),
    "stage128": (128, 4, 8, [(_STAGE_LINE, "constexpr int kStageRows = 128;", 1)], True),
    "stages3": (64, 3, 8, [(_STAGES_LINE, "constexpr int kStages = 3;", 1)], True),
    "stages5": (64, 5, 8, [(_STAGES_LINE, "constexpr int kStages = 5;", 1)], True),
    "stages6": (64, 6, 8, [(_STAGES_LINE, "constexpr int kStages = 6;", 1)], True),
    "split4": (64, 4, 4, [], True),
    "cluster16": (64, 4, 16, [
        (_SPLITS_LINE, "constexpr int kMaxSplits = 16;", 1),
        (_SMEM_LINE, _SMEM_LINE + "\n  if (err == cudaSuccess && SPLIT)\n"
         "    err = cudaFuncSetAttribute(w8a16_mma_kernel<MT, SPLIT>,\n"
         "                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);", 1)],
        True),
    "no_stages": (64, 4, 8, [(_N_STAGES_LINE, "const int n_stages = 0;", 1)], False),
    "no_convert": (64, 4, 8, [
        (_CONVERT, "raw_pairs(", 4),
        (_USING, _USING + "\n__device__ __forceinline__ uint2 raw_pairs(uint32_t w) {\n"
         "  return make_uint2(w, w ^ 0x00400040u);\n}", 1)], False),
}


def variant_sources(root: str = VARIANT_DIR, names=tuple(VARIANTS)) -> dict:
    """Write each variant's copy of `csrc/` under root/<name>/ and return
    {name: that directory}. Each edit's text must occur in the committed
    source as often as it says (raises otherwise), so a variant never
    silently equals the committed kernel."""
    with open(os.path.join(_build.CSRC_DIR, "w8a16.cu")) as f:
        committed = f.read()
    dirs = {}
    for name in names:
        src = committed
        for old, new, times in VARIANTS[name][3]:
            if (n := src.count(old)) != times:
                raise ValueError(f"variant {name}: {old!r} occurs {n} times in w8a16.cu")
            src = src.replace(old, new)
        d = os.path.join(root, name.replace("/", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, "w8a16.cu"), "w") as f:
            f.write(src)
        dirs[name] = d
    return dirs


def _use(csrc: str, stage_rows: int, stages: int, max_splits: int) -> None:
    """Point the wrapper at the library built from `csrc` and at its plan
    constants."""
    _build.CSRC_DIR = csrc
    _build._loaded.pop("w8a16.cu", None)
    qm._lib.cache_clear()
    qm._resident.cache_clear()
    qm._STAGE_ROWS, qm._STAGES, qm._MAX_SPLITS = stage_rows, stages, max_splits


def profile_k2_variants(names=tuple(VARIANTS), rounds: int = 2, *, iters: int = 50,
                        device="cuda") -> dict:
    """Returns {device, power_limit, count, rounds, iters, and per variant v
    and case c ("w1/w3 M16", ...): us_{v}_{c} (median), share_{v}_{c}
    (bound / time)}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_k2_variants builds and times CUDA variants: it needs the card")
    dirs = variant_sources(names=names)
    saved = (_build.CSRC_DIR, qm._STAGE_ROWS, qm._STAGES, qm._MAX_SPLITS)
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for name, m in CASES:
        k, n = SHAPES[name]
        copies = copies_beyond_l2(k * n, l2_bytes(dev), 8)
        ws = [quantize_torch(torch.randn(k, n, generator=g, device=dev) * 0.02)
              for _ in range(copies)]
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        inputs[name, m] = (x, ws, (k * n + 4 * n + 4 * m * k) / HBM_BYTES_PER_S * 1e3)
    times = {(v, c): [] for v in names for c in CASES}
    try:
        jobs = []
        for v in names:                           # one nvcc per variant, all together
            _build.CSRC_DIR = dirs[v]
            path = _build._lib_path("w8a16.cu")
            if not os.path.exists(path):
                jobs.append((v, path, *_build._start("w8a16.cu")))
        for v, path, proc, tmp in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for variant {v}:\n{log.decode(errors='replace')}")
            os.replace(tmp, path)
        for _ in range(rounds):
            for v in names:
                rows, stages, splits, _, checked = VARIANTS[v]
                _use(dirs[v], rows, stages, splits)
                for c in CASES:
                    x, ws, _ = inputs[c]
                    if checked:
                        y = qm.w8a16_gemv(x, ws[0].q, ws[0].s)
                        ref = qm.q8_matmul_plain(x, ws[0].q, ws[0].s).float()
                        mx = ref.abs().max().item()
                        err = (y.float() - ref).abs().max().item()
                        tol = 1e-5 * mx + 2.0 ** (math.floor(math.log2(mx)) - 7)
                        if err > tol:
                            raise RuntimeError(f"variant {v} at {c}: err {err} > tol {tol}")
                    times[v, c].append(device_ms(
                        lambda i: qm.w8a16_gemv(x, ws[i % len(ws)].q, ws[i % len(ws)].s),
                        iters, dev))
    finally:
        _use(saved[0], *saved[1:])
    res = dict(device_info(dev), rounds=rounds, iters=iters)
    for v in names:
        for c in CASES:
            key = f"{v}_{c[0]} M{c[1]}"
            res[f"us_{key}"] = statistics.median(times[v, c]) * 1e3
            res[f"share_{key}"] = inputs[c][2] * 1e3 / res[f"us_{key}"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    res = profile_k2_variants(rounds=args.rounds, device=args.device)
    print(f"K2 variants (median of rounds): {res['device']} (power limit "
          f"{res['power_limit']}), rounds={res['rounds']}, iters={res['iters']}")
    for v in VARIANTS:
        print(f"  {v:11s} " + " | ".join(
            f"{c[0]} M{c[1]} {res[f'us_{v}_{c[0]} M{c[1]}']:.2f} us "
            f"({res[f'share_{v}_{c[0]} M{c[1]}']:.3f})" for c in CASES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
