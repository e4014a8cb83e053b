"""Which of T5's design choices hold? T5 (`attn4_mma_kernel` in
`csrc/layout_attention.cu`, the int4-unpack tool's attention over
nibble-packed rings) is built as committed and as variant copies that
change one choice each: a ring of 2, 4 or 6 stages a warp; stages of one
16-slot tile (4 of them) or of four (2 of them) instead of two; e by
expf instead of ex2.approx; shares of at most 1680 slots (smaller score
rows, 4 blocks an SM, two splits at B 32); the plan of K2 and T3 (the
most splits within one wave) instead of the fewest that cover the SMs;
one split a (stream, head) whatever B (the old kernel's grid); and four
ablations that give wrong results on purpose (no global reads: every
tile zero-filled; the codes used without their conversion to bf16; no
mma.sync: a cheap stand-in that keeps its inputs live; no tiles at all:
the launch, the max exchange and the merge alone). Each variant is timed
through the wrapper `ops.layout_attention.attn4_kernel` at B = 32, 16, 8
and 1 (P = 2088, 8 kv heads, the tool's shape), over ring copies that
exceed the L2 (`_timing.device_ms`: one CUDA graph of `iters` calls
between two events), in `rounds` rounds that visit the variants in turn;
every non-ablation variant is held against the plain version first
(within T5_CHECK_RTOL of max|ref|). The result is each variant's median
us per case and its share of the byte bound (the rings, q and the output
once, 3.35 TB/s).

    python -m voxtral_tpu_torch.tools.profile_t5_variants

The variant sources go to `build/t5_variants/` at the root of the
checkout (ignored by git); the wrapper is pointed at each variant's
library and plan constants in turn and restored afterwards. Needs the
card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import sys

import torch

from voxtral_tpu_torch import _build
from voxtral_tpu_torch.ops import layout_attention as la
from voxtral_tpu_torch.ops._scratch import cluster_splits
from voxtral_tpu_torch.tools._timing import copies_beyond_l2, device_info, device_ms, l2_bytes
from voxtral_tpu_torch.tools.profile_int4_unpack import T5_CHECK_RTOL
from voxtral_tpu_torch.utils import resolve_device

HBM_BYTES_PER_S = 3.35e12
SLOTS, KV_DIM = 2088, 1024
CASES = (32, 16, 8, 1)                            # streams
VARIANT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "t5_variants")

_STAGES_LINE = "constexpr int kT5Stages = 3;"
_SUB_LINE = "constexpr int kT5Sub = 2;"
_SHARE_LINE = "constexpr int kT5MaxShare = 2096;"
_COPY0 = "cp_async16(dst0 + st + s * kT5TileBytes, r > 0 ? p : kb, r > 0 ? 16 : 0);"
_COPY1 = "cp_async16(dst1 + st + s * kT5TileBytes, r > 8 ? p + 8 * stride : kb, r > 8 ? 16 : 0);"
_CONVERT = "nibbles_to_bf16("
_MMA = "mma_bf16("
_EXP = "pb[p] = pack_bf16x2(ex2(fmaf(x.x, kLog2e, -mg)), ex2(fmaf(x.y, kLog2e, -mg)));"
_MINE = "const int mine = warp < n_stages ? (n_stages - warp + kT5Warps - 1) / kT5Warps : 0;"
_HELPERS = "// Grid (splits, kv_heads, B); SPLIT:"
_RAW = ("__device__ __forceinline__ uint2 raw_pairs(uint32_t u) {\n"
        "  return make_uint2(u, u ^ 0x00400040u);\n}\n\n")
_FAKE_MMA = ("__device__ __forceinline__ void fake_mma(float* c, const uint32_t* a, uint32_t b0,\n"
             "                                         uint32_t b1) {\n"
             "  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3F800000u);\n"
             "}\n\n")

# name: (max slots a share, most splits, plan (None: the committed
# `t5_plan`), edits of layout_attention.cu as (text, its replacement, the
# times the text occurs), checked)
VARIANTS = {
    "committed": (2096, 8, None, [], True),
    "stages2": (2096, 8, None, [(_STAGES_LINE, "constexpr int kT5Stages = 2;", 1)], True),
    "stages4": (2096, 8, None, [(_STAGES_LINE, "constexpr int kT5Stages = 4;", 1)], True),
    "stages6": (2096, 8, None, [(_STAGES_LINE, "constexpr int kT5Stages = 6;", 1)], True),
    "tile16": (2096, 8, None, [(_SUB_LINE, "constexpr int kT5Sub = 1;", 1),
                               (_STAGES_LINE, "constexpr int kT5Stages = 4;", 1)], True),
    "tile64": (2096, 8, None, [(_SUB_LINE, "constexpr int kT5Sub = 4;", 1),
                               (_STAGES_LINE, "constexpr int kT5Stages = 2;", 1)], True),
    "expf": (2096, 8, None, [(_EXP, "pb[p] = pack_bf16x2(expf(x.x - sm.m_all[g]), "
                                    "expf(x.y - sm.m_all[g]));", 1)], True),
    "share1680": (1680, 8, None, [(_SHARE_LINE, "constexpr int kT5MaxShare = 1680;", 1)], True),
    "wave": (2096, 8, "wave", [], True),
    "one_split": (2096, 1, None, [], True),
    "no_loads": (2096, 8, None, [(_COPY0, "cp_async16(dst0 + st + s * kT5TileBytes, kb, 0);", 1),
                                 (_COPY1, "cp_async16(dst1 + st + s * kT5TileBytes, kb, 0);", 1)],
                 False),
    "no_convert": (2096, 8, None, [(_CONVERT, "raw_pairs(", 4), (_HELPERS, _RAW + _HELPERS, 1)],
                   False),
    "no_mma": (2096, 8, None, [(_MMA, "fake_mma(", 2), (_HELPERS, _FAKE_MMA + _HELPERS, 1)],
               False),
    "no_tiles": (2096, 8, None, [(_MINE, "const int mine = 0;", 1)], False),
}


def wave_plan(b: int, p: int, kv_heads: int, sms: int, resident) -> tuple[int, int]:
    """K2's and T3's rule, for comparison: the most splits (at most 8)
    whose grid stays within one wave of the resident blocks, and at least
    as many as shares of at most `_T5_MAX_SHARE` slots need."""
    share, splits = cluster_splits(p, b * kv_heads, la._T5_TILE, resident, la._T5_MAX_SPLITS)
    need = -(-p // la._T5_MAX_SHARE)
    if splits < need:
        share = -(-(-(-p // la._T5_TILE)) // need) * la._T5_TILE
        splits = -(-p // share)
    return share, splits


def variant_sources(root: str = VARIANT_DIR, names=tuple(VARIANTS)) -> dict:
    """Write each variant's copy of `csrc/` under root/<name>/ and return
    {name: that directory}. Each edit's text must occur in the committed
    source as often as it says (raises otherwise), so a variant never
    silently equals the committed kernel."""
    with open(os.path.join(_build.CSRC_DIR, "layout_attention.cu")) as f:
        committed = f.read()
    dirs = {}
    for name in names:
        src = committed
        for old, new, times in VARIANTS[name][3]:
            if (n := src.count(old)) != times:
                raise ValueError(f"variant {name}: {old!r} occurs {n} times in "
                                 "layout_attention.cu")
            src = src.replace(old, new)
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, "layout_attention.cu"), "w") as f:
            f.write(src)
        dirs[name] = d
    return dirs


def _use(csrc: str, max_share: int, max_splits: int, plan, resident, committed_plan) -> None:
    """Point the wrapper at the library built from `csrc`, at its plan
    constants and plan, and at its resident blocks on the card."""
    _build.CSRC_DIR = csrc
    _build._loaded.pop("layout_attention.cu", None)
    la._lib.cache_clear()
    resident.cache_clear()
    la._T5_MAX_SHARE, la._T5_MAX_SPLITS = max_share, max_splits
    la.T5_MAX_SLOTS = max_share * max_splits
    la.t5_plan = wave_plan if plan == "wave" else committed_plan


def profile_t5_variants(names=tuple(VARIANTS), rounds: int = 3, *, iters: int = 50,
                        device="cuda") -> dict:
    """Returns {device, power_limit, count, rounds, iters, and per variant v
    and case c ("B32", ...): us_{v}_{c} (median), share_{v}_{c} (bound /
    time)}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("profile_t5_variants builds and times CUDA variants: it needs the card")
    dirs = variant_sources(names=names)
    saved = (_build.CSRC_DIR, la.t5_plan, la._T5_MAX_SHARE, la._T5_MAX_SPLITS, la.T5_MAX_SLOTS)
    resident = la._resident
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for b in CASES:
        ring = b * SLOTS * KV_DIM // 2
        copies = copies_beyond_l2(2 * ring, l2_bytes(dev), 8)
        rings = [tuple(torch.randint(-128, 127, (b, SLOTS, KV_DIM // 2), generator=g, device=dev,
                                     dtype=torch.int8) for _ in range(2)) for _ in range(copies)]
        q = (torch.randn((b, 1, 4 * KV_DIM), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        nbytes = 2 * ring + 2 * 2 * b * 4 * KV_DIM
        inputs[b] = (q, rings, nbytes / HBM_BYTES_PER_S * 1e3)
    times = {(v, b): [] for v in names for b in CASES}
    try:
        jobs = []
        for v in names:                           # one nvcc per variant, all together
            _build.CSRC_DIR = dirs[v]
            path = _build._lib_path("layout_attention.cu")
            if not os.path.exists(path):
                jobs.append((v, path, *_build._start("layout_attention.cu")))
        for v, path, proc, tmp in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for variant {v}:\n{log.decode(errors='replace')}")
            os.replace(tmp, path)
        for _ in range(rounds):
            for v in names:
                share, splits, plan, _, checked = VARIANTS[v]
                _use(dirs[v], share, splits, plan, resident, saved[1])
                for b in CASES:
                    q, rings, _ = inputs[b]
                    if checked:
                        out = la.attn4_kernel(q, *rings[0]).float()
                        ref = la.attn4_plain(q, *rings[0]).float()
                        tol = T5_CHECK_RTOL * ref.abs().max().item()
                        err = (out - ref).abs().max().item()
                        if err > tol:
                            raise RuntimeError(f"variant {v} at B {b}: err {err} > tol {tol}")
                    times[v, b].append(device_ms(
                        lambda i: la.attn4_kernel(q, *rings[i % len(rings)]), iters, dev))
    finally:
        _build.CSRC_DIR = saved[0]
        _build._loaded.pop("layout_attention.cu", None)
        la._lib.cache_clear()
        resident.cache_clear()
        la.t5_plan, la._T5_MAX_SHARE, la._T5_MAX_SPLITS, la.T5_MAX_SLOTS = saved[1:]
    res = dict(device_info(dev), rounds=rounds, iters=iters)
    for v in names:
        for b in CASES:
            res[f"us_{v}_B{b}"] = statistics.median(times[v, b]) * 1e3
            res[f"share_{v}_B{b}"] = inputs[b][2] * 1e3 / res[f"us_{v}_B{b}"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    res = profile_t5_variants(rounds=args.rounds, device=args.device)
    print(f"T5 variants (median of rounds): {res['device']} (power limit "
          f"{res['power_limit']}), rounds={res['rounds']}, iters={res['iters']}")
    for v in VARIANTS:
        print(f"  {v:10s} " + " | ".join(
            f"B{b} {res[f'us_{v}_B{b}']:.2f} us ({res[f'share_{v}_B{b}']:.3f})" for b in CASES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
