#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. Device and build: the card's name and power limit; nvcc builds every
     kernel source of the port in this checkout (build/kernels/), one nvcc
     per source, all started together.
  1. Each kernel against its plain PyTorch version, with its time, the plain
     version's time, a library yardstick's time and the least time the card
     could take (bytes or operations): K1 (float decode rings) at the
     offline decoder's shapes and at the fleet decoder's; K1-int8 (int8
     decode rings with scales) at the fleet decoder's shapes; K1-enc
     (encoder regime: float, int8 and int4 rings) at the fleet encoder's
     shapes. Every case has a wrapped slot table and a fully masked query
     row, and an all-masked call must return zeros. K2 (W8A16 GEMV) at the
     decoder's five Q8 matrix shapes, M = 1, 16, 32, 38 (the prefill) and
     64, f32 and bf16 (bf16 timed at M 1 and 16, and at M 32 and 38 for
     w1/w3), at their slices on 2 tensor-parallel ranks and at ragged K
     and N, each checked for two bit-identical launches, with
     torch._weight_int8pack_mm as its yardstick; K3 (fused tied logits +
     argmax) in argmax and logits mode on int8 and bf16 tables at B = 1
     and 16, an f32 table, f32 queries, and constructed ties (the first
     index wins).
     The new code's edges, checked: K1-int8 and K1 (float rings) at nv =
     58 and 1000, Sx = 0 and 256, group 8, hd 64 with group 8, f32, and K1
     with a bf16 group of 16 (the CUDA cores, by the plan); K1-enc at S =
     17 and 100, more rows than a pass, Sx = 0, nv = 65, split grids at B
     = 1 and 2; K3 at B = 5 and 9, V = 4096 + 37. Every ring row also
     checks that a second launch gives the same bits. Timed rows log their
     bound share (bound / time) and their time over the library call's.
     The tools' kernels at the tools' shapes: T1 (wread) at the decoder's
     Q8 matrices and T11 (rd) at [16, 2088, 1024] rings, bit for bit; T2
     (pure_stream) at the five merged bf16 tensors, whose per-block word
     sums must add up to the tensor's (every byte read) and whose time must
     grow with the bytes; T3 (bf16_matmul) at the same tensors, B = 24,
     within 1e-4 of max|y|, two launches bit-identical; M = 1, 16, 17 and
     64, ragged K and N checked. T4 (attn8, int8 rings)
     and T5 (attn4, nibble-packed rings) at B = 32, P = 2088; T6 (attn3d)
     and T7 (attn4d, block-major rings) at B = 16, P = 2088, blk 256, 512
     and 1024, with the tool's positions and with masked slots and a fully
     masked stream (exact zeros), T6 == T7 bit for bit; P = 77 and B = 1
     checked; T5's edges (P = 1, P = 15, B = 1 at P = 2088, one kv head,
     two splits at B = 16, B = 64 at P = 1500, the largest P at B = 1 and
     64), each with two bit-identical launches; all within two bf16 ulps
     of max|out|. T8 (rd_flat, blk 512),
     T9 (rd_blockmajor, blk 256, 512) and T10 (rd_g, (G, blk) (4, 256),
     (8, 256), (4, 512)) at B = 32, P = 2088, bit for bit, ragged shapes
     checked and B % G != 0 refused. K1-tp: K1, K1-int8 (m = 2 and 8 ranks)
     and K1-enc (int4 and int8 rings, m = 2) on each rank's head slice,
     and the whole call, against the plain version, and each slice
     against the same lanes of the whole call, at the fleet shapes. K4
     (rms_norm) at the decoder's [1, 3072] and [16, 3072] and the encoder
     chunk's [1280, 1280], f32 and bf16, timed beside F.rms_norm, two
     launches bit for bit; its fused entry (add_rms_norm: residual add,
     norm, ada scale) at the same shapes with and without the scale, equal
     bit for bit in both outputs to the unfused chain on the card (torch
     add, K4, torch mul), timed beside that chain and the library chain
     (torch add, F.rms_norm, torch mul); a row's bits equal in calls of 1,
     8 and 16 rows and of all 1280, at both widths and dtypes, for K4 and
     for both outputs of the fused entry; a bf16 weight, 3-D, strided and
     misaligned x, odd widths (the scalar path), rows of four vectors a
     thread and no rows, for both.
  2. Offline, reduced depth (2 encoder + 2 decoder layers), full 4B width,
     f32: transcribe_tokens_batch on cuda (kernels) and on cpu (plain
     versions) must give equal tokens and best logits, with float weights
     and with Q8 weights (quantize_params: K2 and K3 on the card).
  3. Offline serving at full 4B width and depth in bf16: three requests
     (about 3 s, 8 s and 10 s of audio), once eager (step_graphs=False) and
     twice through the weights' cached DecodeGraphs (runtime/step_graph.py:
     the prefill and each decode call's bucket captured as CUDA graphs at
     their second call and replayed); each graph pass must equal the eager
     pass bit for bit in tokens and best logits, and K1's launch count must
     equal 26 x the decode steps run (each call padded to its bucket).
     Logged per request: ms per decode step, RTF, the keys captured and
     their capture seconds, peak memory; the resident decode state; one
     more replayed 3 s request under torch.profiler (its kernels and its
     busy share of the replayed wall).
  4. The fleet step, reduced depth (2+2 layers), full width, f32, B = 2, in
     the three ring modes (float; int8; int8 decoder + int4 encoder) and
     the Q8 mode (Q8 weights with int8 + int4 rings): a bootstrap and 4
     masked steps (one with stream 1 inactive, one forced token, an f32
     wire and an s16 wire) on cuda and on cpu. Tokens must be equal
     (quantized rings: unless the cpu run's top-2 logit gap at the first
     differing step is below 1e-2); in float mode stream 0's tokens must
     equal transcribe_tokens_batch's on the same clip.
  5. The fleet step at full 4B width and depth in bf16: B = 16 streams of
     different clips, 160-mel chunks (20 tokens per step), dec_ring 2048,
     enc_ring 840, each mode (the Q8 mode from quantize_params of the bf16
     tree, last): bootstrap, 5 steps, one step on an aged state (both rings
     read whole), run twice: run 0 eager, run 1 through the step graphs
     (runtime/step_graph.py: its first step eager, the second captured as
     a CUDA graph, the rest replayed). The runs' tokens and every state
     tensor (rings, scales, slot tables, tails, cursors) must be equal bit
     for bit, with every kernel's launches (and the Q8 large-M route's
     calls) checked per step, a replay counting the launches its graph
     makes (K4: one rms_norm and 52 add_rms_norm a token, one and 64 an
     encoder chunk). One more step on each run's aged state is profiled
     (eager on run 0's, replayed on run 1's): its kernels' ms and
     launches, torch's elementwise kernels among them, and its busy share
     of that run's aged step wall.
  6. The tools path: the six ported profile tools at their defaults
     (voxtral_tpu_torch.tools: the Q8 roofline through K2, T1 and K3; the
     bf16 weight stream through torch.matmul, T2 and T3; the ring read
     ceiling through T11; the int4 unpack through T4 and T5, with its
     numeric check; the ring-layout attention through T6 and T7; the
     ring-layout read through T8, T9 and T10), every launch count checked,
     their GB/s and the ratios T5 / T4, T7 / T6, T9 / T8 and T10 / T9
     logged.
  7. Tensor parallelism on the card: two spawned ranks (gloo on CUDA
     tensors, both on cuda:0; parallel.launch.run_ranks with a timeout),
     full 4B width, 2 + 2 layers, B = 8, heads and vocab split in two: a
     bootstrap and 3 masked steps in f32 on float rings and on Q8 weights
     with int8 + int4 rings, where every rank's tokens must equal the same
     drive on one process, and in bf16 on float rings, held to a share of
     equal tokens and to the rings' distance from one process (TP_BF16_*);
     each rank must launch its decode ring kernel,
     K1-enc, K3, K4 and, on Q8 weights, K2 (their sum over ranks of the ring
     kernels is K1-tp's launches).
  8. The serving runtime, FleetManager, on the card (runtime/manager.py),
     replaying the step as CUDA graphs (its default on the card) but in
     8b's eager run.
     8a: full width, 2 + 2 layers, f32, B = 4, chunk 8 tokens, dec_ring
     256, on float rings and on Q8 weights with int8 + int4 rings: two
     streams with a third attached after the first poll, the same with
     pipeline_steps = 2 and over the s16 wire (s16-exact audio: the same
     tokens on the card), each stream alone, and a finished non-continuous
     stream. Every stream's all_ids on cuda must equal a cpu manager's
     (quantized rings: unless the cpu top-2 logit gap at the first
     difference is below 1e-2, phase 4's rule); in float mode a stream
     alone must equal itself in the fleet and the finished stream
     transcribe_tokens_batch. 8b: full 4B width and depth, bf16, Q8
     weights with int8 + int4 rings, B = 16, chunk 20 tokens, dec_ring 2048:
     sixteen clips of 4-12 s (four attached after the first poll) fed in
     1 s pieces, finished and drained, three times: step graphs with
     pipeline_steps = 1, the eager step (step_graphs=False) with 1, and
     step graphs with 2; every stream must finish, every stream of both
     graph runs must equal the eager run's, and each run launches K1-int8,
     K1-enc, K2, K3 and K4. Logged: audio-s/s through the manager, steps,
     the poll wall beside stats()'s step_ms_total (the host share), the
     mean step wall beside phase 5's direct step (eager or replayed), peak
     memory, and the device busy share of a one-step poll (profiled in the
     third run, over the first run's wall of it). 8c: token latency
     (bench.py's serving latency): B = 1, chunk 6 tokens, int8 rings,
     n_alt 2, max_steps_per_poll 1, step graphs; p50/p95 per poll over 50
     feeds after 12 warm-up feeds, with pipeline_steps 1 and 2: each p95
     must be under 480 ms (the chunk).
  9. The single-stream engine VoxStream, transcribe_audio and the CLI on
     the card (runtime/stream.py, __init__.py, cli.py). 9a: full width,
     2 + 2 layers, f32, one 3 s clip fed in 1 s pieces: the bucketed
     backend (replaying graphs on cuda), the fused backend on float rings and
     the fused backend on Q8 weights with int8 + int4 rings, each on cuda
     against cpu (quantized
     rings: phase 4's top-2 gap rule); in float mode fused == bucketed ==
     transcribe_tokens_batch, a mid-stream set_interval on fused == the
     batch pipeline, and a mid-stream flush() on fused == bucketed given
     the fused flush's 40 more samples of silence (the JAX package's
     behaviour: it pads the skewed PCM buffer); the bucketed stream's mel is
     the native binding, within 2e-4 of the numpy MelStream. 9b: full 4B
     width and depth, bf16, seed-0 weights, one 12 s clip (a 16-bit WAV,
     read back) through transcribe_audio (auto: fused on float rings), the
     bucketed backend eager (step_graphs=False) and replaying its bucket
     programs as CUDA graphs (the default), and the fused backend on phase
     8b's Q8 tree with int8 + int4 rings, each twice with identical tokens
     and its kernels' launches checked (bucketed and auto: K1, K1-enc, K3,
     K4; Q8: K1-int8, K1-enc, K2, K3, K4); the graph bucketed runs must
     equal the eager ones bit for bit in tokens and launches; the fused
     backends (B = 1 FleetManagers) replay step graphs; logged: RTF, ms per
     generated token, each feed's wall, the captures' seconds, peak memory
     and the device busy share of a profiled 1 s feed that steps. 9c: `python3 -m
     voxtral_tpu_torch.cli --random-init 0 --silent` as two subprocesses,
     `-i` the WAV and `--stdin` with its bytes: exit 0, and stdout is 9b's
     transcribe_audio text.
 10. Multi-process data parallelism through FleetManager(tp=), eager (a
     step under tp runs gloo collectives through the host, so it is not
     captured), ranks
     spawned by parallel.launch.run_ranks on cuda:0 (gloo), each building
     the seed-0 weights on the card. 10a: full width, 2 + 2 layers, f32,
     chunk 8 tokens, dec_ring 256, float rings and Q8 weights with int8 +
     int4 rings: data 2 x model 1 (global B 4) runs the JAX multihost
     worker's basic flow and its asymmetric churn (rank 0 churns a slot
     while rank 1 keeps feeding) with pipeline_steps 1 and 2; data 2 x
     model 2 (global B 2, four ranks) runs tests/test_manager.py's meshed
     flow and slot churn; the flows and their audio are the CPU tests'
     own. Every stream against one process on the card
     (float rings: equal; quantized: phase 4's gap rule); the rows
     partitioned disjointly and completely, equal step counts on every
     rank, and each rank launches its decode ring kernel, K1-enc, K3, K4 and,
     on Q8 weights, K2 (the model-2 ranks' ring launches are K1-tp's).
     10b: full 4B width and depth, bf16, 8b's Q8 + int8 + int4 serving
     default, data 2 x model 1, 8 streams a rank: 8b's 16 clips on 8b's
     schedule (the four late ones on rank 1), with pipeline_steps 1 and 2;
     the two runs' tokens identical; the mirror run (16 streams a rank, so
     every call holds 8b's rows) equal to 8b's run 0 on every stream, in
     8b's steps; a probe on rank 0 finds no op that rounds a row apart at
     8 rows a call against 16, and every stream of both ranks' first run
     equals 8b's run 0 (each rank's share, at least TP_BF16_AGREE, and each
     stream's logged), equal step counts (8b's run 0 replays step graphs,
     so these gates also hold eager ranks against graph replays);
     logged beside
     8b's one process: aggregate audio-s/s, per-rank steps, step ms, host
     share and peak memory (no claim: the two ranks time-slice one card).
The next-to-last lines are the card's name/power limit and one JSON object
with each kernel's numbers; the last line is the run's result as JSON. The
whole run, the kernels' build included, is meant to take at most 900 s on
one H100 (the `[done]` line).
Weights are random (seeded): tokens are meaningless but deterministic.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from voxtral_tpu_torch.tools.profile_fleet_step import (BOOT_MEL, CHUNK_MEL, RING_MODES,
                                                        STREAMS, device_rows, fleet_streams,
                                                        init_state, kernel_groups,
                                                        profile_step, synthetic_audio)

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"torch.float32": 67e12,           # CUDA cores, no tensor cores
              "torch.bfloat16": 989e12}         # dense tensor-core rate
DEC = dict(heads=32, kv_heads=8, head_dim=128, window=8192)
P_RING, SX = 8320, 64                           # 8192 + 64 ring + Np margin
SLOT_INVALID = -(1 << 30)
# The fleet's shapes at chunk 160 mel, dec_ring 2048, enc_ring 840: decoder
# rings of 2080 physical slots with 20 extra columns (the chunk's tokens);
# encoder rings of 928 slots, 80 queries and 80 extra columns per stream.
FLEET_DEC = dict(heads=32, kv_heads=8, head_dim=128, window=8192, p=2080, sx=20,
                 s=1)
FLEET_ENC = dict(heads=32, kv_heads=32, head_dim=64, window=750, p=928, sx=80,
                 s=80)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Device time per call of fn(i): `iters` calls captured in one CUDA
    graph, replayed between two events, so host-side launch overhead does
    not enter the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up outside capture
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 0
# ---------------------------------------------------------------------------

def phase0():
    import torch
    from voxtral_tpu_torch import _build
    log(f"[0] {smi_line()}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[0] built {sorted(paths)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc per source: {_build.build_seconds})")


# ---------------------------------------------------------------------------
# Phase 1: each ring attention kernel against its plain version
# ---------------------------------------------------------------------------

def _l2_copies(nbytes):
    """Copies of an input of `nbytes` for a timing loop to cycle through:
    the tools' rule (at least 4x the card's L2 in distinct bytes), at most
    8 copies."""
    import torch
    from voxtral_tpu_torch.tools._timing import copies_beyond_l2, l2_bytes
    return copies_beyond_l2(nbytes, l2_bytes(torch.device("cuda")), 8)


def _ring_case(b, nv, dtype, seed, copies, p=P_RING, sx=SX, heads=DEC["heads"],
               kv_heads=DEC["kv_heads"], head_dim=DEC["head_dim"]):
    """Float-ring decode inputs (the offline decoder's shapes by default).
    nv < p: the ring is filled as a prefix (the last 10 slots below nv still
    invalid); nv == p: a wrapped slot table whose oldest slots fall out of
    the window. A third of the sx extra columns are valid. With B > 1,
    stream 1 has an invalid query position: a fully masked row."""
    import torch
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    kv_dim = kv_heads * head_dim

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(dtype)

    j = torch.arange(p, device=dev)
    if nv < p:
        sp = torch.where(j < nv - 10, j, SLOT_INVALID)
        last = nv - 11
    else:
        last = 3 * (p - 64) + 123
        sp = last - torch.remainder(last - j, p)
    sp = sp.to(torch.int32)[None].repeat(b, 1).contiguous()
    n_x = sx // 3
    q_pos = torch.full((b, 1), last + n_x, dtype=torch.int32, device=dev)
    if b > 1:
        q_pos[1] = SLOT_INVALID
    xp = torch.full((b, sx), SLOT_INVALID, dtype=torch.int32, device=dev)
    xp[:, :n_x] = last + 1 + torch.arange(n_x, device=dev, dtype=torch.int32)
    return dict(
        q=rnd(b, 1, heads * head_dim),
        rings=[(rnd(b, p, kv_dim), rnd(b, p, kv_dim), None, None) for _ in range(copies)],
        sp=sp, q_pos=q_pos, xk=rnd(b, sx, kv_dim), xv=rnd(b, sx, kv_dim), xp=xp,
        nv=torch.tensor(nv, dtype=torch.int32, device=dev), ring="float",
        kw=dict(window=DEC["window"], heads=heads, kv_heads=kv_heads,
                head_dim=head_dim))


def _fleet_case(shape, ring, b, nv, dtype, seed, copies):
    """Inputs of one ring attention call at `shape` (FLEET_DEC or FLEET_ENC).
    ring: "float", "int8" or "int4" (codes from the port's quantizers). The
    slots below nv hold a ring of nv slots that has wrapped (two of them
    invalid); slots at or past nv are invalid. Query rows sit just past the
    ring's last position. Fully masked rows: stream 1's query (decode, B >
    1), or the last query row of every stream (encoder). With B > 1 stream
    1's extra columns are all invalid (an inactive stream)."""
    import torch
    from voxtral_tpu_torch.quant import quantize_kv, quantize_kv_int4
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    p, sx, s = shape["p"], shape["sx"], shape["s"]
    hkv, hd = shape["kv_heads"], shape["head_dim"]
    kv_dim = hkv * hd

    def rnd(*sh):
        return (torch.randn(sh, generator=g, device=dev) * 0.5).to(dtype)

    def ring_pair():
        k, v = rnd(b, p, kv_dim), rnd(b, p, kv_dim)
        if ring == "float":
            return k, v, None, None
        qf = quantize_kv_int4 if ring == "int4" else quantize_kv
        (kq, ks), (vq, vs) = qf(k, hkv, hd), qf(v, hkv, hd)
        return kq, vq, ks, vs

    last = 3 * nv + 17
    j = torch.arange(p, device=dev)
    sp = torch.where(j < nv, last - torch.remainder(last - j, nv), SLOT_INVALID)
    sp[3] = sp[nv // 2] = SLOT_INVALID
    sp = sp.to(torch.int32)[None].repeat(b, 1).contiguous()
    n_x = sx // 3 if s == 1 else sx
    if s == 1:                                 # decode: stream 1 is masked
        q_pos = torch.full((b, 1), last + 1 + n_x, dtype=torch.int32, device=dev)
        q_pos[1:2] = SLOT_INVALID
    else:                                      # encoder: the last row is
        rows = torch.arange(s, device=dev, dtype=torch.int32)
        q_pos = (last + 1 + rows)[None].repeat(b, 1).contiguous()
        q_pos[:, -1] = SLOT_INVALID
    xp = torch.full((b, sx), SLOT_INVALID, dtype=torch.int32, device=dev)
    xp[:, :n_x] = last + 1 + torch.arange(n_x, device=dev, dtype=torch.int32)
    if b > 1:
        xp[1] = SLOT_INVALID
    return dict(
        q=rnd(b, s, shape["heads"] * hd), rings=[ring_pair() for _ in range(copies)],
        sp=sp, q_pos=q_pos, xk=rnd(b, sx, kv_dim), xv=rnd(b, sx, kv_dim), xp=xp,
        nv=torch.tensor(nv, dtype=torch.int32, device=dev), ring=ring,
        kw=dict(window=shape["window"], heads=shape["heads"], kv_heads=hkv,
                head_dim=hd))


def _ring_call(fn, c, i=0, q_pos=None):
    k, v, ks, vs = c["rings"][i % len(c["rings"])]
    return fn(c["q"], k, v, c["sp"], c["q_pos"] if q_pos is None else q_pos,
              **c["kw"], k_scale=ks, v_scale=vs, extra_k=c["xk"], extra_v=c["xv"],
              extra_pos=c["xp"], n_valid_slots=c["nv"])


def _ring_check(c, dtype, what, kernel):
    """Kernel against the plain version; returns (max abs error, tol).
    Tolerance: f32 1e-5 (same arithmetic, another summation order); bf16
    2e-2 of max|out| (probabilities are rounded to bf16 against a split's
    or a running max in the kernels, against the global max in the plain
    version). Also: the call went through `kernel`, a second launch gives
    the same bits, the rows with an invalid query position are zero, and so
    is every row when all positions are invalid."""
    import torch
    from voxtral_tpu_torch.ops import ring_attention as ra
    before = dict(ra.LAUNCHES)
    out = _ring_call(ra.ring_gqa_attention, c)
    out2 = _ring_call(ra.ring_gqa_attention, c)
    ref = _ring_call(ra.ring_gqa_attention_reference, c)
    dead = _ring_call(ra.ring_gqa_attention, c,
                      q_pos=torch.full_like(c["q_pos"], SLOT_INVALID))
    torch.cuda.synchronize()
    check(ra.LAUNCHES[kernel] == before[kernel] + 3,
          f"{what}: the call did not go through {kernel}")
    check(torch.equal(out, out2), f"{what}: two launches differ")
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()
    check(torch.isfinite(out).all().item(), f"{what}: non-finite kernel output")
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    masked = c["q_pos"] == SLOT_INVALID
    check(out[masked].abs().max().item() == 0.0 if masked.any() else True,
          f"{what}: masked row is not zero")
    check(dead.abs().max().item() == 0.0, f"{what}: all-masked call is not zero")
    return err, tol


def _bound(nbytes, flops, dtype):
    """(bytes_ms, ops_ms, bound_ms, "bytes" or "operations"): the bytes over
    3.35 TB/s, the operations over the peak rate of `dtype`'s products, and
    the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return t_bytes, t_ops, *((t_bytes, "bytes") if t_bytes >= t_ops
                             else (t_ops, "operations"))


def _ring_bound(c, dtype):
    """(bytes_ms, ops_ms, ms, "bytes" or "operations") from case `c`'s own
    inputs. Bytes: q in and out, the positions that decide validity (ring
    slots below nv, extra columns, queries, nv), and K/V (codes and scales
    for int8/int4 rings) only for the ring slots and extra columns that some
    query row of the stream can see (0 <= pos <= q_pos, pos >= q_pos -
    (window - 1)); a stream whose query positions are all invalid needs
    none. Operations: q.k and p.v (4 flops per head lane) for each (query
    row, column) pair that passes the mask, at the rate of q's dtype (the
    products' operand dtype)."""
    kw = c["kw"]
    elt = dtype.itemsize
    kv_dim = kw["kv_heads"] * kw["head_dim"]
    b, s, qd = c["q"].shape
    sx = c["xp"].shape[1]
    nv = int(c["nv"].item())
    qp = c["q_pos"].long()[:, :, None]                   # [B, S, 1]

    def seen(pos):                                       # [B, T] -> [B, S, T]
        pos = pos.long()[:, None, :]
        return (pos >= 0) & (pos <= qp) & (pos >= qp - (kw["window"] - 1))

    m_ring, m_x = seen(c["sp"][:, :nv]), seen(c["xp"])
    ring_row = {"float": kv_dim * elt, "int8": kv_dim, "int4": kv_dim // 2}[c["ring"]]
    if c["ring"] != "float":
        ring_row += 4 * kw["kv_heads"]                   # the slot's scales
    nbytes = (2 * b * s * qd * elt
              + 2 * int(m_ring.any(1).sum()) * ring_row
              + 2 * int(m_x.any(1).sum()) * kv_dim * elt
              + 4 * (b * (nv + sx + s) + 1))
    flops = 4 * qd * int(m_ring.sum() + m_x.sum())
    return _bound(nbytes, flops, dtype)


def _ring_sdpa(c, i):
    """Yardstick: one F.scaled_dot_product_attention call over the ring
    (dequantized beforehand, untimed) plus the extra columns, with a boolean
    mask. The port never calls it."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.quant import unpack_int4
    kw = c["kw"]
    hkv, hd, h = kw["kv_heads"], kw["head_dim"], kw["heads"]
    b, s, _ = c["q"].shape
    p = c["sp"].shape[1]
    nv = int(c["nv"].item())
    dt = c["q"].dtype

    def deq(r, sc):
        if sc is None:
            return r
        if c["ring"] == "int4":
            r = torch.cat(unpack_int4(r.view(b, p, hkv, hd // 2)), -1).view(b, p, -1)
        return (r.float().view(b, p, hkv, hd) * sc.transpose(1, 2)[..., None]).to(dt)

    def heads(x):
        return x.reshape(b, -1, hkv, hd).transpose(1, 2).contiguous()

    k, v, ks, vs = c["rings"][i]
    kk = heads(torch.cat([deq(k, ks).reshape(b, p, -1), c["xk"]], 1))
    vv = heads(torch.cat([deq(v, vs).reshape(b, p, -1), c["xv"]], 1))
    qp = c["q_pos"][:, :, None]
    pos = torch.cat([c["sp"], c["xp"]], 1)[:, None, :]
    live = torch.cat([torch.arange(p, device="cuda") < nv,
                      torch.ones(c["xp"].shape[1], dtype=torch.bool, device="cuda")])
    mask = ((pos >= 0) & (pos <= qp) & (pos >= qp - (kw["window"] - 1)) & live)[:, None]
    qs = c["q"].view(b, s, h, hd).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                                  enable_gqa=h != hkv)


def _ring_row(c, dtype, what, kernel, timed):
    """Check case `c` through `kernel` (_ring_check). If `timed`, add the
    kernel's time, the plain version's, the SDPA yardstick's (each over the
    case's ring copies, CUDA-graph timed) and the bound. Returns the row."""
    from voxtral_tpu_torch.ops import ring_attention as ra
    err, tol = _ring_check(c, dtype, what, kernel)
    row = dict(kernel=kernel, ring=c["ring"], b=c["q"].shape[0], nv=int(c["nv"].item()),
               dtype=str(dtype), max_abs_err=err, tol=tol)
    if timed:
        copies = len(c["rings"])
        bytes_ms, ops_ms, bound_ms, bound_by = _ring_bound(c, dtype)
        sdpa = [_ring_sdpa(c, i) for i in range(copies)]
        row.update(
            ms=cuda_ms(lambda i: _ring_call(ra.ring_gqa_attention, c, i), 50),
            plain_ms=cuda_ms(lambda i: _ring_call(ra.ring_gqa_attention_reference, c, i), 5),
            library_ms=cuda_ms(lambda i: sdpa[i % copies](), 20),
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        _shares(row)
        del sdpa
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _shares(row):
    """A timed row's bound share (bound / time) and its time over the
    library call's (None where no single call computes the function)."""
    row.update(bound_share=row["bound_ms"] / row["ms"],
               vs_library=None if row["library_ms"] is None
               else row["ms"] / row["library_ms"])


def phase1():
    """K1 at the offline decoder's shapes (B in {1, 8}, nv in {102, 2048,
    8320}, f32 and bf16, each timed), after a check of its other head dim
    (hd 64 with group 8: two blocks of query heads per kv head). Returns
    the rows."""
    import torch
    k1 = "ring_gqa_attention"
    rows = []
    shape = dict(p=320, sx=9, heads=16, kv_heads=2, head_dim=64)
    for nv in (50, shape["p"]):
        for dtype in (torch.float32, torch.bfloat16):
            c = _ring_case(3, nv, dtype, seed=nv, copies=1, **shape)
            rows.append(_ring_row(c, dtype, f"K1 {shape} nv={nv} {dtype}", k1, False))
    timed = 0
    for b in (1, 8):
        for nv in (102, 2048, P_RING):
            for dtype in (torch.float32, torch.bfloat16):
                copies = _l2_copies(2 * b * P_RING * 1024 * dtype.itemsize)
                c = _ring_case(b, nv, dtype, seed=timed, copies=copies)
                rows.append(_ring_row(c, dtype, f"K1 B={b} nv={nv} {dtype}", k1, True))
                timed += 1
                del c
    return rows


def phase1_fleet():
    """At the fleet decoder's shapes (B in {1, 16}, nv in {58, 2080}; 58 is
    the first step after the 38-position prefill): K1 (float rings) and
    K1-int8. At the fleet encoder's shapes (B in {1, 16}, S = 80, nv in
    {80, 928}): K1-enc with float, int8 and int4 rings. Each in f32 and
    bf16; the bf16 cases are timed. Returns the rows."""
    import torch
    plan = [(kernel, FLEET_DEC, ring, nvs)
            for kernel, ring in (("ring_gqa_attention", "float"),
                                 ("ring_gqa_attention_int8", "int8"))
            for nvs in (58, 2080)]
    plan += [("ring_gqa_attention_enc", FLEET_ENC, ring, nvs)
             for ring in ("float", "int8", "int4") for nvs in (80, 928)]
    rows = []
    seed = 100
    for kernel, shape, ring, nv in plan:
        for b in (1, 16):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                timed = dtype == torch.bfloat16
                kv_dim = shape["kv_heads"] * shape["head_dim"]
                row_bytes = {"float": kv_dim * dtype.itemsize, "int8": kv_dim,
                             "int4": kv_dim // 2}[ring]
                copies = _l2_copies(2 * b * shape["p"] * row_bytes) if timed else 1
                c = _fleet_case(shape, ring, b, nv, dtype, seed, copies)
                rows.append(_ring_row(c, dtype, f"{kernel} {ring} B={b} nv={nv} {dtype}",
                                      kernel, timed))
                del c
    return rows


def phase1_dec_edges():
    """Checked (untimed) edges of the decode kernels, K1-int8 on int8 rings
    and K1 on float rings, against their plain versions at the usual
    tolerances (each row also checks the masked stream, a second launch's
    bits and an all-masked call). bf16 (tensor cores) at the fleet
    decoder's shapes: nv 58 (the first step after prefill) at B 5; nv 1000
    (neither a multiple of the 16-slot tile nor of the 256-slot split) at
    B 5; Sx 0 at B 16 (nv 2080) and at B 1 (nv 37); Sx 256 (the extra
    columns fill a split); group 8 (32 query heads over 4 kv heads: every
    column of the n-tile); hd 64 with group 8 at nv 300 and 50. f32 (CUDA
    cores) at nv 1000. Float rings only: a bf16 group of 16 (32 query heads
    over 2 kv heads), which the plan sends to the CUDA cores. Returns the
    rows."""
    import torch
    dec = FLEET_DEC
    hd64 = dict(dec, heads=16, kv_heads=2, head_dim=64, p=320, sx=9)
    edges = [("nv=58", dec, 5, 58, torch.bfloat16), ("nv=1000", dec, 5, 1000, torch.bfloat16),
             ("Sx=0", dict(dec, sx=0), 16, 2080, torch.bfloat16),
             ("Sx=0 nv=37", dict(dec, sx=0), 1, 37, torch.bfloat16),
             ("Sx=256", dict(dec, sx=256), 5, 300, torch.bfloat16),
             ("group 8", dict(dec, kv_heads=4), 2, 500, torch.bfloat16),
             ("hd 64 group 8", hd64, 3, 300, torch.bfloat16),
             ("hd 64 group 8 nv=50", hd64, 3, 50, torch.bfloat16),
             ("nv=1000 f32", dec, 5, 1000, torch.float32)]
    rows = []
    for ring, k, seed in (("int8", "ring_gqa_attention_int8", 900),
                          ("float", "ring_gqa_attention", 950)):
        more = [("group 16", dict(dec, kv_heads=2), 2, 500, torch.bfloat16)] \
            if ring == "float" else []
        for i, (label, shape, b, nv, dtype) in enumerate(edges + more):
            c = _fleet_case(shape, ring, b, nv, dtype, seed + i, 1)
            rows.append(_ring_row(c, dtype, f"{k} edge {label} B={b} nv={nv} {dtype}", k,
                                  False))
    return rows


def phase1_edges():
    """Checked (untimed) edges of the K1-enc and K3 kernels, against their
    plain versions at the usual tolerances. K1-enc, each ring kind, bf16
    (tensor cores, 80 query rows a pass): S = 17 and S = 100 (ragged warps;
    100 rows take two passes over the tiles), S = 100 with two query heads
    per kv head (200 rows, three passes), Sx = 0, nv = 65 (a ragged last
    tile), each at B = 5 (one block per stream and kv head), and the split
    grid at B = 1 and 2; f32 (CUDA cores) at S = 17 and Sx = 0. K3, int8
    and bf16 tables with bf16 h, both modes: B = 5 and 9 (ragged n-tiles)
    at V = 4096 + 37 (a ragged last tile). Returns the rows."""
    import torch
    k = "ring_gqa_attention_enc"
    enc = FLEET_ENC
    edges = [("S=17", dict(enc, s=17), 5, 928), ("S=100", dict(enc, s=100), 5, 928),
             ("S=100 group 2", dict(enc, s=100, kv_heads=16), 5, 928),
             ("Sx=0", dict(enc, sx=0), 5, 928), ("nv=65", enc, 5, 65),
             ("split B=1", enc, 1, 928), ("split B=2", enc, 2, 928),
             ("split B=1 nv=65", enc, 1, 65)]
    rows, seed = [], 700
    for ring in ("float", "int8", "int4"):
        for label, shape, b, nv in edges:
            seed += 1
            c = _fleet_case(shape, ring, b, nv, torch.bfloat16, seed, 1)
            rows.append(_ring_row(c, torch.bfloat16, f"{k} edge {label} {ring} B={b} nv={nv}",
                                  k, False))
        for label, shape in (("S=17", dict(enc, s=17)), ("Sx=0", dict(enc, sx=0))):
            seed += 1
            c = _fleet_case(shape, ring, 3, 928, torch.float32, seed, 1)
            rows.append(_ring_row(c, torch.float32, f"{k} edge {label} {ring} B=3 f32", k,
                                  False))
    for table in ("int8", "bf16"):
        for b in (5, 9):
            for mode in ("argmax", "logits"):
                seed += 1
                rows.append(_k3_row(table, b, mode, seed, False, v=4096 + 37))
    return rows


# The decoder's seven Q8 matrices, five shapes (K, N): wq, wk and wv, wo,
# w1 and w3, w2.
K2_SHAPES = {"wq": (3072, 4096), "wk/wv": (3072, 1024), "wo": (4096, 3072),
             "w1/w3": (3072, 9216), "w2": (9216, 3072)}
VOCAB, DIM = 131072, 3072


# Yardstick rows whose scales are rounded to bf16 (torch._weight_int8pack_mm)
# may differ from the f32-scaled plain version by the scales' rounding too:
# up to 2^-9 of max|y| beyond the bf16 tolerance.
BF16_SCALE_ROUNDING = 2.0 ** -9


def _bf16_tol(mx):
    """K2's bf16 tolerance for outputs of largest magnitude mx: 1e-5 of mx
    (another summation order) plus one bf16 ulp of mx (the order can move a
    value across a rounding boundary)."""
    return 1e-5 * mx + 2.0 ** (np.floor(np.log2(mx)) - 7)


def _int8pack_check(got, ref, what):
    """torch._weight_int8pack_mm's result against the plain version, once:
    the bf16 tolerance plus the rounding of its bf16 scales."""
    mx = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    tol = _bf16_tol(mx) + BF16_SCALE_ROUNDING * mx
    check(err <= tol, f"{what}: torch._weight_int8pack_mm err {err} > tol {tol}")


def _k2_row(name, k, n, m, dtype, seed, timed):
    """K2 (w8a16_gemv) against q8_matmul_plain on x [m, k] and Q8 weights
    [k, n] quantized from N(0, 0.02). Tolerance: f32 1e-5 of max|y| (same
    products, another summation order); bf16 `_bf16_tol`. Two launches must
    be bit-identical. If `timed`: the kernel's, the plain version's and two
    yardsticks' CUDA-graph times over weight copies that exceed the L2, and
    the bound (weight codes, scales, x and y once; 2 m k n operations at
    the rate of x's dtype). The yardsticks: torch._weight_int8pack_mm, the
    same function on the codes transposed to a contiguous [n, k] and the
    scales cast to x's dtype (both made outside the timed region; its
    result held once against the plain version), as `library_ms`; and
    torch.mm of the same x with a bf16 weight of the same shape (twice the
    weight bytes), as `mm_bf16_ms`."""
    import torch
    from voxtral_tpu_torch.ops import q8_matmul as qm
    from voxtral_tpu_torch.quant import quantize_torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(k * n) if timed else 1
    ws = [quantize_torch(torch.randn(k, n, generator=g, device="cuda") * 0.02)
          for _ in range(copies)]
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    before = qm.LAUNCHES["w8a16_gemv"]
    y = qm.w8a16_gemv(x, ws[0].q, ws[0].s)
    y2 = qm.w8a16_gemv(x, ws[0].q, ws[0].s)
    ref = qm.q8_matmul_plain(x, ws[0].q, ws[0].s)
    torch.cuda.synchronize()
    check(qm.LAUNCHES["w8a16_gemv"] == before + 2, f"K2 {name}: not launched")
    check(torch.isfinite(y).all().item(), f"K2 {name}: non-finite output")
    check(torch.equal(y, y2), f"K2 {name}: two launches differ")
    mx = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = _bf16_tol(mx) if dtype == torch.bfloat16 else 1e-5 * mx
    what = f"K2 {name} (K {k}, N {n}) M={m} {dtype}"
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    row = dict(kernel="w8a16_gemv", matrix=name, k=k, n=n, b=m, dtype=str(dtype),
               max_abs_err=err, tol=tol)
    if timed:
        elt = dtype.itemsize
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(
            k * n + 4 * n + m * k * elt + m * n * elt, 2 * m * k * n, dtype)
        qt = [w.q.t().contiguous() for w in ws]
        st = [w.s.to(dtype) for w in ws]
        _int8pack_check(torch._weight_int8pack_mm(x, qt[0], st[0]), ref, what)
        row.update(
            ms=cuda_ms(lambda i: qm.w8a16_gemv(x, ws[i % copies].q, ws[i % copies].s), 50),
            plain_ms=cuda_ms(lambda i: qm.q8_matmul_plain(x, ws[i % copies].q,
                                                          ws[i % copies].s), 5),
            library_ms=cuda_ms(lambda i: torch._weight_int8pack_mm(
                x, qt[i % copies], st[i % copies]), 50),
            library="torch._weight_int8pack_mm ([n, k] codes, scales in x's dtype)")
        del qt, st
        wb = [torch.randn(k, n, generator=g, device="cuda").to(dtype) for _ in range(copies)]
        row.update(mm_bf16_ms=cuda_ms(lambda i: torch.mm(x, wb[i % copies]), 50),
                   bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        del wb
        _shares(row)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _k3_row(table_kind, b, mode, seed, timed, v=VOCAB, h_dtype=None, tie=False):
    """K3 (fused_logits_argmax) in `mode` ("argmax" or "logits") against its
    plain version, table "int8" (codes + per-row scales), "bf16" or "f32"
    [v, 3072], h [b, 3072] bf16 (f32 for an f32 table). Logits within 1e-5
    of max|logit| (another summation order). Tokens equal the plain
    version's, except a stream whose plain top-two gap is <= 1e-5 of
    max|logit|. `tie`: rows 5000 and 90000 repeat row 300, which every h is
    built to prefer: the first index must win. If `timed`: CUDA-graph times
    of the kernel, the plain version and the yardstick (bf16 table:
    torch.mm(h, T.t(), out_dtype=f32); int8 table and bf16 h:
    torch._weight_int8pack_mm on the table as it is, with bf16 scales)
    [+ torch.argmax: two calls], and the bound (table, scales, h and the
    output once; 2 b v d operations at the rate of h's dtype)."""
    import torch
    from voxtral_tpu_torch.ops import logits_argmax as la
    from voxtral_tpu_torch.quant import quantize_torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    h_dtype = h_dtype or (torch.float32 if table_kind == "f32" else torch.bfloat16)
    w = torch.randn(v, DIM, generator=g, device="cuda") * 0.05
    h = torch.randn(b, DIM, generator=g, device="cuda")
    if tie:
        w[300] = h.sign().sum(0).sign() * 0.2
        w[5000] = w[90000] = w[300]
    if table_kind == "int8":
        qt = quantize_torch(w, 0)
        table, scales = qt.q, qt.s
    else:
        table = w.to(torch.float32 if table_kind == "f32" else torch.bfloat16)
        scales = None
    del w
    h = h.to(h_dtype)
    logits = mode == "logits"
    before = la.LAUNCHES["fused_logits_argmax"]
    out = la.fused_logits_argmax(h, table, scales, logits=logits)
    out2 = la.fused_logits_argmax(h, table, scales, logits=logits)
    ref_logits = la.tied_logits_plain(h, table, scales)
    torch.cuda.synchronize()
    check(la.LAUNCHES["fused_logits_argmax"] == before + 2, "K3: not launched")
    check(torch.equal(out, out2), "K3: two launches differ")
    mx = ref_logits.abs().max().item()
    what = f"K3 {mode} {table_kind} table V={v} B={b} h {h_dtype}" + (" tie" if tie else "")
    row = dict(kernel="fused_logits_argmax", mode=mode, table=table_kind, v=v, b=b,
               dtype=str(h_dtype), tie=tie)
    if logits:
        err = (out - ref_logits).abs().max().item()
        tol = 1e-5 * mx
        check(err <= tol, f"{what}: err {err} > tol {tol}")
        row.update(max_abs_err=err, tol=tol)
    else:
        ref = torch.argmax(ref_logits, dim=-1).to(torch.int32)
        top2 = torch.topk(ref_logits, 2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= 1e-5 * mx
        bad = (out != ref) & ~near
        check(not bad.any().item(), f"{what}: tokens {out.tolist()} != {ref.tolist()}")
        if tie:
            check(bool((out == 300).all()), f"{what}: first index lost the tie: {out.tolist()}")
        # the tensor-parallel head's form: the same launch, plus the winning logit
        tok_v, best = _launched(la, "fused_logits_argmax", lambda: la.fused_logits_argmax(
            h, table, scales, with_value=True))
        want = torch.gather(ref_logits, 1, tok_v[:, None].long())[:, 0]
        check(torch.equal(tok_v, out) and (best - want).abs().max().item() <= 1e-5 * mx,
              f"{what}: the winning logits {best.tolist()} != {want.tolist()}")
        row.update(max_abs_err=float(((out != ref) & ~near).sum().item()), tol=0.0,
                   near_ties=int(near.sum().item()))
    if timed:
        elt, h_elt = table.element_size(), h.element_size()
        nbytes = v * DIM * elt + (4 * v if scales is not None else 0) + b * DIM * h_elt \
            + (4 * b * v if logits else 4 * b)
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(nbytes, 2 * b * v * DIM, h_dtype)
        lib, lib_name = None, None
        if table_kind == "bf16":
            lib_name = "torch.mm(out_dtype=f32)"
            if logits:
                lib = cuda_ms(lambda i: torch.mm(h, table.t(), out_dtype=torch.float32), 20)
            else:
                lib = cuda_ms(lambda i: torch.argmax(
                    torch.mm(h, table.t(), out_dtype=torch.float32), dim=-1), 20)
        elif table_kind == "int8" and h_dtype == torch.bfloat16:
            # the same logits from the table as it is, with its scales in h's
            # dtype (cast outside the timed region); held once against the
            # plain logits
            lib_name = "torch._weight_int8pack_mm (bf16 scales, bf16 logits)"
            sb = scales.to(h_dtype)
            _int8pack_check(torch._weight_int8pack_mm(h, table, sb), ref_logits, what)
            if logits:
                lib = cuda_ms(lambda i: torch._weight_int8pack_mm(h, table, sb), 20)
            else:
                lib = cuda_ms(lambda i: torch.argmax(
                    torch._weight_int8pack_mm(h, table, sb), dim=-1), 20)
        plain = la.tied_logits_plain if logits else la.logits_argmax_plain
        row.update(
            ms=cuda_ms(lambda i: la.fused_logits_argmax(h, table, scales, logits=logits), 20),
            plain_ms=cuda_ms(lambda i: plain(h, table, scales), 3),
            library_ms=lib, library=None if lib is None else
            lib_name + ("" if logits else " + torch.argmax (two calls)"),
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        _shares(row)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def phase1_q8():
    """K2 at the decoder's five Q8 shapes, f32 and bf16, M = 1 (offline),
    16 (fleet), 32 (phase 6's stack), 38 (the prefill) and 64 (the kernel's
    largest): bf16 at M 1 and 16 timed, and at M 32 and 38 for w1/w3;
    checked only at the shapes' slices on 2 tensor-parallel ranks and at
    edges (K no multiple of the 64-row stage, N no multiple of the
    128-column tile, M 1, 17, 64). K3 in both modes on int8 and bf16 tables
    at B = 1 and 16 (timed), an f32 table at a small V and a constructed tie
    (checked). Returns the rows."""
    import torch
    rows, seed = [], 500
    for name, (k, n) in K2_SHAPES.items():
        for m in (1, 16, 32, 38, 64):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                timed = dtype == torch.bfloat16 and (m <= 16 or name == "w1/w3" and m < 64)
                rows.append(_k2_row(name, k, n, m, dtype, seed, timed))
    for name, (k, n) in K2_SHAPES.items():       # a rank's slice (model 2)
        k, n = (k // 2, n) if name in ("wo", "w2") else (k, n // 2)
        for m, dtype in ((16, torch.bfloat16), (8, torch.float32)):
            seed += 1
            rows.append(_k2_row(f"{name} tp2", k, n, m, dtype, seed, False))
    for name, k, n in (("ragged K", 1536 + 72, 3072), ("ragged N", 3072, 1024 - 16)):
        for m in (1, 17, 64):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                rows.append(_k2_row(name, k, n, m, dtype, seed, False))
    seed = 520
    for table in ("int8", "bf16"):
        for b in (1, 16):
            for mode in ("argmax", "logits"):
                seed += 1
                rows.append(_k3_row(table, b, mode, seed, True))
    for mode in ("argmax", "logits"):
        rows.append(_k3_row("f32", 2, mode, 600, False, v=4096))
        rows.append(_k3_row("int8", 3, mode, 601, False, h_dtype=torch.float32))
    rows.append(_k3_row("int8", 16, "argmax", 602, False, tie=True))
    rows.append(_k3_row("bf16", 3, "argmax", 603, False, tie=True))
    return rows


# The tools' shapes: T2 and T3 at the five merged bf16 tensors of
# tools/profile_weight_stream.py (T3 at its B = 24 streams), T1 at the
# decoder's seven Q8 matrices (K2_SHAPES), T11 at the rings of
# tools/profile_dma_ceiling.py.
MERGED = {"wq": (3072, 4096), "wkv": (3072, 2048), "wo": (4096, 3072),
          "w13": (3072, 18432), "w2": (9216, 3072)}
T3_ROWS, T11_SHAPE = 24, (16, 2088, 1024)
# Integer and f32 adds of the read ceilings, at the CUDA cores' f32 rate
ADD_DTYPE = "torch.float32"


def _launched(mod, name, fn):
    """fn() must launch `name` exactly once; returns its result."""
    before = mod.LAUNCHES[name]
    out = fn()
    check(mod.LAUNCHES[name] == before + 1, f"{name}: the call did not launch the kernel")
    return out


def _t1_row(name, k, n, seed, timed):
    """T1 (wread) against wread_plain on seeded int8 codes [k, n]: bit for
    bit, and the same bits on a second launch. If `timed`: the kernel's,
    the plain version's and torch.sum(q, 0, dtype=f32)'s times over copies
    beyond the L2; bound: the codes and the output once, K N adds."""
    import torch
    from voxtral_tpu_torch.ops import read_ceiling as rc
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(k * n) if timed else 1
    qs = [torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
          for _ in range(copies)]
    out = _launched(rc, "wread", lambda: rc.wread_kernel(qs[0]))
    out2 = _launched(rc, "wread", lambda: rc.wread_kernel(qs[0]))
    ref = rc.wread_plain(qs[0])
    torch.cuda.synchronize()
    what = f"T1 wread {name} (K {k}, N {n})"
    check(tuple(out.shape) == (1, n) and torch.equal(out, ref), f"{what}: != plain")
    check(torch.equal(out, out2), f"{what}: two launches differ")
    row = dict(kernel="wread", matrix=name, k=k, n=n, max_abs_err=0.0, tol=0.0)
    if timed:
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(k * n + 4 * n, k * n, ADD_DTYPE)
        row.update(
            ms=cuda_ms(lambda i: rc.wread_kernel(qs[i % copies]), 50),
            plain_ms=cuda_ms(lambda i: rc.wread_plain(qs[i % copies]), 5),
            library_ms=cuda_ms(lambda i: torch.sum(qs[i % copies], 0, dtype=torch.float32),
                               50),
            library="torch.sum(q, 0, dtype=f32)", bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=bound_ms, bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _t2_tiles_sum(w, blk_k, blk_n):
    """T2's function as one PyTorch call: the blocks' [8, 128] tiles as a
    strided view [K blocks, 8, N blocks, 128] of w, summed in f32 over the
    blocks. Needs every block's tile whole (every block >= 8 x 128)."""
    import torch
    k, n = w.shape
    bk, bn = min(blk_k, k), min(blk_n, n)
    nk, nn = -(-k // bk), -(-n // bn)
    check(min(bk, k - (nk - 1) * bk) >= 8 and min(bn, n - (nn - 1) * bn) >= 128,
          f"T2's strided view needs whole tiles: [{k}, {n}], blocks {bk} x {bn}")
    return torch.as_strided(w, (nk, 8, nn, 128), (bk * n, n, bn, 1)).sum(
        (0, 2), dtype=torch.float32)


def _t2_row(name, k, n, seed, timed, blk_k=1536, blk_n=1024):
    """T2 (pure_stream) against pure_stream_plain on a seeded bf16 [k, n]
    weight: within 1e-6 of max|out| (the kernel adds the tiles in the JAX
    grid's order, as the plain version does: expected exact), and the
    kernel's per-block word sums add up to word_checksum_plain(w), so every
    byte of w was loaded. If `timed`: times over copies beyond the L2, the
    bound (w and the output once; 1024 adds per block) and the library
    yardstick, one torch.sum over a strided view of the blocks' tiles
    (`_t2_tiles_sum`; it reads only the tiles, so its time is no read
    rate), held to the same tolerance."""
    import torch
    from voxtral_tpu_torch.ops import read_ceiling as rc
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * k * n) if timed else 1
    ws = [(torch.randn((k, n), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
          for _ in range(copies)]
    out, sums = _launched(rc, "pure_stream", lambda: rc.pure_stream_kernel(
        ws[0], blk_k, blk_n))
    ref = rc.pure_stream_plain(ws[0], blk_k, blk_n)
    want_sum = rc.word_checksum_plain(ws[0])
    torch.cuda.synchronize()
    got_sum = int(sums.to(torch.int64).sum().item()) & 0xFFFFFFFF
    what = f"T2 pure_stream {name} (K {k}, N {n}, blocks {blk_k} x {blk_n})"
    err = (out - ref).abs().max().item()
    tol = 1e-6 * ref.abs().max().item()
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    check(got_sum == want_sum, f"{what}: word sum {got_sum:#x} != {want_sum:#x}: "
                               "not every byte was read")
    n_blocks = -(-k // min(blk_k, k)) * -(-n // min(blk_n, n))
    row = dict(kernel="pure_stream", matrix=name, k=k, n=n, max_abs_err=err, tol=tol,
               word_sum_ok=True)
    if timed:
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(2 * k * n + 4 * 1024,
                                                      1024 * n_blocks, ADD_DTYPE)
        lib_err = (_t2_tiles_sum(ws[0], blk_k, blk_n) - ref).abs().max().item()
        check(lib_err <= tol, f"{what}: the library yardstick is off by {lib_err} > {tol}")
        row.update(
            ms=cuda_ms(lambda i: rc.pure_stream_kernel(ws[i % copies], blk_k, blk_n), 50),
            plain_ms=cuda_ms(lambda i: rc.pure_stream_plain(ws[i % copies], blk_k, blk_n),
                             5),
            library_ms=cuda_ms(lambda i: _t2_tiles_sum(ws[i % copies], blk_k, blk_n), 50),
            library="torch.sum over a strided view of the tiles (reads only the tiles)",
            library_err=lib_err, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms,
            bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _t3_row(name, k, n, m, seed, timed):
    """T3 (bf16_matmul) against bf16_matmul_plain (f32 product of the bf16
    values): within 1e-4 of max|plain| (exact products, another summation
    order), the same bits on a second launch. If `timed`: times over weight
    copies beyond the L2, torch.mm(x, w, out_dtype=f32) as the yardstick,
    and the bound (x, w and y once; 2 m k n operations at the bf16 rate)."""
    import torch
    from voxtral_tpu_torch.ops import bf16_matmul as bm
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * k * n) if timed else 1
    ws = [(torch.randn((k, n), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
          for _ in range(copies)]
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    y = _launched(bm, "bf16_matmul", lambda: bm.bf16_matmul_kernel(x, ws[0]))
    y2 = _launched(bm, "bf16_matmul", lambda: bm.bf16_matmul_kernel(x, ws[0]))
    ref = bm.bf16_matmul_plain(x, ws[0])
    torch.cuda.synchronize()
    what = f"T3 bf16_matmul {name} (K {k}, N {n}) M={m}"
    err = (y - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()
    check(torch.isfinite(y).all().item() and tuple(y.shape) == (m, n),
          f"{what}: non-finite or misshapen output")
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    check(torch.equal(y, y2), f"{what}: two launches differ")
    row = dict(kernel="bf16_matmul", matrix=name, k=k, n=n, b=m, max_abs_err=err, tol=tol)
    if timed:
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(
            2 * k * n + 2 * m * k + 4 * m * n, 2 * m * k * n, torch.bfloat16)
        row.update(
            ms=cuda_ms(lambda i: bm.bf16_matmul_kernel(x, ws[i % copies]), 50),
            plain_ms=cuda_ms(lambda i: bm.bf16_matmul_plain(x, ws[i % copies]), 5),
            library_ms=cuda_ms(lambda i: torch.mm(x, ws[i % copies],
                                                  out_dtype=torch.float32), 50),
            library="torch.mm(out_dtype=f32)", bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=bound_ms, bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _t11_row(shape, salt, seed, timed):
    """T11 (rd) against rd_plain on seeded int8 rings: bit for bit, twice.
    If `timed`: times over ring pairs beyond the L2, two torch.sum calls +
    the adds as the yardstick, and the bound (both rings, the salt and the
    output once; 2 B P C + B C adds)."""
    import torch
    from voxtral_tpu_torch.ops import read_ceiling as rc
    b, p, c = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * b * p * c) if timed else 1
    pairs = [tuple(torch.randint(-127, 128, shape, generator=g, device="cuda",
                                 dtype=torch.int8) for _ in range(2)) for _ in range(copies)]
    s = torch.tensor([salt], dtype=torch.float32, device="cuda")
    out = _launched(rc, "rd", lambda: rc.rd_kernel(*pairs[0], s))
    out2 = _launched(rc, "rd", lambda: rc.rd_kernel(*pairs[0], s))
    ref = rc.rd_plain(*pairs[0], s)
    torch.cuda.synchronize()
    what = f"T11 rd {list(shape)} salt {salt}"
    check(tuple(out.shape) == (b, 1, c) and torch.equal(out, ref), f"{what}: != plain")
    check(torch.equal(out, out2), f"{what}: two launches differ")
    row = dict(kernel="rd", shape=list(shape), max_abs_err=0.0, tol=0.0)
    if timed:
        def lib(i):
            k, v = pairs[i % copies]
            return (torch.sum(k, 1, keepdim=True, dtype=torch.float32)
                    + torch.sum(v, 1, keepdim=True, dtype=torch.float32)) + s
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(2 * b * p * c + 4 + 4 * b * c,
                                                      2 * b * p * c + b * c, ADD_DTYPE)
        row.update(
            ms=cuda_ms(lambda i: rc.rd_kernel(*pairs[i % copies], s), 50),
            plain_ms=cuda_ms(lambda i: rc.rd_plain(*pairs[i % copies], s), 5),
            library_ms=cuda_ms(lib, 50), library="torch.sum x 2 + add",
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def phase1_tools():
    """T1, T2, T3 and T11 at the tools' shapes (timed), plus ragged shapes
    (checked): column counts that are not a multiple of the kernels' tiles,
    K not a multiple of T2's block or T3's chunk, B from 1 to 64. T2's time
    must grow with the bytes it reads (w13 against wq), not stay with its
    [8, 128] output. Returns the rows."""
    rows, seed = [], 700
    for name, (k, n) in K2_SHAPES.items():
        seed += 1
        rows.append(_t1_row(name, k, n, seed, True))
    rows.append(_t1_row("table", VOCAB, DIM, 722, True))     # K3's int8 table
    rows.append(_t1_row("ragged", 200, 784, 720, False))
    for name, (k, n) in MERGED.items():
        seed += 1
        rows.append(_t2_row(name, k, n, seed, True))
    rows.append(_t2_row("table", VOCAB, DIM, 723, True))     # K3's bf16 table
    rows.append(_t2_row("ragged", 1000, 1032, 721, False, blk_k=256, blk_n=512))
    t2 = {r["matrix"]: r for r in rows if r["kernel"] == "pure_stream"}
    ratio = t2["w13"]["ms"] / t2["wq"]["ms"]
    byte_ratio = MERGED["w13"][1] / MERGED["wq"][1]
    log(f"[1] T2 time w13 / wq {ratio:.3f} for {byte_ratio:.2f}x the bytes")
    check(ratio >= 0.5 * byte_ratio, f"T2's time does not follow its bytes: {ratio}")
    for name, (k, n) in MERGED.items():
        seed += 1
        rows.append(_t3_row(name, k, n, T3_ROWS, seed, True))
    for m in (1, 16, 17, 64):
        rows.append(_t3_row("wq", *MERGED["wq"], m, 730 + m, False))
    rows.append(_t3_row("ragged", 1536 + 72, 1000, 5, 731, False))
    rows.append(_t3_row("ragged K", 1536 + 72, 3072, 24, 732, False))
    rows.append(_t3_row("ragged N", 3072, 1000, 24, 733, False))
    rows.append(_t11_row(T11_SHAPE, 0.375, 740, True))
    rows.append(_t11_row(T11_SHAPE, 1.0e-3, 741, False))
    rows.append(_t11_row((3, 77, 528), -2.5e-4, 742, False))
    return rows


# T4-T7: the attention kernels of tools/profile_int4_unpack.py (int8 and
# nibble-packed rings, B = 32) and tools/profile_attn_layout.py (masked,
# scaled, [B, P, 1024] and block-major [B, nb, P, blk] rings, B = 16).
LAYOUT_P, LAYOUT_KV, LAYOUT_BLKS = 2088, 1024, (256, 512, 1024)


# T5's edges (B, P, kv_dim), checked: one slot; under one tile; one stream
# at the tool's P (8 splits); one kv head; B 16 (two splits in clusters);
# B 64 at P 1500 (one split, beyond one wave); the largest P the plan
# takes (8 shares of 2096), at one stream and at B 64.
T5_EDGES = ((1, 1, 1024), (3, 15, 1024), (1, LAYOUT_P, 1024), (4, 300, 128),
            (16, LAYOUT_P, 1024), (64, 1500, 1024), (1, 16768, 1024), (64, 16768, 1024))


def _layout_tol(ref):
    """Two bf16 ulps of max|ref| (T5_CHECK_RTOL): e rounds to bf16 after
    f32 sums taken in another order, and the output rounds to bf16."""
    from voxtral_tpu_torch.tools.profile_int4_unpack import T5_CHECK_RTOL
    return T5_CHECK_RTOL * ref.float().abs().max().item()


def _t45_row(kernel, b, p, kv, seed, timed):
    """T4 (attn8, int8 rings) or T5 (attn4, packed rings) against its plain
    version on seeded rings and q = 0.05 N(0, 1) in bf16: within
    `_layout_tol`, the same bits on a second launch. If `timed`: times over
    ring copies beyond the L2, the bound (rings, q and the output once; 2
    products of 4 query rows per K/V lane at the bf16 rate) and the
    yardstick, SDPA with scale 1.0 and no mask over bf16 copies of the
    codes (T5: unpacked) -- normalised: the same reads and products, not the
    same output."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import layout_attention as la
    from voxtral_tpu_torch.quant import unpack_int4
    packed = kernel == "attn4"
    kern, plain = ((la.attn4_kernel, la.attn4_plain) if packed
                   else (la.attn8_kernel, la.attn8_plain))
    lanes, lo, hkv = (kv // 2, -128, kv // 128) if packed else (kv, -127, kv // 128)
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * b * p * lanes) if timed else 1
    rings = [tuple(torch.randint(lo, 127, (b, p, lanes), generator=g, device="cuda",
                                 dtype=torch.int8) for _ in range(2)) for _ in range(copies)]
    q = (torch.randn((b, 1, 4 * kv), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
    out = _launched(la, kernel, lambda: kern(q, *rings[0]))
    out2 = _launched(la, kernel, lambda: kern(q, *rings[0]))
    ref = plain(q, *rings[0])
    torch.cuda.synchronize()
    what = f"{'T5' if packed else 'T4'} {kernel} B={b} P={p} kv_dim={kv}"
    err, tol = (out.float() - ref.float()).abs().max().item(), _layout_tol(ref)
    check(torch.isfinite(out).all().item() and out.shape == q.shape,
          f"{what}: non-finite or misshapen output")
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    check(torch.equal(out, out2), f"{what}: two launches differ")
    row = dict(kernel=kernel, b=b, p=p, kv_dim=kv, max_abs_err=err, tol=tol)
    if timed:
        def codes(r):                                  # -> bf16 [b, hkv, p, 128]
            if packed:
                r = torch.cat(unpack_int4(r.view(b, p, hkv, 64)), -1)
            return r.view(b, p, hkv, 128).transpose(1, 2).to(torch.bfloat16).contiguous()

        kvs = [(codes(k), codes(v)) for k, v in rings]
        qs = q.view(b, hkv * 4, 1, 128)
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(
            2 * b * p * lanes + 2 * 2 * b * 4 * kv, 16 * kv * b * p, torch.bfloat16)
        row.update(
            ms=cuda_ms(lambda i: kern(q, *rings[i % copies]), 50),
            plain_ms=cuda_ms(lambda i: plain(q, *rings[i % copies]), 5),
            library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                qs, *kvs[i % copies], scale=1.0, enable_gqa=True), 20),
            library="SDPA, scale 1, no mask, bf16 codes (normalised: the same reads and "
                    "products, not the same output)",
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        del kvs
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _t67_rows(b, p, blk, seed, timed, masked):
    """T6 (attn3d) and T7 (attn4d) against their plain version on seeded
    int8 rings (the same values in both layouts), scales in [0.005, 0.02],
    q uniform in [-0.5, 0.5) in bf16: within `_layout_tol`, T6 == T7 bit for
    bit, and a call whose query positions are all invalid returns exact
    zeros. Positions: the tool's (sp = arange(P), qp = P + 10, every slot
    valid), or `masked`: sp = 7 j, every 13th slot negative, qp = 7 (P - 1)
    - 30, so the mask cuts slots by sp < 0, sp > qp and the 8192 window,
    and the last stream (B > 1) has an invalid query position (every slot
    masked, exact zeros). If `timed`: each kernel's time over ring copies
    beyond the L2, the plain version's, the bound (q and the output, sp and
    qp once, and K, V and their scales for the valid slots; 2 products of 4
    query rows per K/V lane of a valid slot at the bf16 rate) and the
    yardstick: one SDPA call with the boolean mask over the rings
    dequantized to bf16 beforehand (untimed). Returns the two rows."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import layout_attention as la
    kv = LAYOUT_KV
    hkv, nb, sub = kv // 128, kv // blk, blk // 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * b * p * kv) if timed else 1
    rings3 = [tuple(torch.randint(-127, 127, (b, p, kv), generator=g, device="cuda",
                                  dtype=torch.int8) for _ in range(2)) for _ in range(copies)]
    rings4 = [tuple(la.to_block_major(r, blk) for r in pair) for pair in rings3]
    q = (torch.rand((b, 1, 4 * kv), generator=g, device="cuda") - 0.5).to(torch.bfloat16)
    ks, vs = (0.005 + 0.015 * torch.rand((b, nb, sub, p), generator=g, device="cuda")
              for _ in range(2))
    j = torch.arange(p, dtype=torch.int32, device="cuda")
    if masked:
        sp = torch.where(j % 13 == 5, -1 - j, 7 * j)
        qp = torch.full((b, 1, 1), 7 * (p - 1) - 30, dtype=torch.int32, device="cuda")
        if b > 1:
            qp[-1] = SLOT_INVALID
    else:
        sp = j
        qp = torch.full((b, 1, 1), p + 10, dtype=torch.int32, device="cuda")
    sp = sp.repeat(b, 1).reshape(b, 1, p).contiguous()
    dead_qp = torch.full_like(qp, SLOT_INVALID)
    ref = la.attn3d_plain(q, *rings3[0], sp, qp, ks, vs, blk)
    tol = _layout_tol(ref)
    spq = sp.reshape(b, p).long()
    live = ((spq >= 0) & (spq <= qp.reshape(b, 1)) & (spq >= qp.reshape(b, 1) - 8191))
    n_live = int(live.sum())
    outs, rows = [], []
    for kernel, kern, rings in (("attn3d", la.attn3d_kernel, rings3),
                                ("attn4d", la.attn4d_kernel, rings4)):
        out = _launched(la, kernel, lambda: kern(q, *rings[0], sp, qp, ks, vs, blk))
        dead = _launched(la, kernel, lambda: kern(q, *rings[0], sp, dead_qp, ks, vs, blk))
        torch.cuda.synchronize()
        what = (f"{'T6' if kernel == 'attn3d' else 'T7'} {kernel} B={b} P={p} blk={blk}"
                + (" masked" if masked else ""))
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out).all().item() and out.shape == q.shape,
              f"{what}: non-finite or misshapen output")
        check(err <= tol, f"{what}: err {err} > tol {tol}")
        check(dead.abs().max().item() == 0.0, f"{what}: all-masked call is not zero")
        if masked and b > 1:
            check(out[-1].abs().max().item() == 0.0, f"{what}: masked stream is not zero")
        outs.append(out)
        row = dict(kernel=kernel, b=b, p=p, blk=blk, masked=masked, live_slots=n_live,
                   max_abs_err=err, tol=tol)
        if timed:
            nbytes = 2 * 2 * b * 4 * kv + 4 * b * p + 4 * b + n_live * 2 * (kv + 4 * hkv)
            bytes_ms, ops_ms, bound_ms, bound_by = _bound(nbytes, 16 * kv * n_live,
                                                          torch.bfloat16)
            plain = la.attn3d_plain if kernel == "attn3d" else la.attn4d_plain
            row.update(
                ms=cuda_ms(lambda i: kern(q, *rings[i % copies], sp, qp, ks, vs, blk), 50),
                plain_ms=cuda_ms(lambda i: plain(q, *rings[i % copies], sp, qp, ks, vs, blk),
                                 5),
                bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
    check(torch.equal(outs[0], outs[1]), f"T6 != T7 at B={b} P={p} blk={blk}")
    if timed:
        def deq(r, s):                               # -> bf16 [b, hkv, p, 128]
            r = r.view(b, p, hkv, 128).transpose(1, 2).float()
            return (r * s.reshape(b, hkv, p, 1)).to(torch.bfloat16).contiguous()

        kvs = [(deq(k, ks), deq(v, vs)) for k, v in rings3]
        mask = live[:, None, None, :]
        qs = q.view(b, hkv * 4, 1, 128)
        lib = cuda_ms(lambda i: F.scaled_dot_product_attention(
            qs, *kvs[i % copies], attn_mask=mask, enable_gqa=True), 20)
        for row in rows:
            row.update(library_ms=lib, library="SDPA with the boolean mask over bf16 "
                                               "dequantized rings")
        del kvs
    for row in rows:
        log(f"[1] {row['kernel']} B={b} P={p} blk={blk}: {json.dumps(row)}")
    return rows


def phase1_layout():
    """T4 and T5 at the int4-unpack tool's shapes (B = 32, P = 2088, timed)
    and ragged ones (P = 77, B = 1; 4 kv heads), T5's edges (`T5_EDGES`),
    T6 and T7 at the layout tool's (B = 16, P = 2088, each blk timed), each
    blk also masked (checked), and P = 77, B = 1 masked (checked). Returns
    the rows."""
    rows = []
    for kernel in ("attn8", "attn4"):
        rows.append(_t45_row(kernel, 32, LAYOUT_P, LAYOUT_KV, 750, True))
        rows.append(_t45_row(kernel, 1, 77, LAYOUT_KV, 751, False))
        rows.append(_t45_row(kernel, 5, 300, 512, 752, False))
    for i, (b, p, kv) in enumerate(T5_EDGES):
        rows.append(_t45_row("attn4", b, p, kv, 790 + i, False))
    for i, blk in enumerate(LAYOUT_BLKS):
        rows += _t67_rows(16, LAYOUT_P, blk, 760 + i, True, False)
        rows += _t67_rows(16, LAYOUT_P, blk, 770 + i, False, True)
    rows += _t67_rows(1, 77, 256, 780, False, True)
    return rows


# T8-T10: the pure ring reads of tools/profile_ring_layout2.py (int8 rings
# [B, P, 1024], flat or block-major, B = 32).
RL_STREAMS, RL_GROUPS = 32, ((4, 256), (8, 256), (4, 512))


def _rl_row(kernel, b, p, blk, g, seed, timed, salt=0.375):
    """T8 (rd_flat, blk lanes a cell), T9 (rd_blockmajor) or T10 (rd_g, g
    streams a block) against its plain version on seeded int8 rings [b, p,
    1024] (block-major for T9, T10): bit for bit (exact integer sums, the
    salt added once), the same bits on a second launch. If `timed`: times
    over ring pairs beyond the L2, the bound (both rings, the salt and the
    output once; 2 b p 1024 + b 1024 adds) and two torch.sum(dtype=f32)
    calls + the adds as the yardstick."""
    import torch
    from voxtral_tpu_torch.ops import ring_layout as rl
    from voxtral_tpu_torch.ops.layout_attention import to_block_major
    c = LAYOUT_KV
    gen = torch.Generator(device="cuda").manual_seed(seed)
    copies = _l2_copies(2 * b * p * c) if timed else 1
    pairs = [tuple(torch.randint(-127, 127, (b, p, c), generator=gen, device="cuda",
                                 dtype=torch.int8) for _ in range(2)) for _ in range(copies)]
    s = torch.tensor([[salt]], dtype=torch.float32, device="cuda")
    f32 = torch.float32
    if kernel == "rd_flat":
        kern = lambda k, v: rl.rd_flat_kernel(k, v, s, blk)          # noqa: E731
        plain = lambda k, v: rl.rd_flat_plain(k, v, s, blk)          # noqa: E731
        axis = 1
    else:
        pairs = [tuple(to_block_major(r, blk) for r in pair) for pair in pairs]
        axis = 2
        if kernel == "rd_blockmajor":
            kern = lambda k, v: rl.rd_blockmajor_kernel(k, v, s)     # noqa: E731
            plain = lambda k, v: rl.rd_blockmajor_plain(k, v, s)     # noqa: E731
        else:
            kern = lambda k, v: rl.rd_g_kernel(k, v, s, g)           # noqa: E731
            plain = lambda k, v: rl.rd_g_plain(k, v, s, g)           # noqa: E731
    out = _launched(rl, kernel, lambda: kern(*pairs[0]))
    out2 = _launched(rl, kernel, lambda: kern(*pairs[0]))
    ref = plain(*pairs[0])
    torch.cuda.synchronize()
    what = f"{kernel} B={b} P={p} blk={blk}" + (f" G={g}" if kernel == "rd_g" else "")
    check(out.shape == ref.shape and torch.equal(out, ref), f"{what}: != plain")
    check(torch.equal(out, out2), f"{what}: two launches differ")
    row = dict(kernel=kernel, b=b, p=p, blk=blk, g=g, max_abs_err=0.0, tol=0.0)
    if timed:
        def lib(i):
            k, v = pairs[i % copies]
            return (torch.sum(k, axis, keepdim=True, dtype=f32)
                    + torch.sum(v, axis, keepdim=True, dtype=f32)) + s

        bytes_ms, ops_ms, bound_ms, bound_by = _bound(2 * b * p * c + 4 + 4 * b * c,
                                                      2 * b * p * c + b * c, ADD_DTYPE)
        row.update(
            ms=cuda_ms(lambda i: kern(*pairs[i % copies]), 50),
            plain_ms=cuda_ms(lambda i: plain(*pairs[i % copies]), 5),
            library_ms=cuda_ms(lib, 50), library="torch.sum(dtype=f32) x 2 + add",
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def phase1_ring_layout():
    """T8, T9 and T10 at the ring-layout tool's shapes (B = 32, P = 2088:
    T8 blk 512, T9 blk 256 and 512, T10 at (G, blk) (4, 256), (8, 256),
    (4, 512); timed), and ragged ones (checked): P = 77, B = G, blk 128 and
    1024. On the card T10 refuses B % G != 0. Returns the rows."""
    import torch
    from voxtral_tpu_torch.ops import ring_layout as rl
    rows = [_rl_row("rd_flat", RL_STREAMS, LAYOUT_P, 512, 1, 790, True)]
    rows += [_rl_row("rd_blockmajor", RL_STREAMS, LAYOUT_P, blk, 1, 791 + i, True)
             for i, blk in enumerate((256, 512))]
    rows += [_rl_row("rd_g", RL_STREAMS, LAYOUT_P, blk, g, 793 + i, True)
             for i, (g, blk) in enumerate(RL_GROUPS)]
    rows += [_rl_row("rd_flat", 3, 77, 1024, 1, 796, False, -2.5e-4),
             _rl_row("rd_blockmajor", 1, 77, 128, 1, 797, False),
             _rl_row("rd_g", 8, 77, 128, 8, 798, False, 1e-3)]
    k = torch.zeros((6, 2, 64, 512), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 1), device="cuda")
    try:
        rl.rd_g(k, k, s, 4)
        raise RuntimeError("check failed: rd_g took B = 6 with G = 4")
    except ValueError:
        pass
    return rows


def _head_slice(c, m, r):
    """Rank r of m's share of ring case `c` (K1-tp): its query heads, its kv
    heads' ring lanes (int4: packed lanes), scales and extra columns, as
    contiguous copies, with local head counts."""
    from voxtral_tpu_torch.ops.ring_attention import local_heads
    kw = c["kw"]
    hd = kw["head_dim"]
    lh, lkv = local_heads(kw["heads"], kw["kv_heads"], m)
    lane = hd // 2 if c["ring"] == "int4" else hd
    q_sl = slice(r * lh * hd, (r + 1) * lh * hd)
    ring_sl, x_sl = slice(r * lkv * lane, (r + 1) * lkv * lane), slice(r * lkv * hd,
                                                                      (r + 1) * lkv * hd)
    h_sl = slice(r * lkv, (r + 1) * lkv)

    def part(t, sl, scales=False):
        if t is None:
            return None
        return (t[:, sl] if scales else t[..., sl]).contiguous()

    return dict(c, q=part(c["q"], q_sl), xk=part(c["xk"], x_sl), xv=part(c["xv"], x_sl),
                rings=[(part(k, ring_sl), part(v, ring_sl), part(ks, h_sl, True),
                        part(vs, h_sl, True)) for k, v, ks, vs in c["rings"]],
                kw=dict(kw, heads=lh, kv_heads=lkv)), q_sl


def _k1tp_rows(shape, ring, kernel, ms_, seed):
    """K1-tp: `kernel` on each of m ranks' head slices of one bf16 case at
    `shape` (B = 16, every slot below P valid), for each m in ms_. Each
    slice's output, and the whole call's once, is held against the plain
    version on the same inputs within K1's bf16 tolerance (2e-2 of
    max|ref|); `max_abs_err` is the largest of those errors. Each slice is
    also compared with the matching lanes of the whole kernel call: the
    kernels split the ring by slots, not heads (K1-enc's bf16 route splits
    only below half the SMs' worth of (stream, kv head) pairs, not at B =
    16), so a head's arithmetic does not depend on the head count, and a
    row records whether all slices were bit for bit (`exact`). Each m:
    rank 0's call timed with its plain version, SDPA on the slice and the
    bound of its inputs. Returns the rows."""
    import torch
    from voxtral_tpu_torch.ops import ring_attention as ra
    dtype = torch.bfloat16
    kv_dim = shape["kv_heads"] * shape["head_dim"]
    row_bytes = {"float": kv_dim * 2, "int8": kv_dim, "int4": kv_dim // 2}[ring]
    c = _fleet_case(shape, ring, 16, shape["p"], dtype, seed,
                    _l2_copies(2 * 16 * shape["p"] * row_bytes))

    def against_plain(case, out, what):
        ref = _ring_call(ra.ring_gqa_attention_reference, case).float()
        err = (out.float() - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        check(torch.isfinite(out).all().item(), f"{what}: non-finite kernel output")
        check(err <= tol, f"{what}: err {err} against the plain version > tol {tol}")
        return err, tol

    whole = _ring_call(ra.ring_gqa_attention, c)
    whole_err, whole_tol = against_plain(c, whole, f"K1-tp {kernel} {ring} whole call")
    rows = []
    for m in ms_:
        err, exact = whole_err, True
        for r in range(m):
            cr, q_sl = _head_slice(c, m, r)
            what = f"K1-tp {kernel} {ring} m={m} rank {r}"
            out = _launched(ra, kernel, lambda: _ring_call(ra.ring_gqa_attention, cr))
            err = max(err, against_plain(cr, out, what)[0])
            want = whole[..., q_sl]
            exact &= bool(torch.equal(out, want))
            d = (out.float() - want.float()).abs().max().item()
            check(d <= whole_tol, f"{what}: {d} from the whole call > tol {whole_tol}")
        row = dict(kernel="ring_gqa_attention_tp", base=kernel, ring=ring, m=m, b=16,
                   nv=shape["p"], exact=exact, max_abs_err=err, tol=whole_tol)
        cr, _ = _head_slice(c, m, 0)
        copies = len(cr["rings"])
        bytes_ms, ops_ms, bound_ms, bound_by = _ring_bound(cr, dtype)
        sdpa = [_ring_sdpa(cr, i) for i in range(copies)]
        row.update(
            ms=cuda_ms(lambda i: _ring_call(ra.ring_gqa_attention, cr, i), 50),
            plain_ms=cuda_ms(lambda i: _ring_call(ra.ring_gqa_attention_reference, cr, i), 5),
            library_ms=cuda_ms(lambda i: sdpa[i % copies](), 20),
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
        _shares(row)
        del sdpa, cr
        log(f"[1] K1-tp {kernel} {ring} m={m}: {json.dumps(row)}")
        rows.append(row)
    del c
    return rows


def phase1_tp():
    """K1-tp at the fleet shapes: the decoder's float (K1) and int8
    (K1-int8) rings on 2 and 8 ranks' heads, the encoder's int4 and int8
    rings (K1-enc) on 2. Returns the rows."""
    rows = []
    for i, (shape, ring, kernel, ms_) in enumerate((
            (FLEET_DEC, "float", "ring_gqa_attention", (2, 8)),
            (FLEET_DEC, "int8", "ring_gqa_attention_int8", (2, 8)),
            (FLEET_ENC, "int4", "ring_gqa_attention_enc", (2,)),
            (FLEET_ENC, "int8", "ring_gqa_attention_enc", (2,)))):
        rows += _k1tp_rows(shape, ring, kernel, ms_, 810 + i)
    return rows


# ---------------------------------------------------------------------------
# Phase 1, K4: the fixed-order RMSNorm
# ---------------------------------------------------------------------------

# Where the main path calls rms_norm: the decoder's token step (B rows of
# 3072) and the encoder's chunk (B x 80 rows of 1280), at B 1 and 16.
K4_SHAPES = {"decode B=1": (1, 3072), "decode B=16": (16, 3072),
             "encoder chunk B=16": (16 * 80, 1280)}
K4_EPS = 1e-5
K4_GATE_ROWS = 1280                   # the rows of a gate call; parts of 1, 8, 16


def _k4_inputs(rows, d, dtype, seed, copies=1, w_dtype=None):
    """Seeded x [rows, d] (N(0, 1) x 3) in `dtype`, `copies` of it, and w [d]
    = 1 + N(0, 0.1) in `w_dtype` (default f32, the model's norm weights)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [(torch.randn(rows, d, generator=g, device="cuda") * 3).to(dtype)
          for _ in range(copies)]
    w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(w_dtype or torch.float32)
    return xs, w


def _k4_check(x, w, what):
    """K4 on x against rms_norm_plain, once launched and counted: f32 within
    1e-5 of max|out| (another order of the f32 sum of squares), bf16 within
    `_bf16_tol` (that, plus one bf16 ulp: the order can move a value across
    a rounding boundary). Returns (out, err, tol)."""
    import torch
    from voxtral_tpu_torch.ops import norms
    y = _launched(norms, "rms_norm", lambda: norms.rms_norm(x, w, K4_EPS))
    ref = norms.rms_norm_plain(x, w, K4_EPS)
    torch.cuda.synchronize()
    check(y.shape == x.shape and y.dtype == x.dtype, f"{what}: {y.shape} {y.dtype}")
    check(torch.isfinite(y).all().item(), f"{what}: non-finite output")
    mx = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = _bf16_tol(mx) if x.dtype == torch.bfloat16 else 1e-5 * mx
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    return y, err, tol


def _k4_row(name, rows, d, dtype, seed):
    """K4 at a main-path shape: checked, two launches bit for bit, then the
    kernel's, the plain version's (nine launches) and F.rms_norm's times
    over copies beyond the L2. F.rms_norm with the f32 weight is the same
    function (`library_ms`; on a bf16 x torch leaves its fused kernel for the
    composite one); with the weight in x's dtype it takes torch's fused
    kernel (`library_fused_ms`; the weight rounded, so not the same
    numbers). Bound: x read and out written once, w once; 4 f32 operations
    an element."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import norms
    copies = _l2_copies(2 * rows * d * dtype.itemsize)
    xs, w = _k4_inputs(rows, d, dtype, seed, copies)
    what = f"K4 rms_norm {name} [{rows}, {d}] {dtype}"
    y, err, tol = _k4_check(xs[0], w, what)
    y2 = _launched(norms, "rms_norm", lambda: norms.rms_norm(xs[0], w, K4_EPS))
    torch.cuda.synchronize()
    check(torch.equal(y, y2), f"{what}: two launches differ")
    lib = F.rms_norm(xs[0], (d,), w, K4_EPS)
    lib_err = (lib.float() - norms.rms_norm_plain(xs[0], w, K4_EPS).float()).abs().max().item()
    check(lib_err <= tol, f"{what}: F.rms_norm err {lib_err} > tol {tol}")
    wx = w.to(dtype)
    bytes_ms, ops_ms, bound_ms, bound_by = _bound(
        2 * rows * d * dtype.itemsize + 4 * d, 4 * rows * d, torch.float32)
    row = dict(kernel="rms_norm", shape=name, rows=rows, d=d, dtype=str(dtype),
               max_abs_err=err, tol=tol, library_err=lib_err,
               ms=cuda_ms(lambda i: norms.rms_norm(xs[i % copies], w, K4_EPS), 50),
               plain_ms=cuda_ms(lambda i: norms.rms_norm_plain(xs[i % copies], w, K4_EPS), 20),
               library_ms=cuda_ms(lambda i: F.rms_norm(xs[i % copies], (d,), w, K4_EPS), 50),
               library="torch.nn.functional.rms_norm (f32 weight)",
               library_fused_ms=cuda_ms(
                   lambda i: F.rms_norm(xs[i % copies], (d,), wx, K4_EPS), 50),
               bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
    _shares(row)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _k4_scale(d, dtype, seed):
    """The decoder's ada row at width d: 1 + N(0, 0.1) cast to x's dtype
    (the call sites add 1 in that dtype)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return 1.0 + (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)


def _k4_add_check(h, delta, w, scale, what):
    """K4's fused entry on (h, delta, w, scale), once launched and counted,
    against add_rms_norm_plain (h_new exact: one f32 add rounded alike; x
    with `_k4_check`'s tolerances; with a scale in bf16, the norm's
    tolerance times max|scale| plus one ulp of the product) and, bit for
    bit in both outputs, against the unfused chain on the card: torch's
    `h + delta`, K4, torch's `* scale`. Returns (h_new, x, err, tol)."""
    import torch
    from voxtral_tpu_torch.ops import norms
    h_new, x = _launched(norms, "add_rms_norm",
                         lambda: norms.add_rms_norm(h, delta, w, K4_EPS, scale))
    ref_h, ref_x = norms.add_rms_norm_plain(h, delta, w, K4_EPS, scale)
    chain_h = h + delta
    chain_x = norms.rms_norm_kernel(chain_h, w, K4_EPS)
    if scale is not None:
        chain_x = chain_x * scale
    torch.cuda.synchronize()
    for out in (h_new, x):
        check(out.shape == h.shape and out.dtype == h.dtype, f"{what}: {out.shape} {out.dtype}")
    check(torch.isfinite(x).all().item(), f"{what}: non-finite output")
    check(torch.equal(h_new, ref_h), f"{what}: h_new differs from the plain version's h + delta")
    check(torch.equal(h_new, chain_h) and torch.equal(x, chain_x),
          f"{what}: not the unfused chain (h + delta, K4, * scale) bit for bit")
    mx = ref_x.float().abs().max().item()
    err = (x.float() - ref_x.float()).abs().max().item()
    if h.dtype != torch.bfloat16:
        tol = 1e-5 * mx
    elif scale is None:
        tol = _bf16_tol(mx)
    else:       # the norm's tolerance carried through the scale, and each side's rounding
        mxn = norms.rms_norm_plain(ref_h, w, K4_EPS).float().abs().max().item()
        tol = (_bf16_tol(mxn) * scale.float().abs().max().item()
               + 2.0 ** (np.floor(np.log2(mx)) - 7))
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    return h_new, x, err, tol


def _k4_add_row(name, rows, d, dtype, scaled, seed):
    """K4's fused entry at a main-path shape, with or without the scale:
    checked (`_k4_add_check`), two launches bit for bit, then the fused
    kernel's, the plain version's, the unfused chain's on the card (torch
    add, K4, torch mul) and the library yardstick's times over copies beyond
    the L2. Library: torch's add, F.rms_norm with the f32 weight and
    torch's mul, the same function. Bound: h and delta read and h_new and x
    written once, w (f32) and the scale once; 5 f32 operations an element
    (6 with the scale)."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import norms
    copies = _l2_copies(4 * rows * d * dtype.itemsize)
    xs, w = _k4_inputs(rows, d, dtype, seed, 2 * copies)
    hs, ds = xs[:copies], xs[copies:]
    scale = _k4_scale(d, dtype, seed) if scaled else None
    what = f"K4 add_rms_norm {name} [{rows}, {d}] {dtype} {'scale' if scaled else 'no scale'}"
    h_new, x, err, tol = _k4_add_check(hs[0], ds[0], w, scale, what)
    h2, x2 = _launched(norms, "add_rms_norm",
                       lambda: norms.add_rms_norm(hs[0], ds[0], w, K4_EPS, scale))
    torch.cuda.synchronize()
    check(torch.equal(h_new, h2) and torch.equal(x, x2), f"{what}: two launches differ")

    def chain(i):
        hn = hs[i % copies] + ds[i % copies]
        out = norms.rms_norm_kernel(hn, w, K4_EPS)
        return hn, out if scale is None else out * scale

    def library(i):
        hn = hs[i % copies] + ds[i % copies]
        out = F.rms_norm(hn, (d,), w, K4_EPS)
        return hn, out if scale is None else out * scale

    lib_h, lib_x = library(0)
    lib_err = (lib_x.float() - x.float()).abs().max().item()
    check(torch.equal(lib_h, h_new) and lib_err <= tol,
          f"{what}: library chain err {lib_err} > tol {tol}")
    nbytes = 4 * rows * d * dtype.itemsize + 4 * d + (d * dtype.itemsize if scaled else 0)
    bytes_ms, ops_ms, bound_ms, bound_by = _bound(nbytes, (5 + scaled) * rows * d,
                                                  torch.float32)
    row = dict(kernel="add_rms_norm", shape=name, rows=rows, d=d, dtype=str(dtype),
               scaled=scaled, max_abs_err=err, tol=tol, library_err=lib_err,
               ms=cuda_ms(lambda i: norms.add_rms_norm(hs[i % copies], ds[i % copies], w,
                                                       K4_EPS, scale), 50),
               plain_ms=cuda_ms(lambda i: norms.add_rms_norm_plain(
                   hs[i % copies], ds[i % copies], w, K4_EPS, scale), 20),
               chain_ms=cuda_ms(chain, 50),
               library_ms=cuda_ms(library, 50),
               library="torch add + torch.nn.functional.rms_norm (f32 weight) + torch mul",
               bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
    _shares(row)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def _k4_row_count_gate(d, dtype, seed):
    """K4 on x [1280, d] in one call, then on parts of it of 1, 8 and 16
    rows (first, middle, last) in calls of their own: every part must have
    the whole call's bits. The plain version and F.rms_norm (f32 weight,
    and the weight in x's dtype) run the same parts; whether their rows
    keep their bits is logged, not gated. Returns the log entry."""
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import norms
    (x, delta), w = _k4_inputs(K4_GATE_ROWS, d, dtype, seed, copies=2)
    wx = w.to(dtype)
    scale = _k4_scale(d, dtype, seed)

    def fused(t):                     # both outputs of the fused kernel, rows t
        return torch.cat(norms.add_rms_norm(x[t], delta[t], w, K4_EPS, scale), -1)

    fns = {"K4": lambda t: norms.rms_norm(x[t], w, K4_EPS),
           "K4 fused (h_new, x)": fused,
           "plain": lambda t: norms.rms_norm_plain(x[t], w, K4_EPS),
           "F.rms_norm": lambda t: F.rms_norm(x[t], (d,), w, K4_EPS),
           "F.rms_norm (weight in x's dtype)": lambda t: F.rms_norm(x[t], (d,), wx, K4_EPS)}
    out = {}
    for name, fn in fns.items():
        full = fn(slice(None))
        out[name] = all(torch.equal(fn(slice(lo, lo + n)), full[lo:lo + n])
                        for n in (1, 8, 16) for lo in (0, K4_GATE_ROWS // 2 - n, K4_GATE_ROWS - n))
    for name in ("K4", "K4 fused (h_new, x)"):
        check(out[name], f"{name} [{K4_GATE_ROWS}, {d}] {dtype}: a part of 1, 8 or 16 rows "
                         "has other bits than the same rows in the whole call")
    return {"d": d, "dtype": str(dtype), "rows_keep_their_bits": out}


def phase1_norm():
    """K4 at the main path's shapes (decoder [1, 3072] and [16, 3072], the
    encoder chunk [1280, 1280]; f32 and bf16, each timed), the row-count
    gate at both widths and dtypes, then the edges, for K4 and its fused
    entry: a bf16 weight, 3-D x, a strided x (h[:, 0] of [B, 2, D]), a
    contiguous view one element off alignment, odd widths on the scalar path
    (1001 f32 and bf16, 100 bf16), rows of four vectors a thread (4096
    vectors; 4001 scalars), and no rows (no launch). Returns the rows."""
    import torch
    from voxtral_tpu_torch.ops import norms
    rows = []
    for i, (name, (n, d)) in enumerate(K4_SHAPES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(_k4_row(name, n, d, dtype, 900 + i))
            for scaled in (False, True):
                rows.append(_k4_add_row(name, n, d, dtype, scaled, 930 + i))
    gates = [_k4_row_count_gate(d, dtype, 910 + j)
             for j, d in enumerate((3072, 1280)) for dtype in (torch.float32, torch.bfloat16)]
    log(f"[1] K4 rows in calls of 1, 8 and 16 rows against the whole {K4_GATE_ROWS}: "
        f"{json.dumps(gates)}")
    for dtype in (torch.float32, torch.bfloat16):
        (x,), w = _k4_inputs(16, 3072, dtype, 920, w_dtype=torch.bfloat16)
        cases = {"bf16 weight": (x, w), "3-D x": (x.reshape(2, 8, 3072), w.float())}
        (x2,), _ = _k4_inputs(32, 3072, dtype, 921)
        cases["strided rows"] = (x2.reshape(16, 2, 3072)[:, 0], w.float())
        flat = x2.reshape(-1)
        cases["misaligned rows"] = (flat[1:1 + 8 * 3072].view(8, 3072), w.float())
        for d in (1001, 100) if dtype == torch.bfloat16 else (1001,):
            (xo,), wo = _k4_inputs(24, d, dtype, 922 + d)
            cases[f"odd width {d}"] = (xo, wo)
        # rows of 4096 vectors and of 4001 scalars: 1024 threads of up to 4
        for d in (4096 * 16 // dtype.itemsize, 4001):
            (xo,), wo = _k4_inputs(8, d, dtype, 924 + d)
            cases[f"wide {d}"] = (xo, wo)
        for case, (xc, wc) in cases.items():
            what = f"K4 edge {case} {tuple(xc.shape)} {dtype} (weight {wc.dtype})"
            _, err, tol = _k4_check(xc, wc, what)
            rows.append(dict(kernel="rms_norm", edge=case, dtype=str(dtype), max_abs_err=err,
                             tol=tol))
            log(f"[1] {what}: err {err} <= tol {tol}")
            # the fused entry on the same h, delta the reversed rows (strided
            # and misaligned cases: a dense delta beside a strided h)
            delta = xc.flip(0).contiguous() * 0.5
            scale = _k4_scale(xc.shape[-1], dtype, 923)
            what = f"K4 add_rms_norm edge {case} {tuple(xc.shape)} {dtype} (weight {wc.dtype})"
            *_, err, tol = _k4_add_check(xc, delta, wc, scale, what)
            rows.append(dict(kernel="add_rms_norm", edge=case, dtype=str(dtype),
                             max_abs_err=err, tol=tol))
            log(f"[1] {what}: err {err} <= tol {tol}")
    before = dict(norms.LAUNCHES)
    e, one = torch.empty(0, 3072, device="cuda"), torch.ones(3072, device="cuda")
    empty = norms.rms_norm(e, one)
    h_new, x = norms.add_rms_norm(e, e, one, scale=one)
    check(empty.shape == h_new.shape == x.shape == (0, 3072) and norms.LAUNCHES == before,
          "K4 with no rows launched")
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the tools path
# ---------------------------------------------------------------------------

def phase6():
    """The five ported profile tools at their defaults on the card,
    through their functions. Every launch count is checked against the
    tools' structure: each timed loop calls its wrappers once to warm up
    and `iters` times inside the captured CUDA graph (replays launch
    without the wrappers); the int4-unpack tool's numeric check adds one
    T4 and one T5 call, and must hold within T5_CHECK_RTOL, the tolerance
    of its CPU test. Returns (launches, results)."""
    from voxtral_tpu_torch.tools.profile_attn_layout import profile_attn_layout
    from voxtral_tpu_torch.tools.profile_dma_ceiling import profile_dma_ceiling
    from voxtral_tpu_torch.tools.profile_int4_unpack import profile_int4_unpack
    from voxtral_tpu_torch.tools.profile_q8_matmul_roofline import (
        MATRICES, profile_q8_matmul_roofline,
    )
    from voxtral_tpu_torch.tools.profile_ring_layout2 import profile_ring_layout2
    from voxtral_tpu_torch.tools.profile_weight_stream import TENSORS, profile_weight_stream
    t0 = time.perf_counter()
    _reset_counts()                                 # the tools path starts here
    roof = profile_q8_matmul_roofline()
    stream = profile_weight_stream()
    dma = profile_dma_ceiling()
    unpack = profile_int4_unpack()
    layout = profile_attn_layout()
    ring = profile_ring_layout2()
    launches = _counts()                            # ... and ends
    want = dict.fromkeys(launches, 0)
    per_q8 = len(MATRICES) * roof["layers"] * (1 + roof["iters"])
    want.update(w8a16_gemv=per_q8, wread=per_q8, fused_logits_argmax=1 + roof["iters"],
                pure_stream=len(TENSORS) * stream["layers"] * (1 + stream["iters"]),
                bf16_matmul=len(TENSORS) * stream["layers"] * (1 + stream["iters"]),
                rd=dma["layers"] * (1 + dma["iters"]),
                attn8=unpack["layers"] * (1 + unpack["iters"]) + 1,
                attn4=unpack["layers"] * (1 + unpack["iters"]) + 1,
                attn3d=len(layout["blks"]) * layout["layers"] * (1 + layout["iters"]),
                attn4d=len(layout["blks"]) * layout["layers"] * (1 + layout["iters"]))
    per_ring = ring["layers"] * (1 + ring["iters"])       # one chain per case
    for kernel, prefix in (("rd_flat", "flat"), ("rd_blockmajor", "bm"), ("rd_g", "g")):
        want[kernel] = per_ring * sum(c.startswith(prefix) for c in ring["cases"])
    for name, res in (("profile_q8_matmul_roofline", roof),
                      ("profile_weight_stream", stream), ("profile_dma_ceiling", dma),
                      ("profile_int4_unpack", unpack), ("profile_attn_layout", layout),
                      ("profile_ring_layout2", ring)):
        log(f"[6] {name}: {json.dumps(res)}")
    check(launches == want, f"tools path launches {launches} != {want}")
    check(unpack["check_err"] <= unpack["check_tol"],
          f"T5 against T4 on identical values: {unpack['check_err']} > {unpack['check_tol']}")
    ceilings = dict(t1_int8_weights=roof["read_gbps"], t2_bf16_weights=stream["stream_gbps"],
                    t3_bf16_stack=stream["t3_gbps"], torch_matmul_stack=stream["matmul_gbps"],
                    t11_int8_rings=dma["gbps"], k2_q8_stack=roof["stack_gbps"],
                    k3_q8_logits=roof["logits_gbps"], t4_int8_attn=unpack["t4_gbps"],
                    t5_int4_attn=unpack["t5_gbps"],
                    **{f"t{t}_blk{blk}": layout[f"t{t}_gbps_{blk}"]
                       for blk in layout["blks"] for t in (6, 7)},
                    **{f"ring_read_{case}": ring[f"{case}_gbps"] for case in ring["cases"]})
    for key, v in ceilings.items():
        check(np.isfinite(v) and v > 0, f"{key}: {v} GB/s")
    ratios = dict(t5_over_t4=unpack["t5_over_t4"],
                  **{f"t7_over_t6_blk{blk}": layout[f"t7_over_t6_{blk}"]
                     for blk in layout["blks"]},
                  **{k: v for k, v in ring.items() if k.startswith(("t9_over", "t10_over"))})
    log(f"[6] time ratios: {json.dumps(ratios)}")
    log(f"[6] measured GB/s: {json.dumps(ceilings)}; launches {json.dumps(launches)}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, dict(roofline=roof, weight_stream=stream, dma_ceiling=dma,
                          int4_unpack=unpack, attn_layout=layout, ring_layout=ring)


# ---------------------------------------------------------------------------
# Phase 7: tensor parallelism on the card
# ---------------------------------------------------------------------------

TP_RANKS, TP_STREAMS, TP_STEPS = 2, 8, 3
# mode: (weight and compute dtype, ring mode). The f32 modes must give the
# one-process tokens exactly; the bf16 mode sums bf16 partial products in
# another order than one process does (row_linear's all-reduce), so it is
# held to a share of equal tokens and to the rings' values (TP_BF16_*),
# against the one-process bf16 drive and the f32 one before it.
TP_MODES = {"float": ("float32", "float"), "q8+int8+int4": ("float32", "q8+int8+int4"),
            "bf16 float": ("bfloat16", "float")}
# A token flips where the one-process top two logits lie within the
# all-reduce's rounding, and the flip changes the stream's later tokens:
# at least this share of tokens must be equal.
TP_BF16_AGREE = 0.9
# Last-layer K/V ring rows (encoder rings, audio only, on every stream;
# decoder rings on the streams whose tokens agree), each rank's lanes: TP
# may move them from the one-process bf16 drive at most this many times as
# far as bf16 moves the one-process drive from f32 (the "float" mode's).
TP_BF16_RINGS = 2.0
TP_TIMEOUT = 420.0


def _reduced_config(*dtypes):
    """voxtral_4b(*dtypes) (f32 by default) at full width, 2 encoder + 2
    decoder layers."""
    from voxtral_tpu_torch.config import voxtral_4b
    base = voxtral_4b(*dtypes)
    return dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, layers=2),
        decoder=dataclasses.replace(base.decoder, layers=2))


def _tp_mode_params(cfgs, mode, params):
    """(config, params) of TP_MODES[mode], seed-0 weights. The Q8 mode
    quantizes the f32 tree of the mode before it (`params`), in place."""
    import torch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    dtype, ring = TP_MODES[mode]
    cfg = cfgs[dtype]
    if ring.startswith("q8"):
        return cfg, quantize_params(params)
    del params
    torch.cuda.empty_cache()
    return cfg, random_params(cfg, seed=0, device="cuda")


def _tp_drive(params, cfg, streams, ring, tp):
    """A bootstrap and TP_STEPS fleet_step_masked (every stream active) of
    `streams` (numpy [B, n] PCM) on cuda, in ring mode `ring`, with `tp` or
    on one process. Returns (tokens [B_local, n] cpu, step walls in s,
    {"encoder"/"decode": (K, V)}: the last layer's ring rows that hold a
    position, [B_local, rows, lanes] cpu)."""
    import torch
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.runtime import fleet as fl
    hop, b = cfg.audio.hop_length, streams.shape[0]
    rows = slice(None) if tp is None else slice(tp.data_rank * b // tp.data_size,
                                                (tp.data_rank + 1) * b // tp.data_size)
    pcm = torch.from_numpy(np.ascontiguousarray(streams[rows])).cuda()
    bl = pcm.shape[0]
    t_ada = ada_scales(params["decoder"], time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cuda"))
    state = init_state(cfg, b, ring, "cuda", tp=tp)
    active = torch.ones(bl, dtype=torch.bool, device="cuda")
    forced = torch.full((bl, CHUNK_MEL // 8), -1, dtype=torch.int32, device="cuda")
    toks, walls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tok, _ = fl.fleet_bootstrap_pcm(params, cfg, state, pcm[:, :BOOT_MEL * hop],
                                           t_ada, tp=tp)
    toks.append(tok)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    for step in range(TP_STEPS):
        at = (BOOT_MEL + step * CHUNK_MEL) * hop
        t0 = time.perf_counter()
        state, tok, _ = fl.fleet_step_masked(params, cfg, state,
                                             pcm[:, at:at + CHUNK_MEL * hop], active, forced,
                                             t_ada, tp=tp)
        toks.append(tok)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rings = {}
    for part in ("encoder", "decode"):
        s = getattr(state, part)
        held = (s.slot_pos[0] >= 0).nonzero()[:, 0]     # the lockstep streams share it
        rings[part] = tuple(r[-1][:, held].cpu() for r in (s.k_ring, s.v_ring))
    return torch.cat(toks, dim=1).cpu(), walls, rings


def _tp_rank(rank, world, cfgs, streams):
    """One rank of phase 7: gloo over cuda:0, a (1, world) mesh, the seed-0
    weights sliced to its heads and vocab rows, each of TP_MODES driven
    with its launch counts (every count 0 just before the drive, read just
    after)."""
    import torch
    from voxtral_tpu_torch.parallel import make_mesh, shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = make_mesh(1, world, "cuda")
    params, out = None, {}
    for mode, (_, ring) in TP_MODES.items():
        cfg, params = _tp_mode_params(cfgs, mode, params)
        local = shard_params(params, cfg, tp)
        _reset_counts()                             # the TP path starts here
        tokens, walls, rings = _tp_drive(local, cfg, streams, ring, tp)
        out[mode] = dict(tokens=tokens, walls=walls, rings=rings,
                         launches=_counts())        # ... and ends
        del local
    return out


def _tp_bf16_check(mode, r, got, rings, ref, f32):
    """The bf16 mode's rank r (tokens `got`, last-layer `rings`) against
    the one-process bf16 drive `ref` and the one-process f32 drive `f32`
    (TP_BF16_AGREE, TP_BF16_RINGS). Returns (share of tokens equal to
    `ref`'s, {ring: (TP's distance from `ref`, bf16's from `f32`), each as
    a share of max|ref|})."""
    want = ref[0]
    agree = (got == want).float().mean().item()
    check(agree >= TP_BF16_AGREE, f"TP {mode} rank {r}: {agree} of the tokens equal "
                                  f"one process's < {TP_BF16_AGREE}")
    # decoder rings hold the fed-back tokens: only streams that agree
    same = (got == want).all(dim=1) & (want == f32[0]).all(dim=1)
    dists = {}
    for part, streams in (("encoder", slice(None)), ("decode", same)):
        for i, name in enumerate("KV"):
            lanes = ref[2][part][i].shape[-1] // TP_RANKS
            g = rings[part][i][streams].float()
            w, w32 = (x[2][part][i][..., r * lanes:(r + 1) * lanes][streams].float()
                      for x in (ref, f32))
            if not w.numel():
                continue
            top = w.abs().max()
            dists[f"{part} {name}"] = (((g - w).abs().max() / top).item(),
                                       ((w - w32).abs().max() / top).item())
    bad = {k: v for k, v in dists.items() if not v[0] <= TP_BF16_RINGS * v[1]}
    check(not bad, f"TP {mode} rank {r}: rings farther from one process than "
                   f"{TP_BF16_RINGS} x bf16's own distance from f32: {bad}")
    return agree, dists


def phase7():
    """Two ranks on one card (gloo on CUDA tensors, both on cuda:0), full 4B
    width, 2 + 2 layers, B = 8: the fleet step in f32 on float rings and on
    Q8 weights with int8 + int4 rings, and in bf16 on float rings, a
    bootstrap and TP_STEPS steps, against the same drive on one process:
    f32 tokens exactly, bf16 tokens and rings within TP_BF16_AGREE and
    TP_BF16_RINGS. Each rank must launch its decode ring kernel, K1-enc, K3
    and K4 (and K2 on Q8 weights). Returns (the ranks' ring attention launches,
    {mode: per-rank step walls})."""
    import torch
    from voxtral_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    cfgs = dict(float32=_reduced_config(),
                bfloat16=_reduced_config(torch.bfloat16, torch.bfloat16))
    streams = fleet_streams(cfgs["float32"],
                            [synthetic_audio(7.0, 300 + i) for i in range(TP_STREAMS)])
    params, ref = None, {}
    for mode, (_, ring) in TP_MODES.items():
        cfg, params = _tp_mode_params(cfgs, mode, params)
        ref[mode] = _tp_drive(params, cfg, streams, ring, None)
    del params
    torch.cuda.empty_cache()
    ranks = run_ranks(_tp_rank, TP_RANKS, (cfgs, streams), timeout=TP_TIMEOUT)
    ring_kernels = ("ring_gqa_attention", "ring_gqa_attention_int8", "ring_gqa_attention_enc")
    k1tp, walls = 0, {}
    for mode, (dtype, ring) in TP_MODES.items():
        want, ref_walls, _ = ref[mode]
        dec = "ring_gqa_attention" if ring == "float" else "ring_gqa_attention_int8"
        walls[mode] = dict(one_process=ref_walls)
        for r, res in enumerate(ranks):
            got, counts = res[mode]["tokens"], res[mode]["launches"]
            check(got.shape == want.shape, f"TP {mode} rank {r}: tokens {tuple(got.shape)}")
            if dtype == "float32":
                diff = (got != want).nonzero()
                check(not len(diff), f"TP {mode} rank {r}: tokens differ from one process "
                                     f"first at {diff[:1].tolist()}")
                agreed = "equal to one process"
            else:
                agree, dists = _tp_bf16_check(mode, r, got, res[mode]["rings"], ref[mode],
                                              ref["float"])
                agreed = (f"{agree} equal to one process; ring distances (TP from one "
                          f"process, bf16 from f32; shares of max|ref|) {json.dumps(dists)}")
            q8 = ring.startswith("q8")
            check(counts[dec] > 0 and counts["ring_gqa_attention_enc"] > 0
                  and counts["fused_logits_argmax"] > 0 and counts["rms_norm"] > 0
                  and counts["add_rms_norm"] > 0 and (counts["w8a16_gemv"] > 0) == q8,
                  f"TP {mode} rank {r}: launches {counts}")
            k1tp += sum(counts[k] for k in ring_kernels)
            walls[mode][f"rank{r}"] = res[mode]["walls"]
            log(f"[7] {mode} rank {r}: {got.shape[1]} tokens per stream "
                f"({len(got.unique())} distinct), {agreed}; step walls s "
                f"{json.dumps(res[mode]['walls'])}; "
                f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
        log(f"[7] {mode} one process: step walls s {json.dumps(ref_walls)}")
    log(f"[7] K1-tp launches (ring attention on the ranks' heads): {k1tp}; "
        f"{time.perf_counter() - t0:.1f} s")
    return k1tp, walls


# ---------------------------------------------------------------------------
# Phases 2 and 3: the pipeline
# ---------------------------------------------------------------------------

def _count_modules():
    from voxtral_tpu_torch.ops import bf16_matmul as bm
    from voxtral_tpu_torch.ops import layout_attention as lay
    from voxtral_tpu_torch.ops import logits_argmax as la
    from voxtral_tpu_torch.ops import norms
    from voxtral_tpu_torch.ops import q8_matmul as qm
    from voxtral_tpu_torch.ops import read_ceiling as rc
    from voxtral_tpu_torch.ops import ring_attention as ra
    from voxtral_tpu_torch.ops import ring_layout as rl
    return ra, qm, la, rc, bm, lay, rl, norms


def _reset_counts():
    """Every launch count of the port to 0 (and the Q8 large-M route's)."""
    for mod in _count_modules():
        mod.reset_launches()


def _counts():
    """{kernel: launches} of every kernel, and "q8_mm": the Q8 large-M
    route's calls (not a kernel)."""
    ra, qm, la, rc, bm, lay, rl, norms = _count_modules()
    return {**ra.LAUNCHES, **qm.LAUNCHES, **la.LAUNCHES, **rc.LAUNCHES, **bm.LAUNCHES,
            **lay.LAUNCHES, **rl.LAUNCHES, **norms.LAUNCHES, **qm.LARGE_M_CALLS}


def phase2():
    """2+2 layers at full width, f32: transcribe_tokens_batch on cuda against
    cpu, with float weights and with Q8 weights (quantize_params of the same
    tree: K2 in the decode and the prefill, K3's logits mode in the greedy
    head with collect_topk)."""
    import torch
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    audio = synthetic_audio(5.0, seed=2)
    out = {}
    for weights in ("float", "q8"):
        if weights == "q8":
            params = quantize_params(params)
        params_cpu = _cpu_copy(params)
        _reset_counts()
        t0 = time.perf_counter()
        tok_g, aux_g = transcribe_tokens_batch(params, cfg, audio, collect_topk=4,
                                               device="cuda")
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        counts = _counts()
        steps = aux_g["best_logit"].shape[-1]       # the real decode steps
        padded = _padded_steps(steps)               # the steps the calls run
        t0 = time.perf_counter()
        tok_c, aux_c = transcribe_tokens_batch(params_cpu, cfg, audio, collect_topk=4,
                                               device="cpu")
        t_cpu = time.perf_counter() - t0
        best_g, best_c = aux_g["best_logit"].cpu(), aux_c["best_logit"]
        active = aux_c["packed"][..., 0].view(torch.int32) >= 0
        err = (best_g - best_c)[active].abs().max().item()
        log(f"[2] {weights} weights, 2+2 layers f32, {audio.size / 16000:.1f} s audio, "
            f"{steps} decode steps ({padded} run): {len(tok_g)} tokens; cuda {t_gpu:.2f} s, cpu "
            f"{t_cpu:.2f} s; best_logit max abs diff {err:.3g}; launches {json.dumps(counts)}")
        check(counts["ring_gqa_attention"] == cfg.decoder.layers * padded,
              f"K1 launches {counts['ring_gqa_attention']} != {cfg.decoder.layers} x {padded}")
        q8 = weights == "q8"
        # the prefill's 38 rows and each decode step's 1 row go to K2
        want_k2 = 7 * cfg.decoder.layers * (padded + 1) if q8 else 0
        check(counts["w8a16_gemv"] >= want_k2 and (q8 or counts["w8a16_gemv"] == 0),
              f"{weights}: K2 launches {counts['w8a16_gemv']}, want >= {want_k2}")
        check(counts["fused_logits_argmax"] == (padded if q8 else 0),
              f"{weights}: K3 launches {counts['fused_logits_argmax']}")
        check(tok_g == tok_c, f"{weights}: cuda tokens {tok_g} != cpu tokens {tok_c}")
        check(err <= 1e-3, f"{weights}: best_logit diff {err} > 1e-3")
        out[weights] = dict(tokens=len(tok_g), steps=steps, best_logit_err=err)
        del params_cpu
    del params
    torch.cuda.empty_cache()
    return out


def _cpu_copy(node):
    """The param tree on the cpu, for the plain versions. Q8 codes are held
    as their f32 values (exact: |q| <= 127): the plain versions widen the
    codes to f32 on every call, which would be the same products on the
    same values, and at full width (the 131072 x 3072 table on every token)
    most of the cpu run's time."""
    from voxtral_tpu_torch.quant import Quantized
    if isinstance(node, Quantized):
        return Quantized(node.q.cpu().float(), node.s.cpu(), node.axis)
    if isinstance(node, dict):
        return {k: _cpu_copy(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_cpu_copy(v) for v in node)
    return node.cpu()


def _padded_steps(steps: int) -> int:
    """The decode steps the pipeline runs for `steps` real ones: each call's
    steps padded to its DECODE_BUCKETS width."""
    from voxtral_tpu_torch.models.pipeline import decode_calls
    return sum(nb for _, nb in decode_calls(steps))


def _key_name(key) -> str:
    """A program key's entry and its first input's shape (a decode call's
    [1, steps, D], the prefill's [positions, D], a bucket's rows)."""
    return f"{key[0]} {'x'.join(map(str, key[1][0][0]))}"


def phase3():
    """Offline serving at full 4B width and depth in bf16: three requests,
    once eager (step_graphs=False) and twice through the replayed programs
    (the default on the card: the weights' cached DecodeGraphs), each graph
    pass bit for bit equal to the eager pass in tokens and best logits.
    Returns the main path's launches and the requests' records."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.pipeline import request_graphs, transcribe_tokens_batch
    from voxtral_tpu_torch.ops import ring_attention as ra
    from voxtral_tpu_torch.runtime.fleet import state_leaves
    from voxtral_tpu_torch.weights import random_params
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[3] random 4B bf16 params on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    clips = [(3.0, 11), (8.0, 12), (10.0, 13)]
    audios = [synthetic_audio(sec, seed) for sec, seed in clips]
    passes = []
    captured = {}
    _reset_counts()                             # main path starts here
    for rep, graphs in enumerate((False, True, True)):
        results = []
        for (sec, _), audio in zip(clips, audios):
            before = ra.LAUNCHES["ring_gqa_attention"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tokens, aux = transcribe_tokens_batch(params, cfg, audio, collect_topk=4,
                                                  device="cuda", step_graphs=graphs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ra.LAUNCHES["ring_gqa_attention"] - before
            best = aux["best_logit"][0]
            steps = best.shape[-1]                  # the request's real decode steps
            padded = _padded_steps(steps)
            active = aux["packed"][0, :, 0].view(torch.int32) >= 0
            owner = request_graphs(params, cfg) if graphs else None
            new = {} if owner is None else {
                _key_name(k): v for k, v in owner.capture_s.items() if k not in captured}
            if owner is not None:
                captured.update(owner.capture_s)
            r = dict(pass_=rep, step_graphs=graphs, audio_s=sec, decode_steps=steps,
                     padded_steps=padded, tokens=len(tokens), wall_s=wall,
                     ms_per_step=1e3 * wall / steps, rtf=wall / sec, launches=launches,
                     capture_s=new, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(f"[3] request {json.dumps(r)}")
            check(launches == cfg.decoder.layers * padded,
                  f"launches {launches} != {cfg.decoder.layers} x {padded}")
            check(torch.isfinite(best[active]).all().item(), "non-finite logits")
            check(all(0 <= t < cfg.decoder.vocab_size for t in tokens),
                  "token out of range")
            results.append((tokens, best.cpu(), r))
        passes.append(results)
    main_launches = _counts()                       # main path ends here
    check(main_launches["w8a16_gemv"] == main_launches["fused_logits_argmax"] == 0,
          f"bf16 weights with collect_topk launched Q8 or fused-head kernels: "
          f"{main_launches}")
    for rep in (1, 2):
        for (t0_, b0, _), (t1, b1, r) in zip(passes[0], passes[rep]):
            check(t0_ == t1 and torch.equal(b0, b1),
                  f"graph pass {rep} != the eager pass at {r['audio_s']} s (tokens equal: "
                  f"{t0_ == t1})")
    owner = request_graphs(params, cfg)
    resident = sum(t.numel() * t.element_size() for t in state_leaves(owner.state)
                   if t is not None)
    log(f"[3] graph passes == eager pass bit for bit (tokens, best_logit); the weights' "
        f"DecodeGraphs: {len(owner._graphs)} keys, captures "
        f"{json.dumps({_key_name(k): v for k, v in owner.capture_s.items()})} "
        f"s, resident B = 1 decode state {resident / 2**30:.3f} GiB")
    # the shortest request, replayed: the profiler's own work grows with the
    # events, and a replay issues few
    r = passes[2][0][2]
    profile_request(params, cfg, audios[0], wall_s=r["wall_s"], steps=r["decode_steps"])
    return main_launches, [r for results in passes for _, _, r in results]


def profile_request(params, cfg, audio, wall_s, steps):
    """One more run of a request, replayed from its captured programs, under
    torch.profiler: device time by kernel, the device's busy share of the
    unprofiled wall time `wall_s` of the same replayed request (one stream,
    so kernels do not overlap), and the device time of each stage the
    pipeline marks with a profiler range (encoder, prefill, decode_scan;
    `steps` real decode steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    stages = ("encoder", "prefill", "decode_scan")
    padded = _padded_steps(steps)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        transcribe_tokens_batch(params, cfg, audio, collect_topk=4, device="cuda")
        torch.cuda.synchronize()
    # Kernel rows only. The trace also projects CPU op ranges and the
    # stage ranges onto the device timeline (rows named like the op, e.g.
    # "aten::mm"); those repeat their kernels' time and are left out of
    # the busy time.
    avgs = prof.key_averages()
    cpu_keys = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    rows, projected_us = [], 0.0
    for e in avgs:
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if getattr(e, "is_user_annotation", False) or e.key in cpu_keys:
            projected_us += e.self_device_time_total
        else:
            rows.append((e.self_device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    ring_us = sum(r[0] for r in rows if "ring_partial" in r[2] or "ring_merge" in r[2]
                  or "ring_dec_" in r[2])
    gemv_us = sum(r[0] for r in rows if "nvjet" in r[2] or "splitKreduce" in r[2])
    # Per stage: the kernels launched inside the stage's range (CPU-side
    # event with its children), and on the device timeline the span from
    # the stage's first kernel to its last.
    busy = {k: 0.0 for k in stages}
    span = {k: 0.0 for k in stages}
    for e in prof.events():
        if e.name in busy:
            if e.device_type == DeviceType.CPU:
                busy[e.name] += e.device_time_total
            else:
                span[e.name] += e.time_range.elapsed_us()
    log(f"[3] profile {audio.size / 16000:.1f} s replayed request, {steps} decode steps "
        f"({padded} run): "
        f"device busy {total_us / 1e3:.3f} ms of {wall_s * 1e3:.2f} ms unprofiled wall "
        f"(share {total_us / 1e6 / wall_s:.4f}; request device ms / decode steps "
        f"{total_us / 1e3 / steps:.3f}); ring attention {ring_us / 1e3:.3f} ms "
        f"({ring_us / (padded * cfg.decoder.layers):.2f} us per launch); nvjet + "
        f"splitKreduce (cuBLAS GEMV) rows {gemv_us / 1e3:.3f} ms; op ranges "
        f"on the device timeline (not counted) {projected_us / 1e3:.2f} ms; profiling "
        f"took {time.perf_counter() - t0:.1f} s")
    # A graph's kernels are not attributed to the range its replay ran in:
    # the replayed stages (prefill, decode_scan) show only their spans.
    for k in stages:
        log(f"[3]   stage {k}: device busy {busy[k] / 1e3:.3f} ms, device span "
            f"{span[k] / 1e3:.3f} ms (under the profiler)"
            + (f"; span per decode step run {span[k] / 1e3 / padded:.3f} ms"
               if k == "decode_scan" else ""))
    for us, count, key in rows[:12]:
        log(f"[3]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the fleet step
# ---------------------------------------------------------------------------

def _s16_exact(audio: np.ndarray) -> np.ndarray:
    """Audio rounded to multiples of 2^-15, so the s16 wire carries it
    exactly."""
    return (np.clip(np.round(audio * 32768.0), -32768, 32767) / 32768.0
            ).astype(np.float32)


def _fleet_drive(params, cfg, t_ada, streams, mode, plan, device):
    """Bootstrap, then one fleet_step_masked per entry of `plan` (active
    [B] bool, forced [B, 20] int32, wire None/"f32"/"s16"), on `device`.
    Returns (tokens [B, n] cpu, per-step (best_logit, top-2 vals) cpu)."""
    import torch
    from voxtral_tpu_torch.runtime import fleet as fl
    hop = cfg.audio.hop_length
    state = init_state(cfg, streams.shape[0], mode, device)
    state, tok, _ = fl.fleet_bootstrap_pcm(
        params, cfg, state, torch.from_numpy(streams[:, :BOOT_MEL * hop]).to(device),
        t_ada)
    toks, auxes = [tok.cpu()], []
    pos = BOOT_MEL * hop
    for active, forced, wire in plan:
        pcm = streams[:, pos:pos + CHUNK_MEL * hop]
        pos += CHUNK_MEL * hop
        if wire is None:
            args = [torch.from_numpy(x).to(device) for x in (pcm, active, forced)]
        else:
            if wire == "s16":
                pcm = np.round(pcm * 32768.0).astype(np.int16)
            args = [torch.from_numpy(fl.pack_wire(pcm, active, forced)).to(device),
                    None, None]
        state, tok, aux = fl.fleet_step_masked(
            params, cfg, state, *args, t_ada, collect_topk=2,
            wire_packed=wire is not None)
        toks.append(tok.cpu())
        auxes.append((aux["best_logit"].cpu(), aux["topk_vals"].cpu()))
    return torch.cat(toks, dim=1), auxes


def phase4():
    """Fleet, 2+2 layers at full width, f32, B = 2: cuda against cpu in each
    mode; float mode against the offline pipeline."""
    import torch
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    params_cpu = _cpu_copy(params)
    ada = {dev: ada_scales(p["decoder"], time_conditioning(
               cfg.streaming.delay_tokens, cfg.decoder.dim, device=dev))
           for dev, p in (("cuda", params), ("cpu", params_cpu))}
    audios = [_s16_exact(synthetic_audio(7.0, seed)) for seed in (21, 22)]
    streams = fleet_streams(cfg, audios)
    n = CHUNK_MEL // 8
    on, off = np.array([True, True]), np.array([True, False])
    free = np.full((2, n), -1, np.int32)
    forced = free.copy()
    forced[1, 3] = 1000
    plan = [(on, free, None), (off, free, "f32"), (on, forced, "s16"),
            (on, free, None)]
    batch_tokens, _ = transcribe_tokens_batch(params, cfg, audios[0], device="cuda")
    for mode in RING_MODES:
        if mode.startswith("q8"):          # the ada MLPs stay float: same t_ada
            params = quantize_params(params)
            params_cpu = _cpu_copy(params)
        _reset_counts()
        t0 = time.perf_counter()
        tok_g, aux_g = _fleet_drive(params, cfg, ada["cuda"], streams, mode, plan, "cuda")
        t_gpu = time.perf_counter() - t0
        counts = _counts()
        q8 = mode.startswith("q8")
        check((counts["w8a16_gemv"] > 0 and counts["q8_mm"] > 0) == q8
              and counts["fused_logits_argmax"] > 0, f"{mode}: launches {counts}")
        t0 = time.perf_counter()
        tok_c, aux_c = _fleet_drive(params_cpu, cfg, ada["cpu"], streams, mode, plan, "cpu")
        t_cpu = time.perf_counter() - t0
        check(tok_g.shape == tok_c.shape, f"{mode}: token shapes differ")
        check(bool((tok_g[1, 2 + n:2 + 2 * n] == -1).all()),
              f"{mode}: inactive stream emitted")
        check(int(tok_g[1, 2 + 2 * n + 3]) == 1000, f"{mode}: forced token not emitted")
        notes = []
        for sid in range(2):
            diff = (tok_g[sid] != tok_c[sid]).nonzero()
            if not len(diff):
                continue
            i = int(diff[0])
            check(mode != "float", f"float: stream {sid} differs at token {i}")
            check(i >= 2, f"{mode}: stream {sid} differs in the bootstrap")
            step, col = (i - 2) // n, (i - 2) % n
            best, vals = aux_c[step]
            gap = float(best[sid, col] - vals[sid, col, 0])
            notes.append(f"stream {sid} first differs at token {i}, cpu top-2 gap {gap:.3g}")
            check(gap < 1e-2, f"{mode}: stream {sid} differs at token {i} with "
                              f"a top-2 gap of {gap}")
        fleet0 = [int(t) for t in tok_g[0] if t >= 0]
        m = min(len(fleet0), len(batch_tokens))
        if mode == "float":
            check(m >= 40 and fleet0[:m] == list(batch_tokens[:m]),
                  f"fleet stream 0 {fleet0[:m]} != offline {batch_tokens[:m]}")
        log(f"[4] {mode}: {tok_g.shape[1]} tokens per stream, cuda {t_gpu:.2f} s, "
            f"cpu {t_cpu:.2f} s; tokens equal cuda/cpu: "
            f"{bool((tok_g == tok_c).all())}"
            + (f" ({'; '.join(notes)})" if notes else "")
            + f"; stream 0 vs offline pipeline: {fleet0[:m] == list(batch_tokens[:m])} "
              f"over {m} tokens; cuda launches {json.dumps(counts)}")
    del params, params_cpu


def phase5():
    """The fleet at full 4B width and depth in bf16, B = 16, each mode, run
    twice: run 0 eager, run 1 through step graphs from its second step (the
    first eager, the second captured, the rest replayed); the runs' tokens
    and every state tensor equal bit for bit. Returns (launches of the
    counted runs per kernel, results)."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import fleet as fl
    from voxtral_tpu_torch.runtime.step_graph import FleetStepGraphs
    from voxtral_tpu_torch.weights import random_params
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    params = random_params(cfg, seed=0, device="cuda")
    t_ada = ada_scales(params["decoder"], time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cuda"))
    b, hop = STREAMS, cfg.audio.hop_length
    n = CHUNK_MEL // 8
    chunk_s = CHUNK_MEL * hop / cfg.audio.sample_rate
    lp = cfg.streaming.prompt_len
    layers_d, layers_e = cfg.decoder.layers, cfg.encoder.layers
    streams = torch.from_numpy(fleet_streams(
        cfg, [synthetic_audio(12.0, 200 + i) for i in range(b)])).cuda()
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    forced = torch.full((b, n), -1, dtype=torch.int32, device="cuda")
    total = dict.fromkeys(_counts(), 0)
    results = {}
    # run 1's step kinds; its steady rate reads the replays among steps 2-4,
    # run 0's the same eager steps
    kinds = ["eager", "capture", "replay", "replay", "replay"]
    for mode, (kv, _) in RING_MODES.items():
        dec_kernel = "ring_gqa_attention" if kv == "float" else "ring_gqa_attention_int8"
        q8 = mode.startswith("q8")
        if q8:        # consumes the bf16 tree leaf by leaf; t_ada stays valid
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = quantize_params(params)
            torch.cuda.synchronize()
            log(f"[5] quantize_params: {time.perf_counter() - t0:.2f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, after "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        runs, finals, graphs = [], [], None
        for rep in range(2):
            state = init_state(cfg, b, mode, "cuda")
            torch.cuda.synchronize()
            base_gib = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            toks, walls = [], []

            def launches(n_dec, n_enc, n_prefill):
                """Per run of n_dec decode tokens, n_enc K1-enc calls and
                n_prefill prefilled streams: the decode ring kernel per
                layer and token, K3 per token; K4 (rms_norm) once per token,
                prefilled stream and encoder chunk (each pass's first norm),
                its fused entry (add_rms_norm) for every later norm: twice
                per decoder layer and token less the first, plus the final
                norm (2 x layers a token), 2 x layers - 1 per prefilled
                stream, twice per K1-enc call (2 x layers a chunk: the
                final norm takes the place of the first); in Q8 mode K2 for the 7
                matrices per decoder layer and token or prefilled stream
                (M = 16 or 38 rows), the large-M route for the encoder's 7
                per K1-enc call (B x 80 rows) and the adapter's 2. A replayed
                step counts the launches its graph makes."""
                want = dict.fromkeys(total, 0)
                want[dec_kernel] += layers_d * n_dec
                want["ring_gqa_attention_enc"] += n_enc
                want["fused_logits_argmax"] += n_dec
                want["rms_norm"] += n_dec + n_prefill + n_enc // layers_e
                want["add_rms_norm"] += (2 * layers_d * n_dec + (2 * layers_d - 1) * n_prefill
                                         + 2 * n_enc)
                if q8:
                    want["w8a16_gemv"] += 7 * layers_d * (n_dec + n_prefill)
                    want["q8_mm"] += 7 * n_enc + 2
                return want

            def timed(label, fn, n_dec, n_enc, n_prefill=0):
                _reset_counts()                     # a main-path run starts
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, tok, _ = fn()
                torch.cuda.synchronize()
                walls.append((label, time.perf_counter() - t0))
                got = _counts()                     # ... and ends
                want = launches(n_dec, n_enc, n_prefill)
                check(got == want, f"{mode} run {rep} {label}: launches {got} != {want}")
                for k, v in got.items():
                    total[k] += v
                toks.append(tok.clone())            # a replay's tokens live in its pool
                return st

            state = timed("bootstrap", lambda: fl.fleet_bootstrap_pcm(
                params, cfg, state, streams[:, :BOOT_MEL * hop], t_ada),
                BOOT_MEL // 8 - (lp - 1), layers_e * (BOOT_MEL // CHUNK_MEL), b)
            if rep == 1:
                graphs = FleetStepGraphs(params, cfg, state)
            pos = BOOT_MEL * hop
            for step in range(6):
                if step == 5:
                    aged = fl.age_fleet_state(cfg, state, 4096)
                    state = aged if graphs is None else graphs.load_state(aged)
                pcm = streams[:, pos:pos + CHUNK_MEL * hop]
                pos += CHUNK_MEL * hop
                if graphs is None:
                    def fn():
                        return fl.fleet_step_masked(params, cfg, state, pcm, active, forced,
                                                    t_ada)
                else:
                    def fn():
                        return graphs.step_masked(pcm, active, forced, t_ada)
                state = timed("aged" if step == 5 else f"step{step}", fn, n, layers_e)
            peak = torch.cuda.max_memory_allocated() / 2**30
            tokens = torch.cat(toks, dim=1).cpu()
            check(bool(((tokens >= 0) & (tokens < cfg.decoder.vocab_size)).all()),
                  f"{mode}: token out of range")
            runs.append(tokens)
            finals.append(state)
            step_ms = [1e3 * w for label, w in walls if label.startswith("step")]
            steady = step_ms[2:]
            r = dict(mode=mode, rep=rep, step_graphs=rep == 1, bootstrap_s=walls[0][1],
                     step_ms=step_ms, step_kinds=kinds if rep else ["eager"] * 5,
                     aged_step_ms=1e3 * walls[-1][1],
                     audio_s_per_s=b * chunk_s * len(steady) / (sum(steady) / 1e3),
                     aged_audio_s_per_s=b * chunk_s / walls[-1][1],
                     launches_per_step={k: v for k, v in launches(n, layers_e, 0).items()
                                        if v},
                     base_gib=base_gib, peak_gib=peak)
            results[(mode, rep)] = r
        check(bool((runs[0] == runs[1]).all()),
              f"{mode}: the replayed run's tokens differ from the eager run's")
        diff = _first_state_difference(finals[0], finals[1])
        check(diff is None, f"{mode}: the replayed run's state differs from the eager run's "
                            f"at {diff}")
        # one more step on each run's aged state, profiled: eager on run 0's,
        # replayed on run 1's; each over its own run's aged step wall
        pcm = streams[:, pos:pos + CHUNK_MEL * hop]
        for rep, g in ((0, None), (1, graphs)):
            r = results[(mode, rep)]
            r["device_busy_share"] = profile_fleet_step(
                params, cfg, finals[rep], pcm, active, forced, t_ada,
                r["aged_step_ms"] / 1e3, mode, g)
            log(f"[5] {json.dumps(r)}")
        graphs.close()
        del state, finals, graphs, aged
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total, results


def _first_state_difference(a, b):
    """The first field of two FleetStates whose bits differ (its path, e.g.
    "decode.k_ring[3]"), or None."""
    import torch

    def fields(state, prefix):
        for name, x in zip(state._fields, state):
            if isinstance(x, tuple) and hasattr(x, "_fields"):
                yield from fields(x, f"{prefix}{name}.")
            elif isinstance(x, tuple):
                for i, t in enumerate(x):
                    yield f"{prefix}{name}[{i}]", t
            else:
                yield prefix + name, x

    for (path, x), (_, y) in zip(fields(a, ""), fields(b, "")):
        if (x is None) != (y is None):
            return path
        if x is None:
            continue
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.contiguous().reshape(-1).view(torch.uint8),
                y.contiguous().reshape(-1).view(torch.uint8)):
            return path
    return None


def _device_activities():
    """The profiler activities of the poll and feed profiles: device
    activity only, whose kernel rows are all that `device_rows` reads."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA]


def profile_fleet_step(params, cfg, state, pcm, active, forced, t_ada, wall_s, mode,
                       graphs=None):
    """One more fleet step under torch.profiler, eager or with `graphs` its
    replay: the device's busy share of the unprofiled wall time `wall_s` of
    the previous step (same shapes, one stream of work, so kernels do not
    overlap) and the ring kernels' time. The rings are updated in place;
    `state` is not used again."""
    rows = profile_step(params, cfg, state, pcm, active, forced, t_ada, graphs)
    g = {k: (us / 1e3, n) for k, (us, n) in kernel_groups(rows).items()}
    check(g["all"][1] > 0, f"[5] the profile of the {mode} step holds no kernel")
    share = g["all"][0] / 1e3 / wall_s
    how = "eager" if graphs is None else "replayed"
    log(f"[5] profile {mode} {how} (aged state): device busy {g['all'][0]:.3f} ms of "
        f"{wall_s * 1e3:.2f} ms unprofiled wall (share {share:.4f}); K1-enc "
        f"{g['ring_enc'][0]:.3f} ms; decode ring kernel {g['ring_dec'][0]:.3f} ms; "
        f"cuBLAS GEMM rows {g['cublas'][0]:.3f} ms; K2 (w8a16) {g['k2'][0]:.3f} ms; "
        f"K3 (fused logits argmax) {g['k3'][0]:.3f} ms; K4 (rms_norm and add_rms_norm) "
        f"{g['k4'][0]:.3f} ms x{g['k4'][1]}; torch elementwise kernels "
        f"{g['elementwise'][0]:.3f} ms x{g['elementwise'][1]}; torch reductions "
        f"{g['reduce'][0]:.3f} ms x{g['reduce'][1]}")
    for us, count, key in rows[:10]:
        log(f"[5]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return share


# ---------------------------------------------------------------------------
# Phase 8: the serving runtime (FleetManager) on the card
# ---------------------------------------------------------------------------

# 8a's ring modes: float rings on f32 weights, and Q8 weights with int8
# decoder + int4 encoder rings (the serving configuration)
MGR_MODES = {"float": dict(kv_dtype="float"),
             "q8+int8+int4": dict(kv_dtype="int8", enc_kv_dtype="int4")}
MGR_GAP = 1e-2          # phase 4's exemption: a cpu top-2 logit gap below it
SERVE_B, SERVE_CHUNK, SERVE_LATE = 16, 20, 4
LATENCY_P95_MS = 480.0  # 8c: a poll's p95 under its 6-token chunk (0.48 s)


def _gap_recorder():
    """FleetManager with n_alt = 2 that keeps, for every token it appends to
    a slot's all_ids, the top-2 logit gap of that token (phase 8a's cpu
    reference: phase 4's exemption for quantized rings needs the gap)."""
    from voxtral_tpu_torch.runtime import FleetManager

    class GapRecorder(FleetManager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, n_alt=2, **kwargs)
            self.gaps = {}

        def attach(self):
            sid = super().attach()
            self.gaps[sid] = []
            return sid

        def _consume(self, sid, toks, forced, alt_info=None):
            n0 = len(self.slots[sid].all_ids)
            super()._consume(sid, toks, forced, alt_info)
            vals, _, best = alt_info
            live = [i for i, t in enumerate(toks) if forced[i] < 0 and t >= 0]
            self.gaps[sid] += [float(best[i] - vals[i][0])
                               for i in live[:len(self.slots[sid].all_ids) - n0]]
    return GapRecorder


def _serve_clips():
    """8b's sixteen clips of 4-12 s ({i: audio}) and the four attached a
    poll late."""
    clips = {i: synthetic_audio(4.0 + 8.0 * i / (SERVE_B - 1), 300 + i)
             for i in range(SERVE_B)}
    return clips, tuple(range(SERVE_B - SERVE_LATE, SERVE_B))


def _mgr_serve(mgr, clips, late=(), poll=None):
    """Serve `clips` ({name: audio}) through `mgr`: attach every clip not in
    `late`, feed 1 s pieces round-robin with a poll after each round, attach
    the `late` clips after the first poll, finish each clip once fed, then
    poll until every stream has finished (on every rank, for a manager with
    `tp`: the exit is agreed). `poll(mgr, round)` stands in for mgr.poll().
    Returns ({name: sid}, [(steps, poll wall s)])."""
    from voxtral_tpu_torch.parallel import any_across_hosts
    poll = poll or (lambda m, _: m.poll())
    sids = {name: mgr.attach() for name in clips if name not in late}
    pos = dict.fromkeys(clips, 0)
    walls = []
    for rnd in range(2000):
        done = all(mgr.is_finished(sid) for sid in sids.values()) and len(sids) == len(clips)
        if rnd and not any_across_hosts([not done])[0]:
            break
        for name, sid in sids.items():
            a = clips[name]
            if pos[name] < len(a):
                mgr.feed(sid, a[pos[name]:pos[name] + 16000])
                pos[name] += 16000
                if pos[name] >= len(a):
                    mgr.finish(sid)
        t0 = time.perf_counter()
        steps = poll(mgr, rnd)
        walls.append((steps, time.perf_counter() - t0))
        if rnd == 0:
            sids.update((name, mgr.attach()) for name in late)
    check(all(mgr.is_finished(sid) for sid in sids.values()), "streams never finished")
    return sids, walls


def _mgr_ids(mgr, sids):
    return {name: list(mgr.slots[sid].all_ids) for name, sid in sids.items()}


def _mgr_vs_cpu(mode, what, got, ref, gaps, tag="8a", against="cpu"):
    """cuda all_ids against the reference's (the cpu's, or `against`):
    equal, or on quantized rings first different where the reference's
    top-2 gap is below MGR_GAP (later tokens follow the flip, as in phase
    4). Returns notes on the differences."""
    notes = []
    for name, r in ref.items():
        g = got[name]
        if g == r:
            continue
        i = next((k for k, (x, y) in enumerate(zip(g, r)) if x != y), min(len(g), len(r)))
        check(mode != "float", f"[{tag}] float {what} {name}: cuda differs from {against} "
                               f"at token {i} of {len(r)}")
        gap = gaps[name][i] if i < len(gaps[name]) else float("inf")
        check(gap < MGR_GAP, f"[{tag}] {mode} {what} {name}: cuda differs from {against} "
                             f"at token {i} with a top-2 gap of {gap} there")
        notes.append(f"{what} {name} first differs at token {i} (gap {gap:.3g})")
    return notes


def phase8a(total):
    """FleetManager at full width, 2 + 2 layers, f32, B = 4, chunk 8 tokens,
    dec_ring 256: cuda against a cpu manager in float mode and in Q8 +
    int8 + int4 mode. Scenarios: two streams and a mid-flight attach (the
    fleet run, against the cpu); the same with pipeline_steps = 2 and over
    the s16 wire (the fleet run's tokens); streams A and C alone (float:
    the fleet run's tokens, which are the cpu's; quantized: against the
    cpu); float: a finished non-continuous stream against the cpu and
    transcribe_tokens_batch. Adds the cuda drives' launches to `total`."""
    import torch
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import FleetManager
    from voxtral_tpu_torch.weights import random_params
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    clips = {name: _s16_exact(synthetic_audio(sec, seed))
             for name, sec, seed in (("A", 2.0, 81), ("B", 1.5, 82), ("C", 1.5, 83),
                                     ("D", 1.7, 84))}
    fleet = {k: clips[k] for k in "ABC"}
    recorder = _gap_recorder()
    base = dict(chunk_tokens=8, dec_ring=256)
    for mode, rings in MGR_MODES.items():
        if mode.startswith("q8"):          # the ada MLPs stay float
            params = quantize_params(params)
        params_cpu = _cpu_copy(params)
        t0 = time.perf_counter()

        def on_cuda(clips_, late=(), **kw):
            _reset_counts()
            with FleetManager(params, cfg, **base, **rings, **kw) as mgr:
                check(mgr._graphs is not None, "[8a] a cuda manager without step graphs")
                sids, _ = _mgr_serve(mgr, clips_, late)
                for k, v in _counts().items():
                    total[k] += v
                return _mgr_ids(mgr, sids)

        def on_cpu(clips_, late=(), **kw):
            mgr = recorder(params_cpu, cfg, **base, **rings, device="cpu", **kw)
            sids, _ = _mgr_serve(mgr, clips_, late)
            return _mgr_ids(mgr, sids), {n: mgr.gaps[s] for n, s in sids.items()}

        runs = {"fleet": on_cuda(fleet, ("C",), batch=4)}
        t_cuda = time.perf_counter() - t0
        t0 = time.perf_counter()
        notes = _mgr_vs_cpu(mode, "fleet", runs["fleet"], *on_cpu(fleet, ("C",), batch=4))
        runs["pipelined"] = on_cuda(fleet, ("C",), batch=4, pipeline_steps=2)
        runs["s16"] = on_cuda(fleet, ("C",), batch=4, wire_dtype="s16")
        for what in ("pipelined", "s16"):
            check(runs[what] == runs["fleet"], f"[8a] {mode}: {what} != the fleet run")
        for name in "AC":
            solo = on_cuda({name: clips[name]}, batch=1)
            if mode == "float":      # exact on the card, so == the cpu fleet too
                check(solo[name] == runs["fleet"][name],
                      f"[8a] float: stream {name} alone != in the fleet")
            else:                    # K2's rounding follows M: held to the cpu
                notes += _mgr_vs_cpu(mode, "solo", solo,
                                     *on_cpu({name: clips[name]}, batch=1))
        if mode == "float":
            d_cuda = on_cuda({"D": clips["D"]}, batch=4, continuous=False)
            notes += _mgr_vs_cpu(mode, "finished", d_cuda,
                                 *on_cpu({"D": clips["D"]}, batch=4, continuous=False))
            want, _ = transcribe_tokens_batch(params, cfg, clips["D"], device="cuda")
            check(d_cuda["D"] == want,
                  f"[8a] finished stream {d_cuda['D']} != offline {want}")
            notes.append(f"finished D == offline pipeline over {len(want)} tokens")
        t_rest = time.perf_counter() - t0
        log(f"[8a] {mode}: tokens per stream "
            f"{ {n: len(v) for n, v in runs['fleet'].items()} }; cuda == cpu "
            + ("except where noted" if any("gap" in x for x in notes) else "everywhere")
            + "; pipelined == s16 == fleet" + "".join(f"; {x}" for x in notes)
            + f"; cuda fleet run "
              f"{t_cuda:.2f} s, the rest {t_rest:.2f} s")
        del params_cpu
    del params
    torch.cuda.empty_cache()


def phase8b(total, direct):
    """FleetManager at full 4B width and depth, bf16, Q8 weights with int8
    decoder + int4 encoder rings, B = 16, chunk 20 tokens, dec_ring 2048:
    sixteen clips of 4-12 s, four attached after the first poll, fed in
    1 s pieces, finished and drained; three runs: step graphs with
    pipeline_steps = 1, the eager step (step_graphs=False) with 1, step
    graphs with 2. Every stream of both graph runs equals the eager run's.
    The third run profiles its first poll that takes one step (that run's
    walls include the profiler's); the busy share is over the first run's
    wall of the same poll. `direct`: phase 5's direct step walls (ms) in
    this mode, {"eager": [...], "replayed": [...]}."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import FleetManager
    from voxtral_tpu_torch.weights import random_params
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    params = quantize_params(random_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    clips, late = _serve_clips()
    audio_s = sum(a.size for a in clips.values()) / cfg.audio.sample_rate
    kernels = ("ring_gqa_attention_int8", "ring_gqa_attention_enc", "w8a16_gemv",
               "fused_logits_argmax", "rms_norm", "add_rms_norm")
    ids, walls, results = [], [], []
    profiled = {}
    for rep, depth, graphs in ((0, 1, None), (1, 1, False), (2, 2, None)):

        def poll(mgr, rnd):
            # a poll takes as many steps as its fullest buffer holds chunks
            # (no watchdog restart fires on these clips)
            chunks = [len(s.buf) // mgr.chunk_samp for s in mgr.slots if s.active]
            if rep != 2 or profiled or max(chunks) != 1:
                return mgr.poll()
            profiled.update(_profiled_poll(mgr), round=rnd, rows=chunks.count(1))
            return profiled["steps"]

        mgr = FleetManager(params, cfg, SERVE_B, chunk_tokens=SERVE_CHUNK, dec_ring=2048,
                           kv_dtype="int8", enc_kv_dtype="int4",
                           pipeline_steps=depth, step_graphs=graphs)
        check((mgr._graphs is None) == (graphs is False),
              f"[8b] run {rep}: step graphs {mgr._graphs is not None}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                          # a main-path run starts
        t0 = time.perf_counter()
        sids, run_walls = _mgr_serve(mgr, clips, late, poll)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts()                          # ... and ends
        for k, v in got.items():
            total[k] += v
        check(all(got[k] > 0 for k in kernels), f"[8b] run {rep}: launches {got}")
        run_ids = _mgr_ids(mgr, sids)
        check(all(0 <= t < cfg.decoder.vocab_size for v in run_ids.values() for t in v),
              "[8b] token out of range")
        ids.append(run_ids)
        walls.append(run_walls)
        st = mgr.stats()
        poll_s = sum(w for _, w in run_walls)
        mgr.close()
        r = dict(rep=rep, pipeline_steps=depth, step_graphs=graphs is None,
                 streams=SERVE_B, audio_s=audio_s,
                 wall_s=wall, audio_s_per_s=audio_s / wall, steps=st["steps"],
                 polls=len(run_walls), steps_per_poll=[k for k, _ in run_walls],
                 poll_wall_ms=1e3 * poll_s, step_ms_total=mgr.step_ms_total,
                 host_share=1.0 - mgr.step_ms_total / (1e3 * poll_s),
                 step_ms=mgr.step_ms_total / st["steps"],
                 direct_step_ms=float(np.median(direct["eager" if graphs is False
                                                       else "replayed"])),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 hbm_used_gb=st.get("hbm_used_gb"), generated=st["generated"],
                 restarts=st["restarts"], launches={k: got[k] for k in kernels},
                 walls_include_profiler=rep == 2)
        log(f"[8b] {json.dumps(r)}")
        results.append(r)
    for rep in (0, 2):
        diff = [name for name in ids[1] if ids[rep][name] != ids[1][name]]
        check(not diff, f"[8b] run {rep} (step graphs, pipeline_steps "
                        f"{results[rep]['pipeline_steps']}) differs from the eager run on "
                        f"streams {diff}")
    check(profiled.get("steps") == 1, f"[8b] profiled poll: {profiled}")
    steps0, wall0 = walls[0][profiled["round"]]
    steps1, wall1 = walls[1][profiled["round"]]
    check(steps0 == 1, f"[8b] run 0 took {steps0} steps in the profiled poll's round")
    log(f"[8b] profiled poll through step graphs (round {profiled['round']}, "
        f"{profiled['rows']} of {SERVE_B} streams stepping): device busy "
        f"{profiled['busy_ms']:.3f} ms of the same poll's unprofiled wall {1e3 * wall0:.2f} ms "
        f"in run 0 (share {profiled['busy_ms'] / (1e3 * wall0):.4f}); the eager run's wall of "
        f"that poll {1e3 * wall1:.2f} ms ({steps1} steps); phase 5's direct step wall, median "
        f"eager {np.median(direct['eager']):.2f} ms, replayed "
        f"{np.median(direct['replayed']):.2f} ms")
    return params, cfg, results, ids[0]


def _profiled_poll(mgr):
    """mgr.poll() under torch.profiler: its steps and device busy ms (kernel
    rows only), with the main kernels' shares."""
    import torch
    from torch.profiler import profile
    with profile(activities=_device_activities()) as prof:
        steps = mgr.poll()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3

    def ms(*keys):
        return sum(r[0] for r in rows if any(k in r[2] for k in keys)) / 1e3

    out = dict(steps=steps, busy_ms=busy, k1_int8_ms=ms("ring_dec_", "ring_partial",
                                                        "ring_merge"),
               k1_enc_ms=ms("ring_enc_"), k2_ms=ms("w8a16_"),
               k3_ms=ms("logits_kernel", "logits_mma_kernel"))
    log(f"[8b] profiled poll: {json.dumps(out)}")
    for us, count, key in rows[:8]:
        log(f"[8b]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return out


def phase8c(total, params, cfg):
    """Token latency through the manager (bench.py:109-171's
    bench_latency_serving): B = 1, chunk 6 tokens (0.48 s), int8 rings on
    the Q8 weights, n_alt = 2, alt_cutoff 0.95, max_steps_per_poll = 1;
    12 warm-up feeds, then 50 timed ones; every poll's wall enters the
    distribution. Two managers, pipeline_steps = 1 and 2, take their feeds
    in turns, so both see the same conditions. Both replay step graphs,
    and each p95 must be under LATENCY_P95_MS (the chunk's 480 ms: a live
    caller must not fall behind)."""
    from voxtral_tpu_torch.runtime import FleetManager
    mgrs = []
    for depth in (1, 2):
        mgr = FleetManager(params, cfg, 1, chunk_tokens=6, dec_ring=2048, kv_dtype="int8",
                           n_alt=2, alt_cutoff=0.95, max_steps_per_poll=1,
                           pipeline_steps=depth)
        mgrs.append((mgr, mgr.attach(), np.random.RandomState(1)))

    def feed_poll(mgr, sid, rng):
        pcm = ((rng.rand(mgr.chunk_samp) - 0.5) * 0.2).astype(np.float32)
        t0 = time.perf_counter()
        mgr.feed(sid, pcm)
        took = mgr.poll()
        polls = [(time.perf_counter() - t0) * 1e3]
        while took:
            t0 = time.perf_counter()
            took = mgr.poll()
            if took:
                polls.append((time.perf_counter() - t0) * 1e3)
        return polls

    _reset_counts()                              # a main-path run starts
    for _ in range(12):
        for m in mgrs:
            feed_poll(*m)
    n0 = [m.slots[sid].generated for m, sid, _ in mgrs]
    raw = ([], [])
    for _ in range(50):
        for k, m in enumerate(mgrs):
            raw[k].append(feed_poll(*m))
    for k, v in _counts().items():               # ... and ends
        total[k] += v
    for (mgr, sid, _), polls, g0 in zip(mgrs, raw, n0):
        ms = sorted(x for p in polls for x in p)
        r = dict(pipeline_steps=mgr.pipeline_steps, step_graphs=mgr._graphs is not None,
                 p50_ms=ms[len(ms) // 2],
                 p95_ms=ms[int(len(ms) * 0.95)], max_poll_ms=ms[-1], polls=len(ms),
                 catch_up_polls=sum(len(p) - 1 for p in polls),
                 tokens_per_feed=(mgr.slots[sid].generated - g0) / 50,
                 restarts=mgr.slots[sid].restarts, chunk_s=6 * 0.08)
        log(f"[8c] {json.dumps(r)}")
        check(r["step_graphs"], "[8c] a manager without step graphs")
        check(r["p95_ms"] < LATENCY_P95_MS,
              f"[8c] pipeline_steps {mgr.pipeline_steps}: p95 {r['p95_ms']:.2f} ms is not "
              f"under {LATENCY_P95_MS} ms")
        mgr.close()


def phase8(direct):
    """Phase 8: the serving runtime on the card. Returns its main-path
    launches per kernel, 8b's Q8 tree with its config (phase 9 reuses
    them), and 8b's run 0: its result and tokens (phase 10b's reference)."""
    import torch
    total = dict.fromkeys(_counts(), 0)
    t0 = time.perf_counter()
    phase8a(total)
    log(f"[8a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, cfg, results, ids = phase8b(total, direct)
    log(f"[8b] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase8c(total, params, cfg)
    log(f"[8c] took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return total, params, cfg, (results[0], ids)


# ---------------------------------------------------------------------------
# Phase 9: VoxStream, transcribe_audio and the CLI
# ---------------------------------------------------------------------------

# The 1 s feed (first, last) profiled in a repeat, per backend: one that
# steps. At the 2 s interval the bucketed backend steps on even feeds and
# the fused one on odd feeds; with graphs, a feed whose programs replay.
STREAM_PROFILED_FEEDS = {"auto": (7, 7), "bucketed": (6, 6), "bucketed graphs": (10, 10),
                         "fused q8+int8+int4": (7, 7)}


def _timed_stream():
    """A VoxStream class that keeps its instances (`made`), the wall of each
    feed (the card synchronised at its end) and the device busy ms of the
    feeds `profiled` (first, last index), under one torch.profiler session
    (kernel rows only)."""
    import torch
    from torch.profiler import profile
    from voxtral_tpu_torch.runtime import VoxStream

    class TimedStream(VoxStream):
        made: list = []
        profiled: tuple = ()

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.walls, self.busy_ms = [], 0.0
            TimedStream.made.append(self)

        def feed(self, samples):
            k = len(self.walls)
            t0 = time.perf_counter()
            if self.profiled and k == self.profiled[0]:
                self._prof = profile(activities=_device_activities())
                self._prof.start()
            super().feed(samples)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            if self.profiled and k == self.profiled[-1]:
                self._prof.stop()
                self.busy_ms = sum(r[0] for r in device_rows(self._prof)) / 1e3
            self.walls.append(time.perf_counter() - t0)
    return TimedStream


def _stream_run(cls, params, cfg, audio, device, flush_at=None, interval_at=None,
                skew_pad=0, **sc):
    """transcribe_audio's drive (1 s feeds, then finish) of a `cls` stream
    with StreamConfig(**sc) on `device`. flush_at: the feed after which to
    flush(), with `skew_pad` zero samples more fed to a bucketed stream's
    mel there; interval_at: (feed index, seconds) for a set_interval after
    that feed. Returns the stream; `flushed` is n_generated at the flush."""
    from voxtral_tpu_torch.runtime import StreamConfig
    s = cls(params, cfg, stream_cfg=StreamConfig(**sc), device=device)
    sr = cfg.audio.sample_rate
    s.flushed = None
    for k, i in enumerate(range(0, len(audio), sr)):
        s.feed(audio[i:i + sr])
        if flush_at == k:
            s.flush()
            s.flushed = s.n_generated
            if skew_pad:
                s.mel.feed(np.zeros(skew_pad, np.float32))
        if interval_at is not None and interval_at[0] == k:
            s.set_interval(interval_at[1])
    s.finish()
    return s


def phase9a():
    """VoxStream at full width, 2 + 2 layers, f32 (TF32 off), one 3 s clip:
    bucketed, fused on float rings and fused on Q8 weights with int8 + int4
    rings, each on cuda against cpu (quantized rings: phase 4's top-2 gap
    rule); in float mode fused == bucketed == transcribe_tokens_batch on
    the card, a mid-stream set_interval on the fused backend == the batch
    pipeline, and a mid-stream flush() on the fused backend == the bucketed
    one given the fused flush's extra pcm_stream_skew samples of silence
    (the JAX package's behaviour). The bucketed stream's mel must be the
    native binding, within 2e-4 of the numpy MelStream."""
    import torch
    import voxtral_tpu_torch.runtime.stream as stream_mod
    from voxtral_tpu_torch.audio.mel import MelStream
    from voxtral_tpu_torch.audio.native import NativeMelStream, native_available
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import VoxStream, pcm_stream_skew
    from voxtral_tpu_torch.weights import random_params
    t0 = time.perf_counter()
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    audio = synthetic_audio(3.0, seed=91)
    check(native_available(), "[9a] the native mel library did not build")
    recorder = _gap_recorder()

    def on_cpu(p, backend, **sc):
        """The cpu stream; a fused one through the gap recorder."""
        if backend == "bucketed":
            return _stream_run(VoxStream, p, cfg, audio, "cpu", backend=backend, **sc), None
        made = stream_mod.FleetManager
        stream_mod.FleetManager = lambda *a, n_alt=1, **kw: recorder(*a, **kw)
        try:
            s = _stream_run(VoxStream, p, cfg, audio, "cpu", backend=backend, **sc)
        finally:
            stream_mod.FleetManager = made
        return s, s._mgr.gaps[0]

    out, notes = {}, []
    for mode, sc in (("float bucketed", dict(backend="bucketed")),
                     ("float fused", dict(backend="fused")),
                     ("q8+int8+int4 fused", dict(backend="fused", kv_dtype="int8",
                                                 enc_kv_dtype="int4"))):
        if mode.startswith("q8"):
            params = quantize_params(params)
        gpu = _stream_run(VoxStream, params, cfg, audio, "cuda", **sc)
        check(gpu.backend == sc["backend"], f"[9a] {mode}: backend {gpu.backend}")
        if sc["backend"] == "bucketed":
            check(isinstance(gpu.mel, NativeMelStream),
                  f"[9a] the bucketed stream's mel is {type(gpu.mel).__name__}")
            check(gpu._enc.capture and gpu._dec.capture,
                  "[9a] the bucketed stream does not replay graphs on the card")
            notes.append(f"bucketed on cuda: {len(gpu._enc._graphs) + len(gpu._dec._graphs)} "
                         f"program keys, {len(gpu._enc.capture_s) + len(gpu._dec.capture_s)} "
                         "captured")
        params_cpu = _cpu_copy(params)
        cpu, gaps = on_cpu(params_cpu, **sc)
        del params_cpu
        out[mode] = gpu.generated_ids
        notes += _mgr_vs_cpu(mode.split()[0], mode, {"clip": gpu.generated_ids},
                             {"clip": cpu.generated_ids}, {"clip": gaps or []}, tag="9a")
        log(f"[9a] {mode}: {len(gpu.generated_ids)} tokens, cuda "
            + ("== cpu" if gpu.generated_ids == cpu.generated_ids else "!= cpu (gap rule)"))
        if mode == "float fused":
            want, _ = transcribe_tokens_batch(params, cfg, audio, device="cuda")
            check(out["float bucketed"] == gpu.generated_ids == want,
                  "[9a] float: bucketed, fused and transcribe_tokens_batch differ")
            # The fused flush pads the skewed PCM buffer to a token boundary:
            # pcm_stream_skew (40) samples more silence than the bucketed
            # flush, as in the JAX package (ROADMAP Queue 3). Bucketed with
            # that silence fed to its mel must equal fused; without it the
            # first difference is logged.
            skew = pcm_stream_skew(cfg)
            fb, fb0, ff = (
                _stream_run(VoxStream, params, cfg, audio, "cuda", flush_at=1,
                            backend=backend, interval=0.5, skew_pad=pad)
                for backend, pad in (("bucketed", skew), ("bucketed", 0), ("fused", 0)))
            check(fb.generated_ids == ff.generated_ids and fb.flushed > 0
                  and ff.flushed > 0 and abs(fb.flushed - ff.flushed) <= 1,
                  f"[9a] mid-stream flush: bucketed {fb.flushed} / fused {ff.flushed} "
                  f"tokens at the flush; final streams equal: "
                  f"{fb.generated_ids == ff.generated_ids}")
            diff = next((i for i, (x, y) in enumerate(zip(fb0.generated_ids, ff.generated_ids))
                         if x != y), None)
            fi = _stream_run(VoxStream, params, cfg, audio, "cuda", interval_at=(1, 2.0),
                             backend="fused", interval=0.5)
            check(fi.generated_ids == want, "[9a] fused set_interval mid-stream != batch")
            notes.append(f"flush at 2 s: bucketed {fb.flushed}, fused {ff.flushed} tokens, "
                         f"fused == bucketed + {skew} samples of silence over "
                         f"{len(ff.generated_ids)} tokens (without them first different at "
                         f"token {diff}); set_interval 0.5 -> 2.0 s == batch over "
                         f"{len(want)} tokens")
    # the native frames against numpy's on the same feeds
    left = cfg.streaming.n_left_pad_tokens * cfg.audio.raw_audio_per_token
    mels = []
    for cls in (NativeMelStream, MelStream):
        m = cls(left_pad_samples=left, cfg=cfg.audio)
        for i in range(0, len(audio), 16000):
            m.feed(audio[i:i + 16000])
        m.finish()
        mels.append(m.frames().copy())
    err = float(np.abs(mels[0] - mels[1]).max())
    check(mels[0].shape == mels[1].shape and err <= 2e-4,
          f"[9a] native mel {mels[0].shape} vs numpy {mels[1].shape}, max diff {err}")
    del params
    torch.cuda.empty_cache()
    log(f"[9a] {json.dumps(dict(tokens={k: len(v) for k, v in out.items()}, notes=notes, native_mel_max_abs_diff=err, seconds=time.perf_counter() - t0))}")


def phase9b(total, q8_params, cfg):
    """VoxStream at full 4B width and depth, bf16, seed-0 weights, one 12 s
    clip (written as a 16-bit WAV and read back: the CLI's input) through
    transcribe_audio (auto: fused on float rings), the bucketed backend and
    the fused backend on phase 8b's Q8 tree with int8 + int4 rings; each
    twice with identical tokens, the second run profiling a 1 s feed that
    steps (STREAM_PROFILED_FEEDS).
    Adds the launches to `total`. Returns the WAV path's directory, the
    path and transcribe_audio's text."""
    import os
    import tempfile

    import torch
    import voxtral_tpu_torch
    import voxtral_tpu_torch.runtime as runtime
    from voxtral_tpu_torch.audio import load_wav
    from voxtral_tpu_torch.weights import random_params
    t_start = time.perf_counter()
    params = random_params(cfg, seed=0, device="cuda")
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "clip.wav")
    pcm = (np.clip(synthetic_audio(12.0, seed=92), -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + (36 + len(pcm)).to_bytes(4, "little") + b"WAVEfmt "
                + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
                + (1).to_bytes(2, "little") + (16000).to_bytes(4, "little")
                + (32000).to_bytes(4, "little") + (2).to_bytes(2, "little")
                + (16).to_bytes(2, "little") + b"data" + len(pcm).to_bytes(4, "little")
                + pcm)
    audio = load_wav(path)
    audio_s = audio.size / cfg.audio.sample_rate
    timed = _timed_stream()
    want = {"auto": ("ring_gqa_attention", "ring_gqa_attention_enc", "fused_logits_argmax",
                     "rms_norm", "add_rms_norm"),
            "bucketed": ("ring_gqa_attention", "ring_gqa_attention_enc",
                         "fused_logits_argmax", "rms_norm", "add_rms_norm"),
            "bucketed graphs": ("ring_gqa_attention", "ring_gqa_attention_enc",
                                "fused_logits_argmax", "rms_norm", "add_rms_norm"),
            "fused q8+int8+int4": ("ring_gqa_attention_int8", "ring_gqa_attention_enc",
                                   "w8a16_gemv", "fused_logits_argmax", "rms_norm",
                                   "add_rms_norm")}
    text = None
    results, eager_counts = {}, []
    for backend in want:
        ids = []
        for rep in range(2):
            timed.profiled = STREAM_PROFILED_FEEDS[backend] if rep else ()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()                          # a main-path run starts
            t0 = time.perf_counter()
            if backend == "auto":
                made = runtime.VoxStream
                runtime.VoxStream = timed
                try:
                    got = voxtral_tpu_torch.transcribe_audio((params, cfg, None), audio)
                finally:
                    runtime.VoxStream = made
                s = timed.made[-1]
                check(s.backend == "fused", f"[9b] auto took {s.backend} on the card")
                check(text is None or got == text, "[9b] transcribe_audio text differs")
                text = got
            elif backend.startswith("bucketed"):
                s = _stream_run(timed, params, cfg, audio, "cuda", backend="bucketed",
                                step_graphs=None if backend == "bucketed graphs" else False)
            else:
                s = _stream_run(timed, q8_params, cfg, audio, "cuda", backend="fused",
                                kv_dtype="int8", enc_kv_dtype="int4")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got_counts = _counts()                   # ... and ends
            for k, v in got_counts.items():
                total[k] += v
            check(all(got_counts[k] > 0 for k in want[backend]),
                  f"[9b] {backend} run {rep}: launches {got_counts}")
            check(all(0 <= t < cfg.decoder.vocab_size for t in s.generated_ids),
                  f"[9b] {backend}: token out of range")
            ids.append(s.generated_ids)
            graphs = s._mgr._graphs is not None if s._mgr is not None else s._dec.capture
            check(graphs == (backend != "bucketed"),
                  f"[9b] {backend}: step graphs {graphs}")
            if backend == "bucketed":
                eager_counts.append(got_counts)
            elif backend == "bucketed graphs":
                check(got_counts == eager_counts[rep],
                      f"[9b] bucketed run {rep}: launches with graphs {got_counts} != eager "
                      f"{eager_counts[rep]}")
            if s._mgr is not None:
                s._mgr.close()
            capture_s = ({} if s._mgr is not None else
                         {f"{g} {_key_name(k)}": v for g in ("_enc", "_dec")
                          for k, v in getattr(s, g).capture_s.items()})
            if rep == 0:
                walls0 = s.walls
                r = dict(backend=backend, step_graphs=graphs, audio_s=audio_s, wall_s=wall,
                         rtf=wall / audio_s, generated=s.n_generated,
                         ms_per_token=1e3 * wall / max(s.n_generated, 1),
                         feeds=len(s.walls), feed_ms_max=1e3 * max(s.walls),
                         feed_ms=[1e3 * w for w in s.walls], capture_s=capture_s,
                         stats=s.stats(), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches={k: got_counts[k] for k in want[backend]})
            else:
                first, last = STREAM_PROFILED_FEEDS[backend]
                check(s.busy_ms > 0, f"[9b] {backend}: profiled feeds {first}-{last} ran "
                                     "nothing on the card")
                prof_wall = sum(walls0[first:last + 1])
                r.update(profiled_feeds=[first, last],
                         busy_ms=s.busy_ms, busy_share=s.busy_ms / (1e3 * prof_wall),
                         profiled_feeds_wall_ms=1e3 * prof_wall)
        check(ids[0] == ids[1], f"[9b] {backend}: tokens differ between the two runs")
        if backend == "bucketed graphs":
            check(ids[0] == results["bucketed"],
                  "[9b] the bucketed stream's tokens with graphs != eager")
        check(len(ids[0]) > 100, f"[9b] {backend}: only {len(ids[0])} tokens")
        results[backend] = ids[0]
        log(f"[9b] {json.dumps(r)}")
    check(bool(text), "[9b] transcribe_audio returned no text")
    del params
    torch.cuda.empty_cache()
    # bf16: the two backends' products see other row counts, so their sums
    # round apart; logged, not gated (9a holds them equal in f32)
    a, b = results["auto"], results["bucketed"]
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    log(f"[9b] bf16 fused float vs bucketed: {len(a)} / {len(b)} tokens, equal up to "
        f"token {first}; Q8 + int8 + int4 {len(results['fused q8+int8+int4'])} tokens; "
        f"took {time.perf_counter() - t_start:.1f} s")
    return tmp, path, text


def phase9c(path, text):
    """The CLI as two subprocesses on the card, started together: `-i` the
    WAV and `--stdin` with its bytes, seed-0 random 4B weights, --silent.
    Both exit 0 and print transcribe_audio's text of phase 9b (same
    weights, interval and delay) and a newline."""
    import os
    t0 = time.perf_counter()
    base = [sys.executable, "-m", "voxtral_tpu_torch.cli", "--random-init", "0",
            "--silent"]
    with open(path, "rb") as f:
        data = f.read()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {"file": subprocess.Popen(base + ["-i", path], cwd=here,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE),
             "stdin": subprocess.Popen(base + ["--stdin"], cwd=here, stdin=subprocess.PIPE,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(data if name == "stdin" else None, timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        check(p.returncode == 0, f"[9c] CLI {name} exit {p.returncode}: "
                                 f"{outs[name][1].decode(errors='replace')[-2000:]}")
    check(outs["file"][0].decode() == text + "\n",
          f"[9c] CLI -i stdout ({len(outs['file'][0])} bytes) != phase 9b's "
          f"transcribe_audio text ({len(text)} chars)")
    check(outs["stdin"][0] == outs["file"][0], "[9c] CLI --stdin stdout != -i stdout")
    log(f"[9c] CLI -i and --stdin: exit 0, stdout == transcribe_audio's text "
        f"({len(text)} chars); took {time.perf_counter() - t0:.1f} s")


def phase9(q8_params, cfg):
    """Phase 9: VoxStream, transcribe_audio and the CLI on the card. Returns
    9b's main-path launches per kernel."""
    total = dict.fromkeys(_counts(), 0)
    t0 = time.perf_counter()
    phase9a()
    log(f"[9a] took {time.perf_counter() - t0:.1f} s")
    tmp, path, text = phase9b(total, q8_params, cfg)
    with tmp:
        phase9c(path, text)
    return total


# ---------------------------------------------------------------------------
# Phase 10: multi-process data parallelism through FleetManager(tp=)
# ---------------------------------------------------------------------------

DP_BATCH, DP_CHUNK, DP_RING = 4, 8, 256
DP_TIMEOUT = 600.0
DP_RING_KERNELS = ("ring_gqa_attention", "ring_gqa_attention_int8", "ring_gqa_attention_enc")
# layout: (n_data, n_model, flows)
DP_LAYOUTS = {"data 2 x model 1": (2, 1, ("basic", "churn 1", "churn 2")),
              "data 2 x model 2": (2, 2, ("meshed", "mesh churn"))}


# flow: (pipeline_steps, global batch); the flows are the CPU tests' own
# (_dp_flows)
DP_FLOWS = {"basic": (1, DP_BATCH), "churn 1": (1, DP_BATCH), "churn 2": (2, DP_BATCH),
            "meshed": (1, 2), "mesh churn": (1, 2)}
# the one-process runs' slot of each stream a flow returns (for the gaps)
DP_SLOTS = {"meshed": {0: 0, 1: 1}, "mesh churn": {"a2": 0, "a1": 1}}


def _dp_flows():
    """Phase 10a's flows, each mgr -> {stream: all_ids}, the CPU tests' own
    with their audio: tests/multihost_worker.py's churn (global row 0 churned
    on its rank while the other rows keep feeding live audio),
    test_torch_multihost.basic_flow, and test_torch_manager_mesh's meshed
    flow and slot churn. Every loop exit in them is agreed over the ranks."""
    import os
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import multihost_worker as mw
    import test_torch_manager_mesh as mesh
    import test_torch_multihost as multihost
    from voxtral_tpu_torch.parallel import any_across_hosts

    def churn(mgr):
        return {int(k): v for k, v in mw.churn_flow(mgr, np, any_across_hosts).items()}
    return {"basic": multihost.basic_flow, "churn 1": churn, "churn 2": churn,
            "meshed": mesh.meshed, "mesh churn": mesh.churn}, multihost.solo_audio


def _dp_rank(rank, world, n_data, flows):
    """One rank of phase 10a: gloo over cuda:0, an (n_data, world / n_data)
    mesh, the seed-0 weights built on the card and sliced by the manager,
    each of MGR_MODES through `flows` with its launch counts (every count
    0 just before the mode's flows, read just after)."""
    import torch
    from voxtral_tpu_torch.parallel import global_mesh
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import FleetManager
    from voxtral_tpu_torch.weights import random_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = global_mesh(n_data, world // n_data)
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    fns, _ = _dp_flows()
    out = dict(data=tp.data_rank, model=tp.model_rank)
    for mode, rings in MGR_MODES.items():
        if mode.startswith("q8"):
            params = quantize_params(params)
        _reset_counts()                          # this rank's DP path starts here
        res = {}
        for flow in flows:
            depth, batch = DP_FLOWS[flow]
            mgr = FleetManager(params, cfg, batch, chunk_tokens=DP_CHUNK, dec_ring=DP_RING,
                               pipeline_steps=depth, tp=tp, **rings)
            res[flow] = dict(streams=fns[flow](mgr), steps=mgr.steps,
                             rows=(mgr.row_lo, mgr.row_hi))
        out[mode] = dict(flows=res, launches=_counts())   # ... and ends
    return out


def _dp_reference():
    """One process on cuda, every flow of phase 10a in each of MGR_MODES
    (quantized: through _gap_recorder, for the gap rule). The churn flows'
    reference is each stream alone (B = 1). {mode: {flow: ({stream:
    (all_ids, gaps)}, steps)}}."""
    import torch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import FleetManager
    from voxtral_tpu_torch.weights import random_params
    cfg = _reduced_config()
    params = random_params(cfg, seed=0, device="cuda")
    recorder = _gap_recorder()
    fns, solo_audio = _dp_flows()
    ref = {}
    for mode, rings in MGR_MODES.items():
        if mode.startswith("q8"):
            params = quantize_params(params)
        cls = FleetManager if mode == "float" else recorder

        def one(flow, batch, *args):
            mgr = cls(params, cfg, batch, chunk_tokens=DP_CHUNK, dec_ring=DP_RING, **rings)
            got = fns[flow](mgr, *args)
            slot = DP_SLOTS.get(flow, {k: k for k in got})
            return ({k: (v, None if cls is FleetManager else list(mgr.gaps[slot[k]]))
                     for k, v in got.items()}, mgr.steps)

        solo = {g: one("basic", 1, lambda _, a=a: a)[0][0]
                for g, a in solo_audio().items()}
        ref[mode] = {"basic": one("basic", DP_BATCH), "churn": (solo, None),
                     "meshed": one("meshed", 2), "mesh churn": one("mesh churn", 2)}
    del params
    torch.cuda.empty_cache()
    return ref


def _dp_gather(layout, mode, flow, ranks):
    """The ranks' results of one flow: checks the rows (data ranks
    disjoint and complete, model ranks of a data index alike), the step
    counts (equal on every rank) and that the model ranks of a data index
    returned the same tokens. Returns ({name: all_ids}, steps)."""
    batch = DP_FLOWS[flow][1]
    n_data = DP_LAYOUTS[layout][0]
    tag = f"[10a] {layout} {mode} {flow}"
    by_data, steps = {}, set()
    for r in ranks:
        res = r[mode]["flows"][flow]
        d = r["data"]
        per = batch // n_data
        check(tuple(res["rows"]) == (d * per, (d + 1) * per),
              f"{tag}: data rank {d} serves rows {res['rows']}")
        steps.add(res["steps"])
        streams = res["streams"]
        if d in by_data:
            check(streams == by_data[d], f"{tag}: the model ranks of data rank {d} differ")
        by_data[d] = streams
    check(sorted(by_data) == list(range(n_data)), f"{tag}: data ranks {sorted(by_data)}")
    check(len(steps) == 1, f"{tag}: the ranks took {sorted(steps)} steps")
    merged = {}
    for d in sorted(by_data):
        check(not set(merged) & set(by_data[d]), f"{tag}: two data ranks hold one stream")
        merged.update(by_data[d])
    return merged, steps.pop()


def phase10a():
    """Full width, 2 + 2 layers, f32, chunk 8, dec_ring 256, in MGR_MODES:
    FleetManager(tp=) on ranks spawned over cuda:0 (gloo), against one
    process on the card. Data 2 x model 1 (global B 4): the JAX worker's
    basic flow and its asymmetric churn with pipeline_steps 1 and 2; data
    2 x model 2 (global B 2, four ranks): the meshed flow and the slot
    churn. Float rings: tokens equal; quantized: phase 4's gap rule.
    Returns (main-path launches per kernel, K1-tp launches)."""
    from voxtral_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ref = _dp_reference()
    t_ref = time.perf_counter() - t0
    total, k1tp = dict.fromkeys(_counts(), 0), 0
    for layout, (n_data, n_model, flows) in DP_LAYOUTS.items():
        t1 = time.perf_counter()
        ranks = run_ranks(_dp_rank, n_data * n_model, (n_data, flows), timeout=DP_TIMEOUT)
        t_ranks = time.perf_counter() - t1
        for mode in MGR_MODES:
            dec = "ring_gqa_attention" if mode == "float" else "ring_gqa_attention_int8"
            q8 = mode.startswith("q8")
            notes, seen = [], {}
            for flow in flows:
                got, steps = _dp_gather(layout, mode, flow, ranks)
                want, ref_steps = ref[mode]["churn" if flow.startswith("churn") else flow]
                check(sorted(got) == sorted(want),
                      f"[10a] {layout} {mode} {flow}: streams {sorted(got)}")
                notes += _mgr_vs_cpu(mode, flow, got, {k: v[0] for k, v in want.items()},
                                     {k: v[1] for k, v in want.items()}, tag="10a",
                                     against="one process")
                seen[flow] = dict(steps=steps, one_process_steps=ref_steps,
                                  tokens={str(k): len(v) for k, v in got.items()},
                                  distinct=len({t for v in got.values() for t in v}))
            for r in ranks:
                counts = r[mode]["launches"]
                check(counts[dec] > 0 and counts["ring_gqa_attention_enc"] > 0
                      and counts["fused_logits_argmax"] > 0 and counts["rms_norm"] > 0
                      and counts["add_rms_norm"] > 0 and (counts["w8a16_gemv"] > 0) == q8,
                      f"[10a] {layout} {mode} rank ({r['data']}, {r['model']}): "
                      f"launches {counts}")
                for k, v in counts.items():
                    if n_model > 1 and k in DP_RING_KERNELS:
                        k1tp += v
                    else:
                        total[k] += v
            log(f"[10a] {layout} {mode}: every stream "
                + ("equal to one process" if not notes else "as one process but: "
                   + "; ".join(notes))
                + f"; per flow {json.dumps(seen)}; launches of rank 0 "
                  f"{json.dumps({k: v for k, v in ranks[0][mode]['launches'].items() if v})}")
        log(f"[10a] {layout}: {n_data * n_model} ranks took {t_ranks:.1f} s")
    log(f"[10a] one-process references {t_ref:.1f} s; K1-tp launches on the model-2 "
        f"ranks {k1tp}; took {time.perf_counter() - t0:.1f} s")
    return total, k1tp


def _dp_serve_rank(rank, world, cfg, clips, late):
    """One rank of phase 10b: gloo over cuda:0, a (2, 1) mesh, 8b's Q8 tree
    built on the card, this rank's rows of 8b's clips served twice
    (pipeline_steps 1 and 2) through _mgr_serve, each run with its launch
    counts (0 just before, read just after), wall, steps and peak memory;
    then the mirror run (every one of 8b's clips on this rank too: 16
    streams a rank, 32 in all, so each call holds 8b's rows) and, on rank
    0, _row_count_probe."""
    import torch
    from voxtral_tpu_torch.parallel import global_mesh, host_row_range
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import FleetManager
    from voxtral_tpu_torch.weights import random_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = global_mesh(world, 1)
    params = quantize_params(random_params(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = host_row_range(tp, SERVE_B)
    mine = {i: clips[i] for i in range(lo, hi)}
    kw = dict(chunk_tokens=SERVE_CHUNK, dec_ring=2048, kv_dtype="int8", enc_kv_dtype="int4")
    runs = []
    for depth in (1, 2):
        mgr = FleetManager(params, cfg, SERVE_B, pipeline_steps=depth, tp=tp, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                          # a DP serving run starts
        t0 = time.perf_counter()
        sids, walls = _mgr_serve(mgr, mine, tuple(i for i in late if lo <= i < hi))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()                       # ... and ends
        poll_s = sum(w for _, w in walls)
        runs.append(dict(pipeline_steps=depth, ids=_mgr_ids(mgr, sids), steps=mgr.steps,
                         rows=(mgr.row_lo, mgr.row_hi), wall_s=wall, polls=len(walls),
                         step_ms=mgr.step_ms_total / mgr.steps,
                         host_share=1.0 - mgr.step_ms_total / (1e3 * poll_s),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=counts))
        del mgr
    mgr = FleetManager(params, cfg, 2 * SERVE_B, tp=tp, **kw)
    sids, _ = _mgr_serve(mgr, clips, late)
    mirror = dict(ids=_mgr_ids(mgr, sids), steps=mgr.steps, rows=(mgr.row_lo, mgr.row_hi))
    del mgr
    probe = _row_count_probe(params, cfg) if rank == 0 else None
    return dict(rank=rank, build_peak_gib=build_peak, runs=runs, mirror=mirror, probe=probe)


def _case_rows(c, sl):
    """The rows `sl` of a ring attention case (_fleet_case)."""
    def cut(t):
        return None if t is None else t[sl]
    return {**c, "q": c["q"][sl], "rings": [tuple(map(cut, r)) for r in c["rings"]],
            **{k: c[k][sl] for k in ("sp", "q_pos", "xk", "xv", "xp")}}


def _row_count_probe(params, cfg):
    """Which ops of the Q8 serving step give a row other bits when the
    call holds a DP rank's 8 streams rather than one process's 16 (a
    stream's tokens then follow its rank's share of the fleet): each
    op on 16 streams' rows of seeded input against the same op on each
    half, bit for bit, once two calls on the 16 have agreed (the op is
    deterministic). Layer 0's weights of `params`; a 20-token chunk: 25600
    samples of audio a stream for the device log-mel (f32 DFT and filter
    products), 160 mel frames for the conv stem (f32 products), one row a
    stream for the decoder's ops (every linear of layer 0: K2; the norm,
    K4; K3), 80 for the encoder's, 20 for the adapter's (every linear: the
    Q8 large-M route, torch.mm), bf16; the norms also on f32 rows, whose
    statistics' bits a bf16 output would round away (torch's mean, which
    K4 replaced, rounded the decoder's apart at 8 rows against 16); K1-int8
    and K1-enc on int8 and int4 rings at the fleet's shapes (_fleet_case).
    Returns {op: (halves equal, max |diff| over max |out|)}."""
    import torch
    from voxtral_tpu_torch.ops import ring_attention as ra
    from voxtral_tpu_torch.ops.linear import embed_logits, linear
    from voxtral_tpu_torch.ops.logits_argmax import _dispatch
    from voxtral_tpu_torch.ops.norms import add_rms_norm, rms_norm
    from voxtral_tpu_torch.quant import Quantized
    from voxtral_tpu_torch.runtime.fleet import _batched_causal_conv, _device_log_mel

    def _in_features(w):
        return (w.q if isinstance(w, Quantized) else w).shape[0]

    enc, dec = params["encoder"]["layers"][0], params["decoder"]["layers"][0]
    enc_p, e, d = params["encoder"], cfg.encoder.dim, cfg.decoder.dim
    a, frames = cfg.audio, SERVE_CHUNK * 8
    lap = a.window_size - a.hop_length
    dev = params["decoder"]["norm"].device
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=cfg.compute_dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    f32 = dict(dtype=torch.float32)
    b = SERVE_B
    x_mel = rnd(b, lap + frames * a.hop_length, **f32)
    x_c0, x_c1 = rnd(b, a.mel_bins, 2 + frames, **f32), rnd(b, e, 2 + frames, **f32)
    x_dec, x_enc = rnd(b, d), rnd(b, 80, e)
    x_dec32, x_enc32 = rnd(b, d, **f32), rnd(b, 80, e, **f32)
    ada = 1.0 + 0.1 * rnd(d)                # the decoder's scale row, in x's dtype
    ada32 = ada.float()
    ops = {  # name: op on the rows `sl` of 16 streams' inputs
        "device log-mel (f32 DFT, filters)":
            lambda sl: _device_log_mel(cfg, x_mel[sl, :lap], x_mel[sl, lap:])[0],
        "conv stem conv0 (f32 matmul)":
            lambda sl: _batched_causal_conv(x_c0[sl], enc_p["conv0_w"], enc_p["conv0_b"], 1, 2),
        "conv stem conv1 (f32 matmul)":
            lambda sl: _batched_causal_conv(x_c1[sl], enc_p["conv1_w"], enc_p["conv1_b"], 2, 1),
        # f32 rows too: a bf16 output would hide the statistics' last bits
        "rms_norm decoder (f32)": lambda sl: rms_norm(x_dec32[sl], dec["attn_norm"]),
        "rms_norm encoder (f32)": lambda sl: rms_norm(x_enc32[sl], enc["attn_norm"]),
        "rms_norm decoder (bf16)": lambda sl: rms_norm(x_dec[sl], dec["attn_norm"]),
        "rms_norm encoder (bf16)": lambda sl: rms_norm(x_enc[sl], enc["attn_norm"]),
        "add_rms_norm decoder (f32, scale)": lambda sl: torch.cat(add_rms_norm(
            x_dec32[sl], x_dec32.flip(0)[sl], dec["ffn_norm"], scale=ada32), -1),
        "add_rms_norm encoder (f32)": lambda sl: torch.cat(add_rms_norm(
            x_enc32[sl], x_enc32.flip(0)[sl], enc["ffn_norm"]), -1),
        "add_rms_norm decoder (bf16, scale)": lambda sl: torch.cat(add_rms_norm(
            x_dec[sl], x_dec.flip(0)[sl], dec["ffn_norm"], scale=ada), -1),
        "add_rms_norm encoder (bf16)": lambda sl: torch.cat(add_rms_norm(
            x_enc[sl], x_enc.flip(0)[sl], enc["ffn_norm"]), -1),
        "K3 argmax (token, value)": lambda sl: torch.stack(
            [t.float() for t in _dispatch(x_dec[sl], params["decoder"]["embed"], False, True)], 1),
        "K3 logits": lambda sl: embed_logits(x_dec[sl], params["decoder"]["embed"])}
    # every linear of layer 0: K2 in the decoder (one row a stream), the Q8
    # large-M route (torch.mm) in the encoder and the adapter
    for where, tree, rows in (("decoder", dec, 1), ("encoder", enc, 80),
                              ("adapter", params["adapter"], 20)):
        for name, w in tree.items():
            if name[0] == "w" and not name.endswith("_b"):
                x = rnd(b, rows, _in_features(w))
                ops[f"{where} {name}"] = lambda sl, x=x, w=w: linear(x[sl], w)
    # the ring kernels at the fleet's shapes: K1-int8 (decoder), K1-enc
    # (int4 encoder rings)
    for name, shape, ring, nv in (("K1-int8 decoder ring", FLEET_DEC, "int8", 500),
                                  ("K1-enc int4 encoder ring", FLEET_ENC, "int4", 400)):
        c = _fleet_case(shape, ring, b, nv, cfg.compute_dtype, 7, 1)
        ops[name] = lambda sl, c=c: _ring_call(ra.ring_gqa_attention, _case_rows(c, sl))
    out = {}
    for name, op in ops.items():
        full = op(slice(None))
        check(torch.equal(full, op(slice(None))), f"[10b] probe {name}: two calls differ")
        parts = torch.cat([op(slice(0, b // 2)), op(slice(b // 2, b))])
        diff = (parts.float() - full.float()).abs().max().item()
        out[name] = (torch.equal(parts, full), diff / full.float().abs().max().item())
    return out


def phase10b(serve_ref):
    """Full 4B width and depth, bf16, Q8 weights with int8 + int4 rings,
    chunk 20, dec_ring 2048: two ranks (data 2 x model 1) on cuda:0, 8
    streams each, serve phase 8b's 16 clips on 8b's schedule (the four late
    ones all on rank 1), once with pipeline_steps 1 and once with 2; then
    the mirror run, 16 streams a rank (every clip on both ranks), whose
    calls hold 8b's 16 rows. Gates: the two runs' tokens identical, each
    stream; every mirror stream of both ranks equal to 8b's run 0
    (`serve_ref`: its result and tokens) token for token, in 8b's steps
    (the agreed control, the lockstep cursor and gloo change no bit);
    _row_count_probe on rank 0 finds no op of the step that rounds a row
    apart at 8 rows a call against 16 (torch's mean in rms_norm did, until
    K4); so every stream of both ranks' first run (8 streams a rank) equals
    8b's run 0 token for token, and each rank's share of equal tokens (each
    stream's share and first difference logged) is at least TP_BF16_AGREE;
    rows partitioned; the ranks take equal steps. Logged beside
    8b's one process: aggregate audio-s/s (audio over the slowest rank's
    wall), per-rank steps, step ms, host share and peak GiB. Returns the
    main-path launches per kernel."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.parallel.launch import run_ranks
    ref8b, ref_ids = serve_ref
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    clips, late = _serve_clips()
    audio_s = sum(a.size for a in clips.values()) / cfg.audio.sample_rate
    ranks = run_ranks(_dp_serve_rank, 2, (cfg, clips, late), timeout=DP_TIMEOUT)
    kernels = ("ring_gqa_attention_int8", "ring_gqa_attention_enc", "w8a16_gemv",
               "fused_logits_argmax", "rms_norm", "add_rms_norm")
    total = dict.fromkeys(_counts(), 0)
    check([r["runs"][0]["rows"] for r in ranks] == [(0, SERVE_B // 2), (SERVE_B // 2, SERVE_B)],
          f"[10b] rows {[r['runs'][0]['rows'] for r in ranks]}")
    for k in range(2):
        runs = [r["runs"][k] for r in ranks]
        depth = runs[0]["pipeline_steps"]
        check(len({x["steps"] for x in runs}) == 1,
              f"[10b] pipeline_steps {depth}: rank steps {[x['steps'] for x in runs]}")
        for r, x in zip(ranks, runs):
            check(all(x["launches"][n] > 0 for n in kernels),
                  f"[10b] rank {r['rank']} pipeline_steps {depth}: launches {x['launches']}")
            for n, v in x["launches"].items():
                total[n] += v
            check(all(0 <= t < cfg.decoder.vocab_size for v in x["ids"].values() for t in v),
                  "[10b] token out of range")
        if k:
            for r in ranks:
                check(r["runs"][1]["ids"] == r["runs"][0]["ids"],
                      f"[10b] rank {r['rank']}: pipeline_steps 2 changed the tokens")
        wall = max(x["wall_s"] for x in runs)
        log(f"[10b] " + json.dumps(dict(
            pipeline_steps=depth, streams=SERVE_B, audio_s=audio_s,
            audio_s_per_s=audio_s / wall, one_process_audio_s_per_s=ref8b["audio_s_per_s"],
            one_process_steps=ref8b["steps"], one_process_step_ms=ref8b["step_ms"],
            one_process_host_share=ref8b["host_share"],
            one_process_peak_gib=ref8b["peak_gib"],
            ranks=[dict(rank=r["rank"], steps=x["steps"], polls=x["polls"], wall_s=x["wall_s"],
                        step_ms=x["step_ms"], host_share=x["host_share"],
                        peak_gib=x["peak_gib"], build_peak_gib=r["build_peak_gib"],
                        launches={n: x["launches"][n] for n in kernels})
                   for r, x in zip(ranks, runs)])))
    probe = ranks[0]["probe"]
    apart = sorted(k for k, (equal, _) in probe.items() if not equal)
    log(f"[10b] ops of the step, rows of 8 streams a call against 16 (equal, max "
        f"|diff| / max |out|): {json.dumps(probe)}; rounding rows apart: {apart}")

    def first_difference(x, y):
        return next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), min(len(x), len(y)))

    for r in ranks:
        m = r["mirror"]
        check(m["rows"] == (SERVE_B * r["rank"], SERVE_B * (r["rank"] + 1)),
              f"[10b] mirror rank {r['rank']}: rows {m['rows']}")
        check(m["steps"] == ref8b["steps"],
              f"[10b] mirror rank {r['rank']}: {m['steps']} steps, 8b {ref8b['steps']}")
        for i, ids in m["ids"].items():
            check(ids == ref_ids[i], f"[10b] mirror rank {r['rank']} stream {i} differs from "
                                     f"8b's run 0 at token {first_difference(ids, ref_ids[i])}")
    log(f"[10b] mirror run (16 streams a rank, 8b's rows a call): every stream of both "
        f"ranks equal to 8b's run 0, {ranks[0]['mirror']['steps']} steps")
    agree = {}
    for r in ranks:
        equal = tokens = 0
        for i, ids in r["runs"][0]["ids"].items():
            want = ref_ids[i]
            n, same = max(len(ids), len(want)), sum(a == b for a, b in zip(ids, want))
            agree[i] = dict(share=same / n, tokens=n,
                            first_difference=first_difference(ids, want) if same < n else None)
            equal, tokens = equal + same, tokens + n
        agree[f"rank {r['rank']}"] = equal / tokens
    log(f"[10b] tokens equal to 8b's run 0, each rank's share and each stream's (with its "
        f"first difference): {json.dumps(agree)}")
    for r in ranks:
        share = agree[f"rank {r['rank']}"]
        check(share >= TP_BF16_AGREE, f"[10b] rank {r['rank']}: {share} of its tokens equal "
                                      f"8b's < {TP_BF16_AGREE}")
    check(not apart, f"[10b] ops rounding rows apart at 8 rows a call against 16: {apart}")
    for r in ranks:
        for i, ids in r["runs"][0]["ids"].items():
            check(ids == ref_ids[i], f"[10b] rank {r['rank']} stream {i} differs from 8b's run "
                                     f"0 at token {first_difference(ids, ref_ids[i])}")
    log("[10b] every stream of both ranks (8 a rank) equal to 8b's run 0; no op rounds "
        "rows apart")
    return total


def phase10(serve_ref):
    """Phase 10: multi-process data parallelism through FleetManager(tp=).
    Returns its main-path launches per kernel (the model-2 ranks' ring
    kernels excepted) and the model-2 ranks' ring launches (K1-tp's)."""
    t0 = time.perf_counter()
    total, k1tp = phase10a()
    log(f"[10a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in phase10b(serve_ref).items():
        total[k] += v
    log(f"[10b] took {time.perf_counter() - t0:.1f} s")
    return total, k1tp


def ceiling_shares(rows):
    """Each kernel that reads what a read ceiling reads, as a share of that
    ceiling measured in this run: the ceiling's time for the same data over
    the kernel's time. K2 (bf16 x, M = 16) against T1 on the same matrix
    shape; K3 (argmax, B = 16) against T1 (int8 table) or T2 (bf16 table)
    on the [131072, 3072] table; K1-int8 (B = 16, nv = 2080) against T11's
    rate applied to the bytes of its bound. Beside each, the share of the
    data-sheet bound. T4-T7 (timed cases) against T11's rate too."""
    def one(kernel, **pick):
        return next(r for r in rows if r["kernel"] == kernel and "ms" in r
                    and all(r.get(k) == v for k, v in pick.items()))

    out = {}
    for name in K2_SHAPES:
        k2 = one("w8a16_gemv", matrix=name, b=16)
        out[f"K2 {name} M=16"] = dict(ceiling="T1", share=one("wread", matrix=name)["ms"]
                                      / k2["ms"], bound_share=k2["bound_ms"] / k2["ms"])
    for table, ceiling in (("int8", ("wread", "T1")), ("bf16", ("pure_stream", "T2"))):
        k3 = one("fused_logits_argmax", table=table, b=16, mode="argmax")
        out[f"K3 {table} B=16"] = dict(
            ceiling=ceiling[1], share=one(ceiling[0], matrix="table")["ms"] / k3["ms"],
            bound_share=k3["bound_ms"] / k3["ms"])
    t11 = one("rd")
    rate = 2 * np.prod(t11["shape"]) / t11["ms"]          # ring bytes per ms
    k1 = one("ring_gqa_attention_int8", b=16, nv=2080)
    k1_bytes = k1["bytes_ms"] * HBM_BYTES_PER_S / 1e3
    out["K1-int8 B=16 nv=2080"] = dict(ceiling="T11", share=k1_bytes / rate / k1["ms"],
                                       bound_share=k1["bound_ms"] / k1["ms"])
    for label, kernel, pick in (("T4 B=32", "attn8", {}), ("T5 B=32", "attn4", {}),
                                *((f"T{6 + i} B=16 blk={blk}", kernel, dict(blk=blk))
                                  for blk in LAYOUT_BLKS
                                  for i, kernel in enumerate(("attn3d", "attn4d")))):
        r = one(kernel, **pick)
        nbytes = r["bytes_ms"] * HBM_BYTES_PER_S / 1e3
        out[label] = dict(ceiling="T11", share=nbytes / rate / r["ms"],
                          bound_share=r["bound_ms"] / r["ms"])
    log(f"[1] shares of the measured ceilings: {json.dumps(out)}")
    return out


# What each path must launch: the serving path (phases 3, 5, 8, 9b and 10;
# q8_mm is the Q8 large-M route, not a kernel) and the tools path (phase 6).
MAIN_PATH = ("ring_gqa_attention", "ring_gqa_attention_int8", "ring_gqa_attention_enc",
             "w8a16_gemv", "fused_logits_argmax", "rms_norm", "add_rms_norm", "q8_mm")
TOOLS_PATH = ("wread", "pure_stream", "bf16_matmul", "rd", "w8a16_gemv",
              "fused_logits_argmax", "attn8", "attn4", "attn3d", "attn4d", "rd_flat",
              "rd_blockmajor", "rd_g")


def _kernel_entry(rows, launches, name, source, replaces, pick):
    """The kernel's entry of the `kernels` line: its launches on the main
    path, its largest error over every phase-1 case, and the numbers of the
    timed case that `pick` names."""
    mine = [r for r in rows if r["kernel"] == name]
    rep = next(r for r in mine if "ms" in r and all(r[k] == v for k, v in pick.items()))
    return dict(name=name, route="cuda", source="voxtral_tpu_torch/csrc/" + source,
                replaces=replaces, launches=launches[name],
                max_abs_err=max(r["max_abs_err"] for r in mine),
                ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
                bound_by=rep["bound_by"], library_ms=rep["library_ms"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    # f32 references run in full f32 (the port's conv avoids cuDNN anyway)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase0()
    rows = (phase1() + phase1_fleet() + phase1_dec_edges() + phase1_edges() + phase1_q8()
            + phase1_tools()
            + phase1_layout() + phase1_ring_layout() + phase1_tp() + phase1_norm())
    ceiling_shares(rows)
    log(f"[1] done at {time.perf_counter() - t_start:.1f} s")
    phase2()
    log(f"[2] done at {time.perf_counter() - t_start:.1f} s")
    launches3, _ = phase3()
    log(f"[3] done at {time.perf_counter() - t_start:.1f} s")
    phase4()
    log(f"[4] done at {time.perf_counter() - t_start:.1f} s")
    launches5, results5 = phase5()
    log(f"[5] done at {time.perf_counter() - t_start:.1f} s")
    tool_launches, _ = phase6()
    log(f"[6] done at {time.perf_counter() - t_start:.1f} s")
    for k in TOOLS_PATH:
        check(tool_launches[k] > 0, f"the tools path launched no {k} kernel")
    k1tp_launches, _ = phase7()
    log(f"[7] done at {time.perf_counter() - t_start:.1f} s")
    check(k1tp_launches > 0, "the TP path launched no ring attention kernel")
    launches8, q8_params, cfg4b, serve_ref = phase8(
        {"eager": results5[("q8+int8+int4", 0)]["step_ms"][2:],
         "replayed": results5[("q8+int8+int4", 1)]["step_ms"][2:]})
    log(f"[8] done at {time.perf_counter() - t_start:.1f} s")
    launches9 = phase9(q8_params, cfg4b)
    del q8_params
    torch.cuda.empty_cache()
    log(f"[9] done at {time.perf_counter() - t_start:.1f} s")
    launches10, k1tp10 = phase10(serve_ref)
    log(f"[10] done at {time.perf_counter() - t_start:.1f} s")
    launches = {k: launches3[k] + launches5[k] + launches8[k] + launches9[k] + launches10[k]
                for k in launches3}
    log(f"[10] main-path launches (phases 3, 5, 8, 9b and 10 but the model-2 ranks' ring "
        f"kernels; q8_mm counts the Q8 large-M route's calls): {json.dumps(launches)}")
    for k in MAIN_PATH:
        check(launches[k] > 0, f"the main path launched no {k} kernel")
    attention = "voxtral_tpu/ops/pallas_attention.py:204"
    kernels = [   # K1 at the offline pipeline's first decode step, in bf16
        _kernel_entry(rows, launches, "ring_gqa_attention", "ring_attention.cu",
                      attention, dict(b=1, nv=102, dtype="torch.bfloat16")),
        _kernel_entry(rows, launches, "ring_gqa_attention_int8", "ring_attention.cu",
                      attention, dict(b=16, nv=2080)),
        _kernel_entry(rows, launches, "ring_gqa_attention_enc", "ring_attention_enc.cu",
                      attention, dict(b=16, nv=928, ring="int4")),
        # K2 has no Pallas counterpart: it replaces an XLA mixed-dtype dot
        _kernel_entry(rows, launches, "w8a16_gemv", "w8a16.cu",
                      "voxtral_tpu/ops/linear.py:25-29", dict(b=16, matrix="w1/w3")),
        _kernel_entry(rows, launches, "fused_logits_argmax", "logits_argmax.cu",
                      "tools/profile_logits.py:57", dict(b=16, table="int8", mode="argmax")),
        # K4 has no Pallas counterpart: it replaces an XLA fusion; its numbers
        # are the decoder's token step at B 16 in bf16
        _kernel_entry(rows, launches, "rms_norm", "rms_norm.cu", "voxtral_tpu/ops/norms.py:14",
                      dict(rows=16, d=3072, dtype="torch.bfloat16")),
        # K4's fused entry replaces the XLA fusion of the residual add, the
        # norm and the ada multiply; its numbers: the token step's ffn_norm
        _kernel_entry(rows, launches, "add_rms_norm", "rms_norm.cu",
                      "voxtral_tpu/models/decoder.py:477-479",
                      dict(rows=16, d=3072, dtype="torch.bfloat16", scaled=True)),
        # the tools path's kernels, with their launches there (phase 6)
        _kernel_entry(rows, tool_launches, "wread", "read_ceiling.cu",
                      "tools/profile_q8_matmul_roofline.py:85", dict(matrix="w1/w3")),
        _kernel_entry(rows, tool_launches, "pure_stream", "read_ceiling.cu",
                      "tools/profile_weight_stream.py:73", dict(matrix="w13")),
        _kernel_entry(rows, tool_launches, "bf16_matmul", "bf16_matmul.cu",
                      "tools/profile_weight_stream.py:98", dict(matrix="w13")),
        _kernel_entry(rows, tool_launches, "rd", "read_ceiling.cu",
                      "tools/profile_dma_ceiling.py:28", {}),
        _kernel_entry(rows, tool_launches, "attn8", "layout_attention.cu",
                      "tools/profile_int4_unpack.py:83", dict(b=32)),
        _kernel_entry(rows, tool_launches, "attn4", "layout_attention.cu",
                      "tools/profile_int4_unpack.py:131", dict(b=32)),
        _kernel_entry(rows, tool_launches, "attn3d", "layout_attention.cu",
                      "tools/profile_attn_layout.py:52", dict(blk=512)),
        _kernel_entry(rows, tool_launches, "attn4d", "layout_attention.cu",
                      "tools/profile_attn_layout.py:87", dict(blk=512)),
        _kernel_entry(rows, tool_launches, "rd_flat", "ring_layout.cu",
                      "tools/profile_ring_layout2.py:50", dict(b=RL_STREAMS)),
        _kernel_entry(rows, tool_launches, "rd_blockmajor", "ring_layout.cu",
                      "tools/profile_ring_layout2.py:64", dict(b=RL_STREAMS, blk=512)),
        _kernel_entry(rows, tool_launches, "rd_g", "ring_layout.cu",
                      "tools/profile_ring_layout2.py:121", dict(b=RL_STREAMS, g=4, blk=512)),
        # K1-tp: the ring kernels on each rank's heads, launched on the TP paths
        # (phase 7 and phase 10a's model-2 ranks); its numbers are rank 0's
        # call at m = 2 (int8 decode rings)
        _kernel_entry(rows, {"ring_gqa_attention_tp": k1tp_launches + k1tp10},
                      "ring_gqa_attention_tp", "ring_attention.cu",
                      "voxtral_tpu/ops/pallas_attention.py:370",
                      dict(base="ring_gqa_attention_int8", m=2)),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
