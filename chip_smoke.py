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
     decoder's five Q8 matrix shapes, M = 1 and 16, f32 and bf16 (and the
     prefill's M = 38, the largest M = 64); K3 (fused tied logits + argmax)
     in argmax and logits mode on int8 and bf16 tables at B = 1 and 16, an
     f32 table, f32 queries, and constructed ties (the first index wins).
     The tools' kernels at the tools' shapes: T1 (wread) at the decoder's
     Q8 matrices and T11 (rd) at [16, 2088, 1024] rings, bit for bit; T2
     (pure_stream) at the five merged bf16 tensors, whose per-block word
     sums must add up to the tensor's (every byte read) and whose time must
     grow with the bytes; T3 (bf16_matmul) at the same tensors, B = 24,
     within 1e-4 of max|y|; ragged shapes checked. T4 (attn8, int8 rings)
     and T5 (attn4, nibble-packed rings) at B = 32, P = 2088; T6 (attn3d)
     and T7 (attn4d, block-major rings) at B = 16, P = 2088, blk 256, 512
     and 1024, with the tool's positions and with masked slots and a fully
     masked stream (exact zeros), T6 == T7 bit for bit; P = 77 and B = 1
     checked; all within two bf16 ulps of max|out|.
  2. Offline, reduced depth (2 encoder + 2 decoder layers), full 4B width,
     f32: transcribe_tokens_batch on cuda (kernels) and on cpu (plain
     versions) must give equal tokens and best logits, with float weights
     and with Q8 weights (quantize_params: K2 and K3 on the card).
  3. Offline serving at full 4B width and depth in bf16: three requests
     (about 3 s, 8 s and 15 s of audio), run twice; tokens must be
     identical, and K1's launch count must equal 26 x decode steps.
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
     read whole), run twice (tokens identical), with every kernel's
     launches (and the Q8 large-M route's calls) checked per step and one
     profiled step.
  6. The tools path: the five ported profile tools at their defaults
     (voxtral_tpu_torch.tools: the Q8 roofline through K2, T1 and K3; the
     bf16 weight stream through torch.matmul, T2 and T3; the ring read
     ceiling through T11; the int4 unpack through T4 and T5, with its
     numeric check; the ring layout through T6 and T7), every launch count
     checked, their GB/s and the ratios T5 / T4 and T7 / T6 logged.
The next-to-last lines are the card's name/power limit and one JSON object
with each kernel's numbers; the last line is the run's result as JSON.
Weights are random (seeded): tokens are meaningless but deterministic.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

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
CHUNK_MEL, BOOT_MEL, DEC_RING, ENC_RING = 160, 320, 2048, 840


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def synthetic_audio(seconds: float, seed: int) -> np.ndarray:
    """A gliding tone with harmonics over noise, 16 kHz f32."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 150.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6.28)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    tone = sum(np.sin(k * phase) / k for k in (1, 2, 3))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t) ** 2
    return (0.1 * tone * env + 0.01 * rng.randn(t.size)).astype(np.float32)


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
    version). Also: the call went through `kernel`, the rows with an invalid
    query position are zero, and so is every row when all positions are
    invalid."""
    import torch
    from voxtral_tpu_torch.ops import ring_attention as ra
    before = dict(ra.LAUNCHES)
    out = _ring_call(ra.ring_gqa_attention, c)
    ref = _ring_call(ra.ring_gqa_attention_reference, c)
    dead = _ring_call(ra.ring_gqa_attention, c,
                      q_pos=torch.full_like(c["q_pos"], SLOT_INVALID))
    torch.cuda.synchronize()
    check(ra.LAUNCHES[kernel] == before[kernel] + 2,
          f"{what}: the call did not go through {kernel}")
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
        del sdpa
    log(f"[1] {what}: {json.dumps(row)}")
    return row


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


# The decoder's seven Q8 matrices, five shapes (K, N): wq, wk and wv, wo,
# w1 and w3, w2.
K2_SHAPES = {"wq": (3072, 4096), "wk/wv": (3072, 1024), "wo": (4096, 3072),
             "w1/w3": (3072, 9216), "w2": (9216, 3072)}
VOCAB, DIM = 131072, 3072


def _k2_row(name, k, n, m, dtype, seed, timed):
    """K2 (w8a16_gemv) against q8_matmul_plain on x [m, k] and Q8 weights
    [k, n] quantized from N(0, 0.02). Tolerance: f32 1e-5 of max|y| (same
    products, another summation order); bf16 one bf16 ulp of max|y| (the
    order can move a value across a rounding boundary) plus the same
    1e-5 term. If `timed`: the kernel's, the plain version's and the
    yardstick's CUDA-graph times over weight copies that exceed the L2, and
    the bound (weight codes, scales, x and y once; 2 m k n operations at
    the rate of x's dtype). The yardstick is torch.mm of the same x with a
    bf16 weight of the same shape: twice the weight bytes."""
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
    tol = 1e-5 * mx
    if dtype == torch.bfloat16:
        tol += 2.0 ** (np.floor(np.log2(mx)) - 7)
    what = f"K2 {name} (K {k}, N {n}) M={m} {dtype}"
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    row = dict(kernel="w8a16_gemv", matrix=name, k=k, n=n, b=m, dtype=str(dtype),
               max_abs_err=err, tol=tol)
    if timed:
        elt = dtype.itemsize
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(
            k * n + 4 * n + m * k * elt + m * n * elt, 2 * m * k * n, dtype)
        wb = [torch.randn(k, n, generator=g, device="cuda").to(dtype) for _ in range(copies)]
        row.update(
            ms=cuda_ms(lambda i: qm.w8a16_gemv(x, ws[i % copies].q, ws[i % copies].s), 50),
            plain_ms=cuda_ms(lambda i: qm.q8_matmul_plain(x, ws[i % copies].q,
                                                          ws[i % copies].s), 5),
            library_ms=cuda_ms(lambda i: torch.mm(x, wb[i % copies]), 50),
            library="torch.mm, bf16 weight", bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        del wb
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
    of the kernel, the plain version and (bf16 table) the yardstick
    torch.mm(h, T.t(), out_dtype=f32) [+ torch.argmax: two calls], and the
    bound (table, scales, h and the output once; 2 b v d operations at the
    rate of h's dtype)."""
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
        row.update(max_abs_err=float(((out != ref) & ~near).sum().item()), tol=0.0,
                   near_ties=int(near.sum().item()))
    if timed:
        elt, h_elt = table.element_size(), h.element_size()
        nbytes = v * DIM * elt + (4 * v if scales is not None else 0) + b * DIM * h_elt \
            + (4 * b * v if logits else 4 * b)
        bytes_ms, ops_ms, bound_ms, bound_by = _bound(nbytes, 2 * b * v * DIM, h_dtype)
        lib = None
        if table_kind == "bf16":
            if logits:
                lib = cuda_ms(lambda i: torch.mm(h, table.t(), out_dtype=torch.float32), 20)
            else:
                lib = cuda_ms(lambda i: torch.argmax(
                    torch.mm(h, table.t(), out_dtype=torch.float32), dim=-1), 20)
        plain = la.tied_logits_plain if logits else la.logits_argmax_plain
        row.update(
            ms=cuda_ms(lambda i: la.fused_logits_argmax(h, table, scales, logits=logits), 20),
            plain_ms=cuda_ms(lambda i: plain(h, table, scales), 3),
            library_ms=lib, library=None if lib is None else
            "torch.mm(out_dtype=f32)" + ("" if logits else " + torch.argmax (two calls)"),
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[1] {what}: {json.dumps(row)}")
    return row


def phase1_q8():
    """K2 at the decoder's five Q8 shapes (M = 1 offline, 16 fleet; f32 and
    bf16, bf16 timed; M = 38, the prefill's rows, and 64, the kernel's
    largest, checked), and K3 in both modes on int8 and bf16 tables at B = 1
    and 16 (timed), an f32 table at a small V and a constructed tie
    (checked). Returns the rows."""
    import torch
    rows, seed = [], 500
    for name, (k, n) in K2_SHAPES.items():
        for m in (1, 16):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                rows.append(_k2_row(name, k, n, m, dtype, seed, dtype == torch.bfloat16))
    rows.append(_k2_row("wq", *K2_SHAPES["wq"], 38, torch.bfloat16, 590, False))
    rows.append(_k2_row("w2", *K2_SHAPES["w2"], 64, torch.float32, 591, False))
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
    for m in (1, 16, 64):
        rows.append(_t3_row("wq", *MERGED["wq"], m, 730 + m, False))
    rows.append(_t3_row("ragged", 1536 + 72, 1000, 5, 731, False))
    rows.append(_t11_row(T11_SHAPE, 0.375, 740, True))
    rows.append(_t11_row(T11_SHAPE, 1.0e-3, 741, False))
    rows.append(_t11_row((3, 77, 528), -2.5e-4, 742, False))
    return rows


# T4-T7: the attention kernels of tools/profile_int4_unpack.py (int8 and
# nibble-packed rings, B = 32) and tools/profile_attn_layout.py (masked,
# scaled, [B, P, 1024] and block-major [B, nb, P, blk] rings, B = 16).
LAYOUT_P, LAYOUT_KV, LAYOUT_BLKS = 2088, 1024, (256, 512, 1024)


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
    and ragged ones (P = 77, B = 1; 4 kv heads), T6 and T7 at the layout
    tool's (B = 16, P = 2088, each blk timed), each blk also masked (checked),
    and P = 77, B = 1 masked (checked). Returns the rows."""
    rows = []
    for kernel in ("attn8", "attn4"):
        rows.append(_t45_row(kernel, 32, LAYOUT_P, LAYOUT_KV, 750, True))
        rows.append(_t45_row(kernel, 1, 77, LAYOUT_KV, 751, False))
        rows.append(_t45_row(kernel, 5, 300, 512, 752, False))
    for i, blk in enumerate(LAYOUT_BLKS):
        rows += _t67_rows(16, LAYOUT_P, blk, 760 + i, True, False)
        rows += _t67_rows(16, LAYOUT_P, blk, 770 + i, False, True)
    rows += _t67_rows(1, 77, 256, 780, False, True)
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
    from voxtral_tpu_torch.tools.profile_weight_stream import TENSORS, profile_weight_stream
    t0 = time.perf_counter()
    _reset_counts()                                 # the tools path starts here
    roof = profile_q8_matmul_roofline()
    stream = profile_weight_stream()
    dma = profile_dma_ceiling()
    unpack = profile_int4_unpack()
    layout = profile_attn_layout()
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
    for name, res in (("profile_q8_matmul_roofline", roof),
                      ("profile_weight_stream", stream), ("profile_dma_ceiling", dma),
                      ("profile_int4_unpack", unpack), ("profile_attn_layout", layout)):
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
                       for blk in layout["blks"] for t in (6, 7)})
    for key, v in ceilings.items():
        check(np.isfinite(v) and v > 0, f"{key}: {v} GB/s")
    ratios = dict(t5_over_t4=unpack["t5_over_t4"],
                  **{f"t7_over_t6_blk{blk}": layout[f"t7_over_t6_{blk}"]
                     for blk in layout["blks"]})
    log(f"[6] time ratios: {json.dumps(ratios)}")
    log(f"[6] measured GB/s: {json.dumps(ceilings)}; launches {json.dumps(launches)}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, dict(roofline=roof, weight_stream=stream, dma_ceiling=dma,
                          int4_unpack=unpack, attn_layout=layout)


# ---------------------------------------------------------------------------
# Phases 2 and 3: the pipeline
# ---------------------------------------------------------------------------

def _count_modules():
    from voxtral_tpu_torch.ops import bf16_matmul as bm
    from voxtral_tpu_torch.ops import layout_attention as lay
    from voxtral_tpu_torch.ops import logits_argmax as la
    from voxtral_tpu_torch.ops import q8_matmul as qm
    from voxtral_tpu_torch.ops import read_ceiling as rc
    from voxtral_tpu_torch.ops import ring_attention as ra
    return ra, qm, la, rc, bm, lay


def _reset_counts():
    """Every launch count of the port to 0 (and the Q8 large-M route's)."""
    for mod in _count_modules():
        mod.reset_launches()


def _counts():
    """{kernel: launches} of every kernel, and "q8_mm": the Q8 large-M
    route's calls (not a kernel)."""
    ra, qm, la, rc, bm, lay = _count_modules()
    return {**ra.LAUNCHES, **qm.LAUNCHES, **la.LAUNCHES, **rc.LAUNCHES, **bm.LAUNCHES,
            **lay.LAUNCHES, **qm.LARGE_M_CALLS}


def phase2():
    """2+2 layers at full width, f32: transcribe_tokens_batch on cuda against
    cpu, with float weights and with Q8 weights (quantize_params of the same
    tree: K2 in the decode and the prefill, K3's logits mode in the greedy
    head with collect_topk)."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    base = voxtral_4b()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, layers=2),
        decoder=dataclasses.replace(base.decoder, layers=2))
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
        steps = aux_g["best_logit"].shape[-1]       # decode_scan's n steps
        t0 = time.perf_counter()
        tok_c, aux_c = transcribe_tokens_batch(params_cpu, cfg, audio, collect_topk=4,
                                               device="cpu")
        t_cpu = time.perf_counter() - t0
        best_g, best_c = aux_g["best_logit"].cpu(), aux_c["best_logit"]
        active = aux_c["packed"][..., 0].view(torch.int32) >= 0
        err = (best_g - best_c)[active].abs().max().item()
        log(f"[2] {weights} weights, 2+2 layers f32, {audio.size / 16000:.1f} s audio, "
            f"{steps} decode steps: {len(tok_g)} tokens; cuda {t_gpu:.2f} s, cpu "
            f"{t_cpu:.2f} s; best_logit max abs diff {err:.3g}; launches {json.dumps(counts)}")
        check(counts["ring_gqa_attention"] == cfg.decoder.layers * steps,
              f"K1 launches {counts['ring_gqa_attention']} != {cfg.decoder.layers} x {steps}")
        q8 = weights == "q8"
        # the prefill's 38 rows and each decode step's 1 row go to K2
        want_k2 = 7 * cfg.decoder.layers * (steps + 1) if q8 else 0
        check(counts["w8a16_gemv"] >= want_k2 and (q8 or counts["w8a16_gemv"] == 0),
              f"{weights}: K2 launches {counts['w8a16_gemv']}, want >= {want_k2}")
        check(counts["fused_logits_argmax"] == (steps if q8 else 0),
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


def phase3():
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.ops import ring_attention as ra
    from voxtral_tpu_torch.weights import random_params
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[3] random 4B bf16 params on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    clips = [(3.0, 11), (8.0, 12), (15.0, 13)]
    audios = [synthetic_audio(sec, seed) for sec, seed in clips]
    passes = []
    _reset_counts()                             # main path starts here
    for rep in range(2):
        results = []
        for (sec, _), audio in zip(clips, audios):
            before = ra.LAUNCHES["ring_gqa_attention"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tokens, aux = transcribe_tokens_batch(params, cfg, audio,
                                                  collect_topk=4, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ra.LAUNCHES["ring_gqa_attention"] - before
            best = aux["best_logit"][0]
            steps = best.shape[-1]                  # decode_scan's n steps
            active = aux["packed"][0, :, 0].view(torch.int32) >= 0
            r = dict(pass_=rep, audio_s=sec, decode_steps=steps, tokens=len(tokens),
                     wall_s=wall, ms_per_step=1e3 * wall / steps, rtf=wall / sec,
                     launches=launches,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            log(f"[3] request {json.dumps(r)}")
            check(launches == cfg.decoder.layers * steps,
                  f"launches {launches} != {cfg.decoder.layers} x {steps}")
            check(torch.isfinite(best[active]).all().item(), "non-finite logits")
            check(all(0 <= t < cfg.decoder.vocab_size for t in tokens),
                  "token out of range")
            results.append((tokens, r))
        passes.append(results)
    main_launches = _counts()                       # main path ends here
    check(main_launches["w8a16_gemv"] == main_launches["fused_logits_argmax"] == 0,
          f"bf16 weights with collect_topk launched Q8 or fused-head kernels: "
          f"{main_launches}")
    for (t1, _), (t2, _) in zip(*passes):
        check(t1 == t2, "tokens differ between the two passes")
    # the shortest request: the profiler's own work grows with the events
    profile_request(params, cfg, audios[0], wall_s=passes[1][0][1]["wall_s"],
                    steps=passes[1][0][1]["decode_steps"])
    return main_launches, [r for results in passes for _, r in results]


def profile_request(params, cfg, audio, wall_s, steps):
    """One more run of a request under torch.profiler: device time by
    kernel, the device's busy share of the unprofiled wall time `wall_s` of
    the same request (one stream, so kernels do not overlap), and the
    device time of each stage the pipeline marks with a profiler range
    (encoder, prefill, decode_scan; `steps` decode steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    stages = ("encoder", "prefill", "decode_scan")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        transcribe_tokens_batch(params, cfg, audio, device="cuda")
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
    ring_us = sum(r[0] for r in rows if "ring_partial" in r[2] or "ring_merge" in r[2])
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
    log(f"[3] profile {audio.size / 16000:.1f} s request, {steps} decode steps: "
        f"device busy {total_us / 1e3:.3f} ms of {wall_s * 1e3:.2f} ms unprofiled wall "
        f"(share {total_us / 1e6 / wall_s:.4f}; request device ms / decode steps "
        f"{total_us / 1e3 / steps:.3f}); ring attention {ring_us / 1e3:.3f} ms "
        f"({ring_us / (steps * cfg.decoder.layers):.2f} us per launch); nvjet + "
        f"splitKreduce (cuBLAS GEMV) rows {gemv_us / 1e3:.3f} ms; op ranges "
        f"on the device timeline (not counted) {projected_us / 1e3:.2f} ms; profiling "
        f"took {time.perf_counter() - t0:.1f} s")
    for k in stages:
        log(f"[3]   stage {k}: device busy {busy[k] / 1e3:.3f} ms, device span "
            f"{span[k] / 1e3:.3f} ms (under the profiler)"
            + (f"; busy per decode step {busy[k] / 1e3 / steps:.3f} ms"
               if k == "decode_scan" else ""))
    for us, count, key in rows[:12]:
        log(f"[3]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the fleet step
# ---------------------------------------------------------------------------

# Weight and ring modes; the Q8 mode (Q8 weights, int8 decoder rings, int4
# encoder rings: the headline serving configuration) comes last, as it
# quantizes the float weights in place.
RING_MODES = {"float": ("float", None), "int8": ("int8", None),
              "int8+int4": ("int8", "int4"), "q8+int8+int4": ("int8", "int4")}


def _s16_exact(audio: np.ndarray) -> np.ndarray:
    """Audio rounded to multiples of 2^-15, so the s16 wire carries it
    exactly."""
    return (np.clip(np.round(audio * 32768.0), -32768, 32767) / 32768.0
            ).astype(np.float32)


def _fleet_streams(cfg, audios) -> np.ndarray:
    """The padded PCM streams the fleet consumes, one row per clip."""
    from voxtral_tpu_torch.audio.mel import pad_audio_offline
    from voxtral_tpu_torch.runtime.fleet import pcm_stream
    rows = [pcm_stream(pad_audio_offline(a, cfg.audio, cfg.streaming), cfg)
            for a in audios]
    n = min(len(r) for r in rows)
    return np.stack([r[:n] for r in rows]).astype(np.float32)


def _fleet_drive(params, cfg, t_ada, streams, mode, plan, device):
    """Bootstrap, then one fleet_step_masked per entry of `plan` (active
    [B] bool, forced [B, 20] int32, wire None/"f32"/"s16"), on `device`.
    Returns (tokens [B, n] cpu, per-step (best_logit, top-2 vals) cpu)."""
    import torch
    from voxtral_tpu_torch.runtime import fleet as fl
    kv, ekv = RING_MODES[mode]
    hop = cfg.audio.hop_length
    b = streams.shape[0]
    state = fl.init_fleet_state(cfg, b, enc_ring=ENC_RING, dec_ring=DEC_RING,
                                max_mel_chunk=CHUNK_MEL, kv_dtype=kv,
                                enc_kv_dtype=ekv, device=device)
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
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    base = voxtral_4b()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, layers=2),
        decoder=dataclasses.replace(base.decoder, layers=2))
    params = random_params(cfg, seed=0, device="cuda")
    params_cpu = _cpu_copy(params)
    ada = {dev: ada_scales(p["decoder"], time_conditioning(
               cfg.streaming.delay_tokens, cfg.decoder.dim, device=dev))
           for dev, p in (("cuda", params), ("cpu", params_cpu))}
    audios = [_s16_exact(synthetic_audio(7.0, seed)) for seed in (21, 22)]
    streams = _fleet_streams(cfg, audios)
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
    twice. Returns (launches of the counted runs per kernel, results)."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.runtime import fleet as fl
    from voxtral_tpu_torch.weights import random_params
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    params = random_params(cfg, seed=0, device="cuda")
    t_ada = ada_scales(params["decoder"], time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cuda"))
    b, hop = 16, cfg.audio.hop_length
    n = CHUNK_MEL // 8
    chunk_s = CHUNK_MEL * hop / cfg.audio.sample_rate
    lp = cfg.streaming.prompt_len
    layers_d, layers_e = cfg.decoder.layers, cfg.encoder.layers
    streams = torch.from_numpy(_fleet_streams(
        cfg, [synthetic_audio(12.0, 200 + i) for i in range(b)])).cuda()
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    forced = torch.full((b, n), -1, dtype=torch.int32, device="cuda")
    total = dict.fromkeys(_counts(), 0)
    results = {}
    for mode, (kv, ekv) in RING_MODES.items():
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
        runs = []
        for rep in range(2):
            state = fl.init_fleet_state(cfg, b, enc_ring=ENC_RING, dec_ring=DEC_RING,
                                        max_mel_chunk=CHUNK_MEL, kv_dtype=kv,
                                        enc_kv_dtype=ekv, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            toks, walls = [], []

            def launches(n_dec, n_enc, n_prefill):
                """Per run of n_dec decode tokens, n_enc K1-enc calls and
                n_prefill prefilled streams: the decode ring kernel per
                layer and token, K3 per token; in Q8 mode K2 for the 7
                matrices per decoder layer and token or prefilled stream
                (M = 16 or 38 rows), the large-M route for the encoder's 7
                per K1-enc call (B x 80 rows) and the adapter's 2."""
                want = dict.fromkeys(total, 0)
                want[dec_kernel] += layers_d * n_dec
                want["ring_gqa_attention_enc"] += n_enc
                want["fused_logits_argmax"] += n_dec
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
                check(got == want, f"{mode} {label}: launches {got} != {want}")
                for k, v in got.items():
                    total[k] += v
                toks.append(tok)
                return st

            state = timed("bootstrap", lambda: fl.fleet_bootstrap_pcm(
                params, cfg, state, streams[:, :BOOT_MEL * hop], t_ada),
                BOOT_MEL // 8 - (lp - 1), layers_e * (BOOT_MEL // CHUNK_MEL), b)
            pos = BOOT_MEL * hop
            for step in range(6):
                if step == 5:
                    state = fl.age_fleet_state(cfg, state, 4096)
                pcm = streams[:, pos:pos + CHUNK_MEL * hop]
                pos += CHUNK_MEL * hop
                state = timed("aged" if step == 5 else f"step{step}",
                              lambda: fl.fleet_step_masked(params, cfg, state, pcm,
                                                           active, forced, t_ada),
                              n, layers_e)
            peak = torch.cuda.max_memory_allocated() / 2**30
            tokens = torch.cat(toks, dim=1).cpu()
            check(bool(((tokens >= 0) & (tokens < cfg.decoder.vocab_size)).all()),
                  f"{mode}: token out of range")
            busy = None
            if rep == 1:
                busy = profile_fleet_step(params, cfg, state, streams[:, pos:pos + CHUNK_MEL * hop],
                                          active, forced, t_ada, walls[-1][1], mode)
            runs.append(tokens)
            steady = [w for label, w in walls if label.startswith("step")]
            r = dict(mode=mode, rep=rep, bootstrap_s=walls[0][1],
                     step_ms=[1e3 * w for w in steady], aged_step_ms=1e3 * walls[-1][1],
                     audio_s_per_s=b * chunk_s * len(steady) / sum(steady),
                     aged_audio_s_per_s=b * chunk_s / walls[-1][1],
                     launches_per_step={k: v for k, v in launches(n, layers_e, 0).items()
                                        if v},
                     peak_gib=peak, device_busy_share=busy)
            log(f"[5] {json.dumps(r)}")
            results[(mode, rep)] = r
            del state
            torch.cuda.empty_cache()
        check(bool((runs[0] == runs[1]).all()), f"{mode}: tokens differ between runs")
    del params
    torch.cuda.empty_cache()
    return total, results


def profile_fleet_step(params, cfg, state, pcm, active, forced, t_ada, wall_s, mode):
    """One more fleet step under torch.profiler: the device's busy share of
    the unprofiled wall time `wall_s` of the previous step (same shapes, one
    stream of work, so kernels do not overlap) and the ring kernels' time.
    The rings are updated in place; `state` is not used again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from voxtral_tpu_torch.runtime import fleet as fl
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fl.fleet_step_masked(params, cfg, state, pcm, active, forced, t_ada)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    cpu_keys = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    rows = [(e.self_device_time_total, e.count, e.key) for e in avgs
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in cpu_keys]
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    enc_us = sum(r[0] for r in rows if "ring_enc_kernel" in r[2])
    dec_us = sum(r[0] for r in rows if "ring_partial" in r[2] or "ring_merge" in r[2])
    gemm_us = sum(r[0] for r in rows if "nvjet" in r[2] or "splitKreduce" in r[2]
                  or "gemm" in r[2].lower() and "w8a16" not in r[2])
    k2_us = sum(r[0] for r in rows if "w8a16_" in r[2])
    k3_us = sum(r[0] for r in rows if "logits_kernel" in r[2])
    share = total_us / 1e6 / wall_s
    log(f"[5] profile {mode} (aged state): device busy {total_us / 1e3:.3f} ms of "
        f"{wall_s * 1e3:.2f} ms unprofiled wall (share {share:.4f}); K1-enc "
        f"{enc_us / 1e3:.3f} ms; decode ring kernel {dec_us / 1e3:.3f} ms; "
        f"cuBLAS GEMM rows {gemm_us / 1e3:.3f} ms; K2 (w8a16) {k2_us / 1e3:.3f} ms; "
        f"K3 (fused logits argmax) {k3_us / 1e3:.3f} ms")
    for us, count, key in rows[:10]:
        log(f"[5]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return share


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


# What each path must launch: the serving path (phases 3 and 5; q8_mm is
# the Q8 large-M route, not a kernel) and the tools path (phase 6).
MAIN_PATH = ("ring_gqa_attention", "ring_gqa_attention_int8", "ring_gqa_attention_enc",
             "w8a16_gemv", "fused_logits_argmax", "q8_mm")
TOOLS_PATH = ("wread", "pure_stream", "bf16_matmul", "rd", "w8a16_gemv",
              "fused_logits_argmax", "attn8", "attn4", "attn3d", "attn4d")


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
    rows = phase1() + phase1_fleet() + phase1_q8() + phase1_tools() + phase1_layout()
    ceiling_shares(rows)
    log(f"[1] done at {time.perf_counter() - t_start:.1f} s")
    phase2()
    log(f"[2] done at {time.perf_counter() - t_start:.1f} s")
    launches3, _ = phase3()
    log(f"[3] done at {time.perf_counter() - t_start:.1f} s")
    phase4()
    log(f"[4] done at {time.perf_counter() - t_start:.1f} s")
    launches5, _ = phase5()
    launches = {k: launches3[k] + launches5[k] for k in launches3}
    log(f"[5] main-path launches (phases 3 and 5; q8_mm counts the Q8 large-M "
        f"route's calls): {json.dumps(launches)}")
    for k in MAIN_PATH:
        check(launches[k] > 0, f"the main path launched no {k} kernel")
    log(f"[5] done at {time.perf_counter() - t_start:.1f} s")
    tool_launches, _ = phase6()
    log(f"[6] done at {time.perf_counter() - t_start:.1f} s")
    for k in TOOLS_PATH:
        check(tool_launches[k] > 0, f"the tools path launched no {k} kernel")
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
