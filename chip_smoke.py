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
     row, and an all-masked call must return zeros.
  2. Offline, reduced depth (2 encoder + 2 decoder layers), full 4B width,
     f32: transcribe_tokens_batch on cuda (kernel) and on cpu (plain
     version) must give equal tokens and best logits.
  3. Offline serving at full 4B width and depth in bf16: three requests
     (about 3 s, 8 s and 15 s of audio), run twice; tokens must be
     identical, and K1's launch count must equal 26 x decode steps.
  4. The fleet step, reduced depth (2+2 layers), full width, f32, B = 2, in
     the three ring modes (float; int8; int8 decoder + int4 encoder): a
     bootstrap and 4 masked steps (one with stream 1 inactive, one forced
     token, an f32 wire and an s16 wire) on cuda and on cpu. Tokens must be
     equal (int8/int4: unless the cpu run's top-2 logit gap at the first
     differing step is below 1e-2); in float mode stream 0's tokens must
     equal transcribe_tokens_batch's on the same clip.
  5. The fleet step at full 4B width and depth in bf16: B = 16 streams of
     different clips, 160-mel chunks (20 tokens per step), dec_ring 2048,
     enc_ring 840, each ring mode: bootstrap, 5 steps, one step on an aged
     state (both rings read whole), run twice (tokens identical), with each
     kernel's launches checked per step and one profiled step.
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

def _copies(b, p, row_bytes):
    """Independent K/V rings for a timing loop to cycle through, so that it
    reads more bytes than the 50 MB L2 holds (at most 8)."""
    return max(1, min(8, -(-160 * 2**20 // (2 * b * p * row_bytes))))


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return t_bytes, t_ops, *((t_bytes, "bytes") if t_bytes >= t_ops
                             else (t_ops, "operations"))


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
                copies = _copies(b, P_RING, 1024 * dtype.itemsize)
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
                copies = _copies(b, shape["p"], row_bytes) if timed else 1
                c = _fleet_case(shape, ring, b, nv, dtype, seed, copies)
                rows.append(_ring_row(c, dtype, f"{kernel} {ring} B={b} nv={nv} {dtype}",
                                      kernel, timed))
                del c
    return rows


# ---------------------------------------------------------------------------
# Phases 2 and 3: the pipeline
# ---------------------------------------------------------------------------

def phase2():
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.ops import ring_attention as ra
    from voxtral_tpu_torch.weights import random_params
    base = voxtral_4b()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, layers=2),
        decoder=dataclasses.replace(base.decoder, layers=2))
    params = random_params(cfg, seed=0, device="cuda")
    params_cpu = _tree_map(lambda t: t.cpu(), params)
    audio = synthetic_audio(5.0, seed=2)
    ra.reset_launches()
    t0 = time.perf_counter()
    tok_g, aux_g = transcribe_tokens_batch(params, cfg, audio, collect_topk=4,
                                           device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = ra.LAUNCHES["ring_gqa_attention"]
    steps = aux_g["best_logit"].shape[-1]           # decode_scan's n steps
    t0 = time.perf_counter()
    tok_c, aux_c = transcribe_tokens_batch(params_cpu, cfg, audio, collect_topk=4,
                                           device="cpu")
    t_cpu = time.perf_counter() - t0
    best_g, best_c = aux_g["best_logit"].cpu(), aux_c["best_logit"]
    active = aux_c["packed"][..., 0].view(torch.int32) >= 0
    err = (best_g - best_c)[active].abs().max().item()
    log(f"[2] 2+2 layers f32, {audio.size / 16000:.1f} s audio, {steps} decode "
        f"steps: {len(tok_g)} tokens; cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s; "
        f"best_logit max abs diff {err:.3g}; kernel launches {launches}")
    check(launches == cfg.decoder.layers * steps,
          f"launches {launches} != {cfg.decoder.layers} x {steps}")
    check(tok_g == tok_c, f"cuda tokens {tok_g} != cpu tokens {tok_c}")
    check(err <= 1e-3, f"best_logit diff {err} > 1e-3")
    return dict(tokens=len(tok_g), steps=steps, best_logit_err=err)


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_tree_map(fn, v) for v in node)
    return fn(node)


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
    ra.reset_launches()                         # main path starts here
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
    main_launches = dict(ra.LAUNCHES)               # main path ends here
    for (t1, _), (t2, _) in zip(*passes):
        check(t1 == t2, "tokens differ between the two passes")
    profile_request(params, cfg, audios[1], wall_s=passes[1][1][1]["wall_s"],
                    steps=passes[1][1][1]["decode_steps"])
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
        f"on the device timeline (not counted) {projected_us / 1e3:.2f} ms")
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

RING_MODES = {"float": ("float", None), "int8": ("int8", None),
              "int8+int4": ("int8", "int4")}


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
    ring mode; float mode against the offline pipeline."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch
    from voxtral_tpu_torch.weights import random_params
    base = voxtral_4b()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, layers=2),
        decoder=dataclasses.replace(base.decoder, layers=2))
    params = random_params(cfg, seed=0, device="cuda")
    params_cpu = _tree_map(lambda t: t.cpu(), params)
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
        t0 = time.perf_counter()
        tok_g, aux_g = _fleet_drive(params, cfg, ada["cuda"], streams, mode, plan, "cuda")
        t_gpu = time.perf_counter() - t0
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
              f"over {m} tokens")
    del params, params_cpu


def phase5():
    """The fleet at full 4B width and depth in bf16, B = 16, each ring mode,
    run twice. Returns (launches of the counted runs per kernel, results)."""
    import torch
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.ops import ring_attention as ra
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
    total = dict.fromkeys(ra.LAUNCHES, 0)
    results = {}
    for mode, (kv, ekv) in RING_MODES.items():
        dec_kernel = "ring_gqa_attention" if kv == "float" else "ring_gqa_attention_int8"
        runs = []
        for rep in range(2):
            state = fl.init_fleet_state(cfg, b, enc_ring=ENC_RING, dec_ring=DEC_RING,
                                        max_mel_chunk=CHUNK_MEL, kv_dtype=kv,
                                        enc_kv_dtype=ekv, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            toks, walls = [], []

            def timed(label, fn, n_dec, n_enc):
                ra.reset_launches()                 # a main-path run starts
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, tok, _ = fn()
                torch.cuda.synchronize()
                walls.append((label, time.perf_counter() - t0))
                got = dict(ra.LAUNCHES)             # ... and ends
                want = dict.fromkeys(got, 0)
                want[dec_kernel] += layers_d * n_dec
                want["ring_gqa_attention_enc"] += n_enc
                check(got == want, f"{mode} {label}: launches {got} != {want}")
                for k, v in got.items():
                    total[k] += v
                toks.append(tok)
                return st

            state = timed("bootstrap", lambda: fl.fleet_bootstrap_pcm(
                params, cfg, state, streams[:, :BOOT_MEL * hop], t_ada),
                BOOT_MEL // 8 - (lp - 1), layers_e * (BOOT_MEL // CHUNK_MEL))
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
                     launches_per_step={dec_kernel: layers_d * n,
                                        "ring_gqa_attention_enc": layers_e},
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
                  or "gemm" in r[2].lower())
    share = total_us / 1e6 / wall_s
    log(f"[5] profile {mode} (aged state): device busy {total_us / 1e3:.3f} ms of "
        f"{wall_s * 1e3:.2f} ms unprofiled wall (share {share:.4f}); K1-enc "
        f"{enc_us / 1e3:.3f} ms; decode ring kernel {dec_us / 1e3:.3f} ms; "
        f"GEMM rows {gemm_us / 1e3:.3f} ms")
    for us, count, key in rows[:10]:
        log(f"[5]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return share


def _kernel_entry(rows, launches, name, source, pick):
    """The kernel's entry of the `kernels` line: its launches on the main
    path, its largest error over every phase-1 case, and the numbers of the
    timed bf16 case at the shape `pick` names."""
    mine = [r for r in rows if r["kernel"] == name]
    rep = next(r for r in mine if r["dtype"] == "torch.bfloat16"
               and all(r[k] == v for k, v in pick.items()))
    return dict(name=name, route="cuda", source="voxtral_tpu_torch/csrc/" + source,
                replaces="voxtral_tpu/ops/pallas_attention.py:204",
                launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in mine),
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
    rows = phase1() + phase1_fleet()
    log(f"[1] done at {time.perf_counter() - t_start:.1f} s")
    phase2()
    launches3, _ = phase3()
    log(f"[3] done at {time.perf_counter() - t_start:.1f} s")
    phase4()
    log(f"[4] done at {time.perf_counter() - t_start:.1f} s")
    launches5, _ = phase5()
    launches = {k: launches3[k] + launches5[k] for k in launches3}
    log(f"[5] main-path launches (phases 3 and 5): {json.dumps(launches)}")
    for k, v in launches.items():
        check(v > 0, f"the main path launched no {k} kernel")
    kernels = [   # K1 at the offline pipeline's first decode step
        _kernel_entry(rows, launches, "ring_gqa_attention", "ring_attention.cu",
                      dict(b=1, nv=102)),
        _kernel_entry(rows, launches, "ring_gqa_attention_int8", "ring_attention.cu",
                      dict(b=16, nv=2080)),
        _kernel_entry(rows, launches, "ring_gqa_attention_enc", "ring_attention_enc.cu",
                      dict(b=16, nv=928, ring="int4")),
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
