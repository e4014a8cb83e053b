#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (voxtral_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  0. Device and build: the card's name and power limit; nvcc builds every
     kernel of the port from the sources in this checkout (build/kernels/).
  1. Each kernel against its plain PyTorch version at decoder shapes, with
     its time, the plain version's time, a library yardstick's time and
     the least time the card could take (its byte bound).
  2. Reduced depth (2 encoder + 2 decoder layers), full 4B width, f32:
     transcribe_tokens_batch on seeded synthetic audio on cuda (kernel) and
     on cpu (plain version) must give equal tokens and best logits.
  3. Serving at full 4B width and depth in bf16: three requests (about 3 s,
     8 s and 15 s of seeded synthetic audio; the 15 s clip crosses several
     64-token decode segments), run twice; tokens must be identical, and
     the kernel's launch count must equal 26 x decode steps.
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
# Phase 1: ring attention kernel vs its plain version
# ---------------------------------------------------------------------------

def _ring_case(b, nv, dtype, seed, copies, p=P_RING, sx=SX, heads=DEC["heads"],
               kv_heads=DEC["kv_heads"], head_dim=DEC["head_dim"]):
    """Ring attention inputs (decoder shapes by default). nv < p: the ring
    is filled as a prefix (the last 10 slots below nv still invalid);
    nv == p: a wrapped slot table whose oldest slots fall out of the
    window. A third of the sx extra columns are valid. With B > 1, stream 1
    has an invalid query position: a fully masked row. `copies` independent
    K/V rings let timing loops cycle through more bytes than the 50 MB L2
    holds."""
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
        rings=[(rnd(b, p, kv_dim), rnd(b, p, kv_dim)) for _ in range(copies)],
        sp=sp, q_pos=q_pos, xk=rnd(b, sx, kv_dim), xv=rnd(b, sx, kv_dim), xp=xp,
        nv=torch.tensor(nv, dtype=torch.int32, device=dev),
        kw=dict(window=DEC["window"], heads=heads, kv_heads=kv_heads,
                head_dim=head_dim))


def _ring_check(c, dtype, what):
    """Kernel against the plain version on case `c`; returns max abs error.
    Tolerance: f32 1e-5 (same arithmetic, another summation order); bf16
    2e-2 of max|out| (probabilities are rounded to bf16 against each split's
    max in the kernel, against the global max in the plain version)."""
    import torch
    from voxtral_tpu_torch.ops import ring_attention as ra
    k0, v0 = c["rings"][0]
    args = (c["q"], k0, v0, c["sp"], c["q_pos"])
    ext = dict(extra_k=c["xk"], extra_v=c["xv"], extra_pos=c["xp"],
               n_valid_slots=c["nv"])
    out = ra.ring_gqa_attention(*args, **c["kw"], **ext)
    ref = ra.ring_gqa_attention_reference(*args, **c["kw"], **ext)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()
    check(torch.isfinite(out).all().item(), f"{what}: non-finite kernel output")
    check(err <= tol, f"{what}: err {err} > tol {tol}")
    if out.shape[0] > 1:
        check(out[1].abs().max().item() == 0.0, f"{what}: fully masked row is not zero")
    return err, tol


def _ring_bound(c, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take for
    case `c`, from its own inputs. Bytes: q in and out, the positions that
    decide validity (ring slots below nv, extra columns, queries, nv), and
    K/V only for the rows that pass the mask (0 <= pos <= q_pos,
    pos >= q_pos - (window - 1)); a stream whose query position is invalid
    needs none. Operations: q.k and p.v on those rows."""
    kw = c["kw"]
    elt = dtype.itemsize
    kv_dim = kw["kv_heads"] * kw["head_dim"]
    qd = kw["heads"] * kw["head_dim"]
    b, sx = c["xp"].shape
    nv = int(c["nv"].item())
    qp = c["q_pos"].long()                           # [B, 1]

    def needed(pos):
        pos = pos.long()
        return int(((pos >= 0) & (pos <= qp)
                    & (pos >= qp - (kw["window"] - 1))).sum().item())

    rows = needed(c["sp"][:, :nv]) + needed(c["xp"])
    nbytes = (2 * b * qd * elt                       # q in, out
              + 2 * rows * kv_dim * elt              # K/V rows needed
              + 4 * (b * (nv + sx + 1) + 1))         # positions, nv
    flops = 4 * qd * rows                            # q.k and p.v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase1():
    import torch
    import torch.nn.functional as F
    from voxtral_tpu_torch.ops import ring_attention as ra
    # the kernel's other head dim, checked only: hd 64 with group 8 (two
    # blocks of query heads per kv head)
    shape = dict(p=320, sx=9, heads=16, kv_heads=2, head_dim=64)
    for nv in (50, shape["p"]):
        for dtype in (torch.float32, torch.bfloat16):
            what = f"{shape} nv={nv} {dtype}"
            c = _ring_case(3, nv, dtype, seed=nv, copies=1, **shape)
            err, tol = _ring_check(c, dtype, what)
            log(f"[1] check {what}: max_abs_err {err:.3g} (tol {tol:.3g})")
    rows = []
    for b in (1, 8):
        for nv in (102, 2048, P_RING):
            for dtype in (torch.float32, torch.bfloat16):
                ring_bytes = 2 * b * P_RING * 1024 * dtype.itemsize
                copies = max(1, min(8, -(-160 * 2**20 // ring_bytes)))
                c = _ring_case(b, nv, dtype, seed=len(rows), copies=copies)
                err, tol = _ring_check(c, dtype, f"B={b} nv={nv} {dtype}")
                kw = dict(**c["kw"], extra_k=c["xk"], extra_v=c["xv"],
                          extra_pos=c["xp"], n_valid_slots=c["nv"])

                def kern(i=0):
                    k, v = c["rings"][i % copies]
                    ra.ring_gqa_attention(c["q"], k, v, c["sp"], c["q_pos"], **kw)

                def plain(i=0):
                    k, v = c["rings"][i % copies]
                    ra.ring_gqa_attention_reference(c["q"], k, v, c["sp"], c["q_pos"],
                                                    **kw)

                # yardstick: one SDPA call over ring + extra with a boolean
                # mask (the port never calls it); layout prepared untimed
                qp = c["q_pos"][:, :, None]
                lo = qp - (DEC["window"] - 1)
                pos = torch.cat([c["sp"], c["xp"]], dim=1)[:, None, :]
                valid = torch.cat([torch.arange(P_RING, device="cuda") < nv,
                                   torch.ones(SX, dtype=torch.bool, device="cuda")])
                mask = ((pos >= 0) & (pos <= qp) & (pos >= lo) & valid)[:, None]
                hd, hkv = DEC["head_dim"], DEC["kv_heads"]
                sdpa_kv = [tuple(torch.cat([r, x], 1).view(b, -1, hkv, hd)
                                 .transpose(1, 2).contiguous()
                                 for r, x in ((k, c["xk"]), (v, c["xv"])))
                           for k, v in c["rings"]]
                qs = c["q"].view(b, 1, DEC["heads"], hd).transpose(1, 2)

                def lib(i=0):
                    k, v = sdpa_kv[i % copies]
                    F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                                   enable_gqa=True)

                ms = cuda_ms(kern, 50)
                plain_ms = cuda_ms(plain, 5)
                lib_ms = cuda_ms(lib, 20)
                bound_ms, bound_by = _ring_bound(c, dtype)
                row = dict(b=b, nv=nv, dtype=str(dtype), max_abs_err=err, tol=tol,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
                rows.append(row)
                log(f"[1] ring_gqa_attention {json.dumps(row)}")
                del c, sdpa_kv
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
    ra.ring_gqa_attention.launches = 0
    t0 = time.perf_counter()
    tok_g, aux_g = transcribe_tokens_batch(params, cfg, audio, collect_topk=4,
                                           device="cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = ra.ring_gqa_attention.launches
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
    ra.ring_gqa_attention.launches = 0          # main path starts here
    for rep in range(2):
        results = []
        for (sec, _), audio in zip(clips, audios):
            before = ra.ring_gqa_attention.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tokens, aux = transcribe_tokens_batch(params, cfg, audio,
                                                  collect_topk=4, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ra.ring_gqa_attention.launches - before
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
    main_launches = ra.ring_gqa_attention.launches   # main path ends here
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
    rows = phase1()
    phase2()
    main_launches, _ = phase3()
    check(main_launches > 0, "the main path launched no ring attention kernel")
    rep = next(r for r in rows if r["b"] == 1 and r["nv"] == 102
               and r["dtype"] == "torch.bfloat16")     # first decode step's shape
    kernels = [dict(
        name="ring_gqa_attention", route="cuda",
        source="voxtral_tpu_torch/csrc/ring_attention.cu",
        replaces="voxtral_tpu/ops/pallas_attention.py:204",
        launches=main_launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=rep["library_ms"])]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
