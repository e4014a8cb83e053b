"""Where a fleet step's device time and launches go, by kernel group. The
fleet step of chip_smoke.py phase 5 (full 4B width and depth in bf16, B =
16 streams of different synthetic clips, 160-mel chunks of 20 tokens,
dec_ring 2048, enc_ring 840) is bootstrapped and stepped WARM times, then
one more step runs under torch.profiler (CUDA activity only); then the same
on a fresh state through step graphs (runtime/step_graph.py: the first step
eager, the second captured, the third and the profiled one replayed).
Printed for the float mode and the Q8 + int8 + int4 mode, one JSON line
each: the unprofiled wall of the step before, the device busy ms, and the
ms and launches of each kernel group (torch's elementwise kernels, its
reductions, K4's entries, the ring kernels, K2, K3, cuBLAS), eager and
under `replayed`, with the card's name and power limit.

    python voxtral_tpu_torch/tools/profile_fleet_step.py

The port it profiles is the `voxtral_tpu_torch` that Python finds first:
run by its path with another checkout's root on PYTHONPATH, this same code
profiles that checkout's port (two commits compared in one call, on one
card). Needs the card: it raises without CUDA.

chip_smoke.py's fleet phases take their shapes, clips, ring modes and
profile from here, so this tool's step is phase 5's step.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

CHUNK_MEL, BOOT_MEL, DEC_RING, ENC_RING = 160, 320, 2048, 840
STREAMS, WARM = 16, 3
# Ring modes, name: (decoder ring kv dtype, encoder ring kv dtype); a name
# that starts with "q8" also takes Q8 weights. The Q8 mode (int8 decoder
# rings, int4 encoder rings: the headline serving configuration) comes last,
# as it quantizes the float weights in place.
RING_MODES = {"float": ("float", None), "int8": ("int8", None),
              "int8+int4": ("int8", "int4"), "q8+int8+int4": ("int8", "int4")}
PROFILED = ("float", "q8+int8+int4")
# kernel group: substrings of the lower-cased kernel names it sums, the port's
# kernels and cuBLAS's first (cuBLAS's splitKreduce_kernel is no torch reduction)
GROUPS = {"k4": ("rms_norm_kernel",), "ring_dec": ("ring_partial", "ring_merge", "ring_dec_"),
          "ring_enc": ("ring_enc_",), "k2": ("w8a16_",),
          "k3": ("logits_kernel", "logits_mma_kernel"),
          "cublas": ("nvjet", "splitkreduce", "gemm"),
          "elementwise": ("elementwise_kernel",), "reduce": ("reduce_kernel",)}


def synthetic_audio(seconds: float, seed: int) -> np.ndarray:
    """A gliding tone with harmonics over noise, 16 kHz f32."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 150.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6.28)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    tone = sum(np.sin(k * phase) / k for k in (1, 2, 3))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t) ** 2
    return (0.1 * tone * env + 0.01 * rng.randn(t.size)).astype(np.float32)


def fleet_streams(cfg, audios) -> np.ndarray:
    """The padded PCM streams the fleet consumes, one row per clip."""
    from voxtral_tpu_torch.audio.mel import pad_audio_offline
    from voxtral_tpu_torch.runtime.fleet import pcm_stream
    rows = [pcm_stream(pad_audio_offline(a, cfg.audio, cfg.streaming), cfg) for a in audios]
    n = min(len(r) for r in rows)
    return np.stack([r[:n] for r in rows]).astype(np.float32)


def init_state(cfg, b: int, mode: str, device, tp=None):
    """A fresh fleet state of `b` streams in ring mode `mode` at the fleet's
    chunk and ring sizes."""
    from voxtral_tpu_torch.runtime.fleet import init_fleet_state
    kv, ekv = RING_MODES[mode]
    return init_fleet_state(cfg, b, enc_ring=ENC_RING, dec_ring=DEC_RING,
                            max_mel_chunk=CHUNK_MEL, kv_dtype=kv, enc_kv_dtype=ekv,
                            device=device, tp=tp)


def device_rows(prof) -> list:
    """Kernel rows of a profile, (self device us, count, name), largest
    first: CPU op ranges and annotations projected onto the device timeline
    repeat their kernels' time and are left out. Profiles that record
    device activity only need nothing else: recording every CPU op made a
    profiled step several times slower and its processing about three
    times longer (chip_smoke.py's step, poll and feed profiles)."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    cpu_keys = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    rows = [(e.self_device_time_total, e.count, e.key) for e in avgs
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and e.key not in cpu_keys]
    return sorted(rows, reverse=True)


def kernel_groups(rows) -> dict:
    """{group: (us, launches)} over `device_rows`, plus "all": every
    kernel row. A kernel counts in the first group that names it."""
    out = {g: [0.0, 0] for g in (*GROUPS, "other", "all")}
    for us, count, key in rows:
        group = next((g for g, keys in GROUPS.items() if any(k in key.lower() for k in keys)),
                     "other")
        for g in (group, "all"):
            out[g][0] += us
            out[g][1] += count
    return {g: tuple(v) for g, v in out.items()}


def profile_step(params, cfg, state, pcm, active, forced, t_ada, graphs=None):
    """One fleet step under torch.profiler, recording the device's activity
    (the CPU's on a CPU `pcm`, which rehearses the drive: its profile holds
    no kernel rows): the eager step on `state`, or with `graphs` (a
    runtime.step_graph.FleetStepGraphs) its step on the state it owns,
    replayed once it is captured. The rings are updated in place. Returns
    `device_rows`."""
    from torch.profiler import ProfilerActivity, profile

    from voxtral_tpu_torch.runtime.fleet import fleet_step_masked
    cuda = pcm.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        if graphs is None:
            fleet_step_masked(params, cfg, state, pcm, active, forced, t_ada)
        else:
            graphs.step_masked(pcm, active, forced, t_ada)
        if cuda:
            torch.cuda.synchronize()
    return device_rows(prof)


def _profile_chain(params, cfg, t_ada, streams, mode, replayed):
    """Bootstrap, WARM timed steps, then one profiled step; `replayed`: the
    steps through step graphs (the first eager, the second captured, the
    rest and the profiled one replayed)."""
    from voxtral_tpu_torch.runtime import fleet as fl
    from voxtral_tpu_torch.runtime.step_graph import FleetStepGraphs
    hop = cfg.audio.hop_length
    b, dev = streams.shape[0], streams.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    forced = torch.full((b, CHUNK_MEL // 8), -1, dtype=torch.int32, device=dev)
    state = init_state(cfg, b, mode, dev)
    state, _, _ = fl.fleet_bootstrap_pcm(params, cfg, state, streams[:, :BOOT_MEL * hop], t_ada)
    graphs = FleetStepGraphs(params, cfg, state) if replayed else None
    pos, wall = BOOT_MEL * hop, None
    for _ in range(WARM):
        pcm = streams[:, pos:pos + CHUNK_MEL * hop]
        sync()
        t0 = time.perf_counter()
        if graphs is None:
            state, _, _ = fl.fleet_step_masked(params, cfg, state, pcm, active, forced, t_ada)
        else:
            graphs.step_masked(pcm, active, forced, t_ada)
        sync()
        wall = time.perf_counter() - t0
        pos += CHUNK_MEL * hop
    groups = kernel_groups(profile_step(params, cfg, state,
                                        streams[:, pos:pos + CHUNK_MEL * hop], active, forced,
                                        t_ada, graphs))
    if graphs is not None:
        graphs.close()
    return dict(step_wall_ms=1e3 * wall, busy_ms=groups["all"][0] / 1e3,
                launches=groups["all"][1],
                groups={g: dict(ms=us / 1e3, launches=n) for g, (us, n) in groups.items()})


def profile_mode(params, cfg, t_ada, streams, mode):
    """The fleet in `mode` on the device of `streams` ([B, n] PCM):
    bootstrap, WARM timed steps, then one profiled step, eagerly and, on
    the card, through step graphs (`replayed`: the last warm step and the
    profiled one are replays). Returns the JSON-ready result."""
    r = dict(mode=mode, streams=streams.shape[0], tokens_per_step=CHUNK_MEL // 8,
             **_profile_chain(params, cfg, t_ada, streams, mode, replayed=False))
    if streams.device.type == "cuda":
        r["replayed"] = _profile_chain(params, cfg, t_ada, streams, mode, replayed=True)
    return r


def main() -> None:
    import voxtral_tpu_torch
    from voxtral_tpu_torch import _build
    from voxtral_tpu_torch.config import voxtral_4b
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.weights import random_params
    if not torch.cuda.is_available():
        raise RuntimeError("profile_fleet_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    cfg = voxtral_4b(torch.bfloat16, torch.bfloat16)
    params = random_params(cfg, seed=0, device="cuda")
    t_ada = ada_scales(params["decoder"], time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cuda"))
    streams = torch.from_numpy(fleet_streams(
        cfg, [synthetic_audio(12.0, 200 + i) for i in range(STREAMS)])).cuda()
    for mode in PROFILED:
        if mode.startswith("q8"):      # last: quantize_params consumes the bf16 tree
            params = quantize_params(params)
        r = profile_mode(params, cfg, t_ada, streams, mode)
        print(json.dumps(dict(port=voxtral_tpu_torch.__file__, device=smi, build_s=build_s,
                              **r)), flush=True)


if __name__ == "__main__":
    main()
