"""Timing and device description shared by the profile tools."""

from __future__ import annotations

import subprocess
import time

import torch

L2_BYTES_DEFAULT = 50 * 2**20              # the H100's L2, where the device gives none


def device_ms(fn, iters: int, device: torch.device) -> float:
    """Time per call of fn(i), i = 0..iters-1, after one warm-up call fn(0).

    On CUDA: the `iters` calls are captured in one CUDA graph and replayed
    between two events, so host-side launch overhead does not enter the
    number (device time). On the CPU: the host clock around the calls.
    Kernel wrappers count their launches during the warm-up and the
    capture, not during the replays: 1 + iters calls each."""
    if device.type != "cuda":
        fn(0)
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t0) / iters * 1e3
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):                 # warm-up outside capture
        fn(0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    del graph
    return start.elapsed_time(end) / iters


def device_info(device: torch.device) -> dict:
    """{"device": name, "power_limit": nvidia-smi's power.limit or None,
    "count": devices}; the CPU is named "cpu"."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None, "count": 0}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(index),
            "power_limit": line.rsplit(",", 1)[-1].strip(),
            "count": torch.cuda.device_count()}


def l2_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return L2_BYTES_DEFAULT
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "L2_cache_size", 0) or L2_BYTES_DEFAULT)


def copies_beyond_l2(nbytes: int, l2: int, cap: int) -> int:
    """Distinct copies of an input of `nbytes` for a timed loop to rotate
    over, so that the loop reads at least 4x the L2 in distinct bytes
    (at most `cap` copies, at least one)."""
    return max(1, min(cap, -(-4 * l2 // nbytes)))


def report(title: str, res: dict, keys, rows) -> None:
    """Print a tool's result: the device, power limit and `keys` of `res`,
    then `label  ms  (GB/s)` per row of (label, ms key, GB/s key)."""
    print(f"{title}: {res['device']} (power limit {res['power_limit']}), "
          + ", ".join(f"{k}={res[k]}" for k in keys))
    for label, ms_key, rate_key in rows:
        print(f"  {label:44s} {res[ms_key]:9.4f} ms  ({res[rate_key]:7.1f} GB/s)")
