"""Read ceiling for the decode attention's access pattern, the counterpart
of `tools/profile_dma_ceiling.py`: T11 (`rd`, `csrc/read_ceiling.cu`)
reads int8 K and V rings [B, P, 1024] whole and reduces them to per-lane
sums, 26 times (one per decoder layer), each call's salt an element of
the previous call's output: a chain of data dependencies, as in a decode
step, with no extra kernel between the calls.

The JAX tool rereads one ring pair 26 times. One pair (68 MB at the
defaults) barely exceeds the H100's 50 MB L2, so this tool rotates over
enough distinct pairs that one pass (26 calls) reads at least 4x the L2
in distinct bytes. GB/s is the bytes the 26 calls read over the time of
one pass, timed as one CUDA graph of `iters` passes between two events
(`_timing.device_ms`). The JAX tool's block-width sweep (256, 512, 1024
lanes) is a TPU tiling choice; the kernel's column tile here is fixed by
its 16-byte loads.

    python -m voxtral_tpu_torch.tools.profile_dma_ceiling [--device cuda]

reads VOX_PROF_STREAMS (16).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from voxtral_tpu_torch.ops.read_ceiling import rd
from voxtral_tpu_torch.tools._timing import (
    copies_beyond_l2, device_info, device_ms, l2_bytes, report,
)
from voxtral_tpu_torch.utils import resolve_device


def rd_chain(pairs, layers: int, salt0: torch.Tensor) -> torch.Tensor:
    """`layers` T11 calls over the ring pairs in turn, each call's salt the
    first element of the previous call's output. Returns the last output."""
    out = salt0
    for i in range(layers):
        k, v = pairs[i % len(pairs)]
        out = rd(k, v, out.view(-1)[:1])
    return out


def profile_dma_ceiling(streams: int = 16, *, slots: int = 2088, kv_dim: int = 1024,
                        layers: int = 26, iters: int = 10, device="cuda") -> dict:
    """Returns {device, power_limit, count, streams, slots, kv_dim, layers,
    iters, pairs (distinct ring pairs, enough for 4x the L2), bytes (per
    pass), ms (per pass), gbps}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    pair_bytes = 2 * streams * slots * kv_dim
    n = copies_beyond_l2(pair_bytes, l2_bytes(dev), layers)   # a pass reads `layers`

    def ring():
        return torch.randint(-127, 127, (streams, slots, kv_dim), generator=g, device=dev,
                             dtype=torch.int8)

    rings = [(ring(), ring()) for _ in range(n)]
    salt0 = torch.zeros(1, dtype=torch.float32, device=dev)
    res = dict(device_info(dev), streams=streams, slots=slots, kv_dim=kv_dim, layers=layers,
               iters=iters, pairs=n, bytes=layers * pair_bytes)
    res["ms"] = device_ms(lambda _: rd_chain(rings, layers, salt0), iters, dev)
    res["gbps"] = res["bytes"] / res["ms"] / 1e6
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_dma_ceiling(int(os.environ.get("VOX_PROF_STREAMS", "16")),
                              device=args.device)
    report("int8 ring read ceiling", res,
           ("streams", "slots", "kv_dim", "layers", "pairs", "iters"),
           [(f"pure-read (T11 rd) per {res['layers']}L", "ms", "gbps")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
