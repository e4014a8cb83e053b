"""How does the column-sum kernel's split of the rows set its read rate?
The kernel behind T1 (`wread`) and T11 (`rd`, both `csrc/read_ceiling.cu`)
splits a matrix's rows until its grid holds about `_BLOCKS_PER_SM` blocks
per SM (`ops.read_ceiling.col_split`). For each target in `targets`, this
tool times T1 over the 26-layer int8 weight stack of
`profile_q8_matmul_roofline` and T11's 26-call chain over the rings of
`profile_dma_ceiling`, in `repeats` rounds that visit the targets in turn
(so that a drift of the card's clock spreads over all of them). Each time
is one CUDA graph of `iters` passes between two events
(`_timing.device_ms`); the result is each target's median ms per pass and
its GB/s.

    python -m voxtral_tpu_torch.tools.profile_colsum_split [--device cuda]

On the CPU the wrappers take their plain versions, which do not split:
the sweep runs but measures nothing of the kernel.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from voxtral_tpu_torch.ops import read_ceiling
from voxtral_tpu_torch.tools._timing import (
    copies_beyond_l2, device_info, device_ms, l2_bytes, report,
)
from voxtral_tpu_torch.tools.profile_dma_ceiling import rd_chain
from voxtral_tpu_torch.tools.profile_q8_matmul_roofline import MATRICES, layer_shapes
from voxtral_tpu_torch.utils import resolve_device

TARGETS = (1, 2, 3, 4, 6, 8)


def profile_colsum_split(targets=TARGETS, repeats: int = 5, *, layers: int = 26,
                         dim: int = 3072, q_dim: int = 4096, kv_dim: int = 1024,
                         hidden: int = 9216, streams: int = 16, slots: int = 2088,
                         iters: int = 10, device="cuda") -> dict:
    """Returns {device, power_limit, count, layers, repeats, iters,
    committed (the module's own target), t1_bytes, t11_bytes, and per
    target t: t1_ms_{t}, t1_gbps_{t}, t11_ms_{t}, t11_gbps_{t}}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 127, shape, generator=g, device=dev, dtype=torch.int8)

    shapes = layer_shapes(dim, q_dim, kv_dim, hidden)
    stack = [codes(*shapes[nm]) for _ in range(layers) for nm in MATRICES]
    pair_bytes = 2 * streams * slots * kv_dim
    pairs = [(codes(streams, slots, kv_dim), codes(streams, slots, kv_dim))
             for _ in range(copies_beyond_l2(pair_bytes, l2_bytes(dev), layers))]
    salt0 = torch.zeros(1, dtype=torch.float32, device=dev)
    cases = {"t1": (lambda _: [read_ceiling.wread(q) for q in stack],
                    sum(q.numel() for q in stack)),
             "t11": (lambda _: rd_chain(pairs, layers, salt0), layers * pair_bytes)}
    times = {(c, t): [] for c in cases for t in targets}
    committed = read_ceiling._BLOCKS_PER_SM
    try:
        for _ in range(repeats):
            for t in targets:
                read_ceiling._BLOCKS_PER_SM = t
                for c, (fn, _) in cases.items():
                    times[c, t].append(device_ms(fn, iters, dev))
    finally:
        read_ceiling._BLOCKS_PER_SM = committed
    res = dict(device_info(dev), layers=layers, repeats=repeats, iters=iters,
               committed=committed)
    for c, (_, nbytes) in cases.items():
        res[f"{c}_bytes"] = nbytes
        for t in targets:
            res[f"{c}_ms_{t}"] = statistics.median(times[c, t])
            res[f"{c}_gbps_{t}"] = nbytes / res[f"{c}_ms_{t}"] / 1e6
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_colsum_split(device=args.device)
    report("column-sum split sweep (median of rounds)", res,
           ("layers", "repeats", "iters", "committed"),
           [(f"{c} at {t} blocks/SM", f"{c}_ms_{t}", f"{c}_gbps_{t}")
            for c in ("t1", "t11") for t in TARGETS])
    return 0


if __name__ == "__main__":
    sys.exit(main())
