"""What do the port's Q8 decode matmuls achieve against what this card can
read? The counterpart of `tools/profile_q8_matmul_roofline.py`:

  1. the 26-layer Q8 decode-matmul stack (no attention, a stand-in mix of
     q and k/v) through `ops.linear.linear`: K2 (`csrc/w8a16.cu`) at
     M = streams;
  2. T1 (`wread`, `csrc/read_ceiling.cu`) over the same weight arrays,
     all 26 layers: the read ceiling of the int8 weight stack;
  3. the greedy head on the Q8 tied table [131072, 3072]: K3
     (`csrc/logits_argmax.cu`), logits + argmax in one launch.

Each is timed as one CUDA graph of `iters` passes between two events
(`_timing.device_ms`). GB/s is the bytes each pass must read (the weight
codes; the table's codes) over its time. Weights are seeded random codes
with scales 0.01; the table's scales are per row (the port's tied-table
layout), the JAX tool's per column: all 0.01, the same products.

    python -m voxtral_tpu_torch.tools.profile_q8_matmul_roofline [--device cuda]

reads VOX_PROF_STREAMS (32).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.ops.linear import linear
from voxtral_tpu_torch.ops.logits_argmax import logits_argmax
from voxtral_tpu_torch.ops.read_ceiling import wread
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.tools._timing import device_info, device_ms, report
from voxtral_tpu_torch.utils import resolve_device

MATRICES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def layer_shapes(dim=3072, q_dim=4096, kv_dim=1024, hidden=9216) -> dict:
    """The 7 Q8 matrices of one decoder layer, [in, out]."""
    return dict(wq=(dim, q_dim), wk=(dim, kv_dim), wv=(dim, kv_dim), wo=(q_dim, dim),
                w1=(dim, hidden), w3=(dim, hidden), w2=(hidden, dim))


def profile_q8_matmul_roofline(streams: int = 32, *, layers: int = 26, dim: int = 3072,
                               q_dim: int = 4096, kv_dim: int = 1024, hidden: int = 9216,
                               vocab: int = 131072, iters: int = 20, device="cuda") -> dict:
    """Returns {device, power_limit, count, streams, layers, iters, and for
    "stack", "read" and "logits": *_ms (per pass), *_bytes, *_gbps}."""
    if q_dim != 4 * kv_dim:
        raise ValueError("the stand-in attention concatenates k, v, k, v: q_dim = 4 kv_dim")
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)

    def mkq(rows, cols, axis=-1):
        q = torch.randint(-127, 127, (rows, cols), generator=g, device=dev, dtype=torch.int8)
        return Quantized(q, torch.full((cols if axis == -1 else rows,), 0.01, device=dev), axis)

    shapes = layer_shapes(dim, q_dim, kv_dim, hidden)
    weights = [{nm: mkq(*shapes[nm]) for nm in MATRICES} for _ in range(layers)]
    layer_bytes = sum(r * c for r, c in shapes.values())
    x0 = (torch.randn((streams, 1, dim), generator=g, device=dev) * 0.02).to(torch.bfloat16)

    def stack(_):
        x = x0
        for lp in weights:
            q = linear(x, lp["wq"])
            k = linear(x, lp["wk"])
            v = linear(x, lp["wv"])
            a = (q + torch.cat([k, v, k, v], -1)) * 1e-3    # stand-in attention
            h = x + linear(a, lp["wo"])
            x = h + linear(F.silu(linear(h, lp["w1"])) * linear(h, lp["w3"]),
                           lp["w2"]) * 1e-3
        return x

    def read(_):
        return [wread(lp[nm].q) for lp in weights for nm in MATRICES]

    res = dict(device_info(dev), streams=streams, layers=layers, iters=iters)
    res["stack_bytes"] = res["read_bytes"] = layers * layer_bytes
    res["stack_ms"] = device_ms(stack, iters, dev)
    res["read_ms"] = device_ms(read, iters, dev)
    del weights

    table = mkq(vocab, dim, axis=0)
    h = (torch.randn((streams, dim), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    res["logits_bytes"] = vocab * dim
    res["logits_ms"] = device_ms(lambda _: logits_argmax(h, table), iters, dev)
    for key in ("stack", "read", "logits"):
        res[f"{key}_gbps"] = res[f"{key}_bytes"] / res[f"{key}_ms"] / 1e6
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_q8_matmul_roofline(int(os.environ.get("VOX_PROF_STREAMS", "32")),
                                     device=args.device)
    report("Q8 decode matmul roofline", res, ("streams", "layers", "iters"), [
        (f"{res['layers']}L decode matmul stack (K2, B={res['streams']})",
         "stack_ms", "stack_gbps"),
        (f"{res['layers']}L pure-read ceiling (T1 wread)", "read_ms", "read_gbps"),
        ("logits+argmax (K3, Q8 table)", "logits_ms", "logits_gbps")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
