"""How close do bf16 decode matmuls come to the card's read rate for a bf16
weight stack? The counterpart of `tools/profile_weight_stream.py`, over one
26-layer working set of 5 merged tensors per layer (wq [3072, 4096], wkv
[3072, 2048], wo [4096, 3072], w13 [3072, 18432], w2 [9216, 3072]: the
decoder's bytes, 6.05 GB):

  1. the stack through `torch.matmul` (cuBLAS), the library yardstick;
  2. T2 (`pure_stream`, `csrc/read_ceiling.cu`) over every tensor: reads
     each byte once and reduces almost nothing, the read ceiling of the
     bf16 stack;
  3. the stack through T3 (`bf16_matmul`, `csrc/bf16_matmul.cu`), the
     hand-written skinny product, f32 out.

The stacks carry x from layer to layer (q -> wo, silu(g) * u -> w2) as
the JAX tool does; the T2 pass times the T2 launches alone. Each is timed
as one CUDA graph of `iters` passes between two events
(`_timing.device_ms`); GB/s is the stack's weight bytes over the time of
one pass.

    python -m voxtral_tpu_torch.tools.profile_weight_stream [--device cuda]

reads VOX_PROF_STREAMS (24) and VOX_PROF_BLK_N (1024, T2's block width).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.nn.functional as F

from voxtral_tpu_torch.ops.bf16_matmul import bf16_matmul
from voxtral_tpu_torch.ops.read_ceiling import pure_stream
from voxtral_tpu_torch.tools._timing import device_info, device_ms, report
from voxtral_tpu_torch.utils import resolve_device

TENSORS = ("wq", "wkv", "wo", "w13", "w2")
BLK_K = 1536


def layer_shapes(dim=3072, q_dim=4096, kv_dim=1024, hidden=9216) -> dict:
    """The 5 merged tensors of one layer (wk and wv as one [dim, 2 kv]
    tensor, w1 and w3 as one [dim, 2 hidden])."""
    return dict(wq=(dim, q_dim), wkv=(dim, 2 * kv_dim), wo=(q_dim, dim),
                w13=(dim, 2 * hidden), w2=(hidden, dim))


def profile_weight_stream(streams: int = 24, blk_n: int = 1024, *,
                          layers: int = 26, dim: int = 3072, q_dim: int = 4096,
                          kv_dim: int = 1024, hidden: int = 9216, iters: int = 15,
                          device="cuda") -> dict:
    """Returns {device, power_limit, count, streams, layers, iters, blk_n,
    blk_k, bytes, and for "matmul" (torch.matmul), "stream" (T2) and "t3":
    *_ms per pass and *_gbps}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)

    def mk(shape):
        u = torch.rand(shape, generator=g, device=dev) - 0.5
        return u.to(torch.bfloat16) * 0.05

    shapes = layer_shapes(dim, q_dim, kv_dim, hidden)
    weights = [{nm: mk(shapes[nm]) for nm in TENSORS} for _ in range(layers)]
    x0 = mk((streams, dim))

    def matmul_stack(_):
        x = x0
        for lp in weights:
            q = x @ lp["wq"]
            kv = x @ lp["wkv"]
            o = q @ lp["wo"]
            gate, up = (x @ lp["w13"]).chunk(2, dim=-1)
            x = (o + (F.silu(gate) * up) @ lp["w2"]
                 + kv.sum(-1, keepdim=True) * 0).to(torch.bfloat16)
        return x

    def stream(_):
        return [pure_stream(lp[nm], BLK_K, blk_n) for lp in weights for nm in TENSORS]

    def t3_stack(_):
        x = x0
        for lp in weights:
            q = bf16_matmul(x, lp["wq"])
            kv = bf16_matmul(x, lp["wkv"])
            o = bf16_matmul(q.to(torch.bfloat16), lp["wo"])
            gate, up = bf16_matmul(x, lp["w13"]).chunk(2, dim=-1)
            x = (o + bf16_matmul((F.silu(gate) * up).to(torch.bfloat16), lp["w2"])
                 + kv.sum(-1, keepdim=True) * 0).to(torch.bfloat16)
        return x

    res = dict(device_info(dev), streams=streams, layers=layers, iters=iters, blk_n=blk_n,
               blk_k=BLK_K, bytes=layers * 2 * sum(r * c for r, c in shapes.values()))
    for key, fn in (("matmul", matmul_stack), ("stream", stream), ("t3", t3_stack)):
        res[f"{key}_ms"] = device_ms(fn, iters, dev)
        res[f"{key}_gbps"] = res["bytes"] / res[f"{key}_ms"] / 1e6
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_weight_stream(int(os.environ.get("VOX_PROF_STREAMS", "24")),
                                int(os.environ.get("VOX_PROF_BLK_N", "1024")),
                                device=args.device)
    print(f"working set: {res['bytes'] / 1e9:.2f} GB bf16")
    report("bf16 weight stream", res, ("streams", "layers", "iters", "blk_n", "blk_k"), [
        ("torch.matmul stack", "matmul_ms", "matmul_gbps"),
        ("pure stream (T2)", "stream_ms", "stream_gbps"),
        ("bf16 matmul stack (T3)", "t3_ms", "t3_gbps")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
