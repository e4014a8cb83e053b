"""Does a block-major ring layout [B, nb, P, blk] beat the production [B,
P, kv_dim] for the decode attention? The counterpart of
`tools/profile_attn_layout.py`: one masked, scaled int8 attention (scores,
mask, softmax, PV; no extra columns), T6 `attn3d` on [B, P, 1024] rings and
T7 `attn4d` on [B, 1024 / blk, P, blk] rings (one kernel on two sets of
strides, `csrc/layout_attention.cu`), each timed as the tool's 26-call
chain h = h + 0.001 * attn(h, k, v) for blk 256, 512 and 1024.

Inputs as in the tool: scales 0.01 (the same tensor as ks and vs), slot
positions arange(P), query position P + 10 (every slot valid). The block-
major rings hold the same values as the 3-D ones. The chain rotates over
enough distinct ring pairs that one pass reads at least 4x the L2. GB/s is
the tool's byte count (rings plus scales; sp is not counted) over the time
of one pass, timed as one CUDA graph of `iters` passes between two events
(`_timing.device_ms`). T6 does not depend on blk (its row stride is
kv_dim whatever the blk): its three times measure the same work.

    python -m voxtral_tpu_torch.tools.profile_attn_layout [--device cuda]

reads VOX_PROF_STREAMS (16).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from voxtral_tpu_torch.ops.layout_attention import (
    GROUP, HD, attn3d, attn4d, chain, to_block_major,
)
from voxtral_tpu_torch.tools._timing import (
    copies_beyond_l2, device_info, device_ms, l2_bytes, report,
)
from voxtral_tpu_torch.utils import resolve_device


def profile_attn_layout(streams: int = 16, *, slots: int = 2088, kv_heads: int = 8,
                        blks=(256, 512, 1024), layers: int = 26, iters: int = 20,
                        device="cuda") -> dict:
    """Returns {device, power_limit, count, streams, slots, kv_heads, blks,
    layers, iters, copies (distinct ring pairs), bytes (per pass), and per
    blk: t6_ms_<blk>, t7_ms_<blk> (per pass), t6_gbps_<blk>, t7_gbps_<blk>,
    t7_over_t6_<blk>}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    kv_dim = kv_heads * HD
    q = (torch.rand((streams, 1, GROUP * kv_dim), generator=g, device=dev)
         - 0.5).to(torch.bfloat16)
    sp = torch.arange(slots, dtype=torch.int32, device=dev).repeat(streams, 1)
    sp = sp.reshape(streams, 1, slots)
    qp = torch.full((streams, 1, 1), slots + 10, dtype=torch.int32, device=dev)
    pair = 2 * streams * slots * kv_dim
    n = copies_beyond_l2(pair, l2_bytes(dev), layers)

    def ring():
        return torch.randint(-127, 127, (streams, slots, kv_dim), generator=g, device=dev,
                             dtype=torch.int8)

    k3, v3 = [ring() for _ in range(n)], [ring() for _ in range(n)]
    res = dict(device_info(dev), streams=streams, slots=slots, kv_heads=kv_heads,
               blks=list(blks), layers=layers, iters=iters, copies=n,
               bytes=layers * (pair + 2 * streams * kv_heads * slots * 4))
    for blk in blks:
        ks = torch.full((streams, kv_dim // blk, blk // HD, slots), 0.01, device=dev)
        k4 = [to_block_major(k, blk) for k in k3]
        v4 = [to_block_major(v, blk) for v in v3]
        for key, attn, kr, vr in (("t6", attn3d, k3, v3), ("t7", attn4d, k4, v4)):
            def fn(_, attn=attn, kr=kr, vr=vr):
                return chain(lambda h, k, v: attn(h, k, v, sp, qp, ks, ks, blk),
                             q, kr, vr, layers)
            res[f"{key}_ms_{blk}"] = device_ms(fn, iters, dev)
            res[f"{key}_gbps_{blk}"] = res["bytes"] / res[f"{key}_ms_{blk}"] / 1e6
        res[f"t7_over_t6_{blk}"] = res[f"t7_ms_{blk}"] / res[f"t6_ms_{blk}"]
        del k4, v4
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_attn_layout(int(os.environ.get("VOX_PROF_STREAMS", "16")),
                              device=args.device)
    kv = res["kv_heads"] * HD
    rows = []
    for blk in res["blks"]:
        rows += [(f"3D [B,P,{kv}] blk={blk} (T6 attn3d)", f"t6_ms_{blk}", f"t6_gbps_{blk}"),
                 (f"4D [B,{kv // blk},P,{blk}] (T7 attn4d)", f"t7_ms_{blk}", f"t7_gbps_{blk}")]
    report("ring layout attention", res,
           ("streams", "slots", "kv_heads", "layers", "copies", "iters"), rows)
    print("  T7 / T6 time: " + ", ".join(f"blk {b} {res[f't7_over_t6_{b}']:.4f}"
                                         for b in res["blks"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
