"""Does a nibble-packed (int4) KV ring halve the decode attention's time,
and not only its bytes? The counterpart of `tools/profile_int4_unpack.py`:
the same attention-like kernel over int8 rings [B, P, 1024] (T4 `attn8`)
and over packed rings [B, P, 512] (T5 `attn4`: unpack in registers, two
half dots), both in `csrc/layout_attention.cu`, each timed as the tool's
26-call chain acc = acc + 0.001 * attn(acc, k, v), one call per decoder
layer.

The JAX tool rereads one ring pair; here the chain rotates over enough
distinct pairs that one pass reads at least 4x the L2. GB/s is the tool's
own byte count (the rings, `gb8` and `gb8 / 2`) over the time of one pass,
timed as one CUDA graph of `iters` passes between two events
(`_timing.device_ms`). Then the tool's numeric check: T5 on packed rings
against T4 on the same int4-range values, unpacked (2 streams).

    python -m voxtral_tpu_torch.tools.profile_int4_unpack [--device cuda]

reads VOX_PROF_STREAMS (32).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from voxtral_tpu_torch.ops.layout_attention import GROUP, HD, attn4, attn8, chain
from voxtral_tpu_torch.quant import pack_int4
from voxtral_tpu_torch.tools._timing import (
    copies_beyond_l2, device_info, device_ms, l2_bytes, report,
)
from voxtral_tpu_torch.utils import resolve_device

# The numeric check's tolerance, relative to max|T4 output|: two bf16 ulps.
# e rounds to bf16 after f32 dots summed in another order (one dot against
# two half dots), and the output rounds to bf16 again.
T5_CHECK_RTOL = 2.0 ** -6
# The numeric check's batch, as in the tool.
CHECK_STREAMS = 2


def int4_check(streams: int, slots: int, kv_dim: int, g: torch.Generator,
               device) -> tuple[float, float]:
    """The tool's check: (max |T4 - T5|, max |T4|) on int4-range codes, T4 on
    them as int8 and T5 on them packed, the same q."""
    def codes():
        return torch.randint(-8, 8, (streams, slots, kv_dim), generator=g, device=device,
                             dtype=torch.int8)

    def packed(c):
        return pack_int4(c.view(streams, slots, kv_dim // HD, HD)).view(streams, slots, -1)

    kn, vn = codes(), codes()
    q = (torch.randn((streams, 1, GROUP * kv_dim), generator=g, device=device)
         * 0.05).to(torch.bfloat16)
    o8 = attn8(q, kn, vn).float()
    o4 = attn4(q, packed(kn), packed(vn)).float()
    return (o8 - o4).abs().max().item(), o8.abs().max().item()


def profile_int4_unpack(streams: int = 32, *, slots: int = 2088, kv_dim: int = 1024,
                        layers: int = 26, iters: int = 10, device="cuda") -> dict:
    """Returns {device, power_limit, count, streams, slots, kv_dim, layers,
    iters, copies8, copies4 (distinct ring pairs, enough for 4x the L2),
    bytes8, bytes4 (the rings a pass reads), t4_ms, t5_ms (per pass),
    t4_gbps, t5_gbps, t5_over_t4, check_err, check_max, check_tol}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn((streams, 1, GROUP * kv_dim), generator=g, device=dev)
         * 0.05).to(torch.bfloat16)
    pair8 = 2 * streams * slots * kv_dim
    n8 = copies_beyond_l2(pair8, l2_bytes(dev), layers)
    n4 = copies_beyond_l2(pair8 // 2, l2_bytes(dev), layers)

    def rings(n, lanes, lo):
        return [torch.randint(lo, 127, (streams, slots, lanes), generator=g, device=dev,
                              dtype=torch.int8) for _ in range(n)]

    k8, v8 = rings(n8, kv_dim, -127), rings(n8, kv_dim, -127)
    k4, v4 = rings(n4, kv_dim // 2, -128), rings(n4, kv_dim // 2, -128)
    res = dict(device_info(dev), streams=streams, slots=slots, kv_dim=kv_dim, layers=layers,
               iters=iters, copies8=n8, copies4=n4, bytes8=layers * pair8,
               bytes4=layers * pair8 // 2)
    res["t4_ms"] = device_ms(lambda _: chain(attn8, q, k8, v8, layers), iters, dev)
    res["t5_ms"] = device_ms(lambda _: chain(attn4, q, k4, v4, layers), iters, dev)
    res["t4_gbps"] = res["bytes8"] / res["t4_ms"] / 1e6
    res["t5_gbps"] = res["bytes4"] / res["t5_ms"] / 1e6
    res["t5_over_t4"] = res["t5_ms"] / res["t4_ms"]
    del k8, v8, k4, v4
    err, omax = int4_check(CHECK_STREAMS, slots, kv_dim, g, dev)
    res.update(check_err=err, check_max=omax, check_tol=T5_CHECK_RTOL * omax)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = profile_int4_unpack(int(os.environ.get("VOX_PROF_STREAMS", "32")),
                              device=args.device)
    report("int4 unpack", res,
           ("streams", "slots", "kv_dim", "layers", "copies8", "copies4", "iters"),
           [(f"int8  [P,{res['kv_dim']}] (T4 attn8) per {res['layers']}L", "t4_ms", "t4_gbps"),
            (f"int4p [P,{res['kv_dim'] // 2}] (T5 attn4) per {res['layers']}L", "t5_ms",
             "t5_gbps")])
    print(f"  T5 / T4 time {res['t5_over_t4']:.4f}; max |int8 - packed-int4| on identical "
          f"values {res['check_err']:.5f} (tol {res['check_tol']:.5f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
