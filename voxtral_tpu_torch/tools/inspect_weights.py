"""Safetensors inspector, the port's counterpart of `tools/inspect_weights.py`
(the same output lines).

Usage: python -m voxtral_tpu_torch.tools.inspect_weights FILE.safetensors
       [--prefix P] [--summary]
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

from voxtral_tpu_torch.weights import SafetensorsFile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("--prefix", default=None)
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)

    path = args.file
    if os.path.isdir(path):
        path = os.path.join(path, "consolidated.safetensors")
    sf = SafetensorsFile(path)
    names = [n for n in sf.names()
             if args.prefix is None or n.startswith(args.prefix)]
    if args.summary:
        by_dtype = defaultdict(lambda: [0, 0])
        for n in names:
            meta = sf.info(n)
            s, e = meta["data_offsets"]
            by_dtype[meta["dtype"]][0] += 1
            by_dtype[meta["dtype"]][1] += e - s
        total = 0
        for dt, (cnt, size) in sorted(by_dtype.items()):
            print(f"{dt:6s} {cnt:5d} tensors  {size/1e9:8.3f} GB")
            total += size
        print(f"{'TOTAL':6s} {len(names):5d} tensors  {total/1e9:8.3f} GB")
        if sf.metadata:
            print("metadata:", sf.metadata)
        return 0
    for n in sorted(names):
        meta = sf.info(n)
        s, e = meta["data_offsets"]
        shape = "x".join(map(str, meta["shape"]))
        print(f"{n:80s} {meta['dtype']:5s} [{shape:>16s}] {(e-s)/1e6:9.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
