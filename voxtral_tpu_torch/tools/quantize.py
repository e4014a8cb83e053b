"""Offline Q8 weight quantizer, the port's counterpart of `tools/quantize.py`
(same file format, same tensor bytes): every 2-D tensor becomes per-row
symmetric int8 (scale = amax/127) stored under the custom safetensors dtype
"Q8" as [rows f32 scales][rows * cols int8]; everything else is stored F32.
An already-Q8 tensor passes through. Numpy and host tensors only.

Usage: python -m voxtral_tpu_torch.tools.quantize IN_DIR_OR_FILE OUT_DIR
"""

from __future__ import annotations

import os
import shutil
import sys

from voxtral_tpu_torch.quant import quantize_np
from voxtral_tpu_torch.weights import SafetensorsFile, save_safetensors


def quantize_file(src: str, dst: str, verbose: bool = True) -> None:
    sf = SafetensorsFile(src)
    out: dict = {}
    n_q8 = n_f32 = 0
    for name in sf.names():
        if sf.is_q8(name):
            scales, q = sf.q8_tensor(name)
            out[name] = ("Q8", scales.numpy(), q.numpy(), tuple(q.shape))
            n_q8 += 1
            continue
        arr = sf.tensor_f32(name).numpy()
        if arr.ndim == 2:
            qt = quantize_np(arr, axis=0)              # per safetensors row
            out[name] = ("Q8", qt.s, qt.q, arr.shape)
            n_q8 += 1
        else:
            out[name] = arr
            n_f32 += 1
    save_safetensors(dst, out, metadata={"quantization": "Q8",
                                         "producer": "voxtral_tpu_torch"})
    if verbose:
        src_gb = os.path.getsize(src) / 1e9
        dst_gb = os.path.getsize(dst) / 1e9
        print(f"{n_q8} tensors -> Q8, {n_f32} -> F32; "
              f"{src_gb:.2f} GB -> {dst_gb:.2f} GB")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src, out_dir = argv
    if os.path.isdir(src):
        src_file = os.path.join(src, "consolidated.safetensors")
    else:
        src_file, src = src, os.path.dirname(src)
    os.makedirs(out_dir, exist_ok=True)
    quantize_file(src_file, os.path.join(out_dir, "consolidated.safetensors"))
    # tokenizer and params ride along so the output dir is self-contained
    for extra in ("tekken.json", "params.json"):
        p = os.path.join(src, extra)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(out_dir, extra))
    return 0


if __name__ == "__main__":
    sys.exit(main())
