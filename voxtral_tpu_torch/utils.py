"""Small runtime helpers shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without CUDA raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def device_memory_gb(device) -> dict:
    """Device memory of a CUDA device in GiB (counterpart of
    `voxtral_tpu/utils.py:8`): `hbm_used_gb`, the tensors PyTorch's
    allocator holds, and `hbm_limit_gb`, the card's total memory. Returns
    {} for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(dev)
    return {"hbm_used_gb": round(torch.cuda.memory_allocated(dev) / 2**30, 2),
            "hbm_limit_gb": round(total / 2**30, 2)}
