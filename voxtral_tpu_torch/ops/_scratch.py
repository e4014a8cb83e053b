"""Per-card state shared by the kernel wrappers: the SM count, and the
zeroed int32 scratch through which a kernel's split blocks merge in one
launch (integer atomics, a last-block counter). Every launch leaves its
scratch zero, so a buffer is made once per card and name and kept."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def zeroed_scratch(index: int, name: str, n: int) -> torch.Tensor:
    """Zeroed int32 [n] on card `index`, one buffer per (name, n): a kernel
    that uses it must leave it zero. The caller checks that n covers the
    launch."""
    return torch.zeros(n, dtype=torch.int32, device=f"cuda:{index}")
