"""Per-card state shared by the kernel wrappers: the SM count, the zeroed
int32 scratch through which a kernel's split blocks merge in one launch
(integer atomics, a last-block counter; every launch leaves its scratch
zero, so a buffer is made once per card and name and kept), the rule that
splits a reduction's rows over blocks, and the rule that splits K over the
blocks of a thread-block cluster (T3, K2) with the runtime's count of
resident blocks it needs."""

from __future__ import annotations

import ctypes
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


def split_rows(units: int, rows: int, sms: int, per_sm: int, quantum: int) -> tuple[int, int]:
    """(rows per split, splits): each of `units` independent reductions
    split over its `rows` until the grid has about `per_sm` blocks per SM,
    each split a multiple of `quantum` rows and none empty."""
    splits = max(1, min(-(-per_sm * sms // units), -(-rows // quantum)))
    k_slice = -(-(-(-rows // splits)) // quantum) * quantum
    return k_slice, -(-rows // k_slice)


def cluster_splits(k: int, tiles: int, stage_rows: int, resident,
                   max_splits: int) -> tuple[int, int]:
    """(k_slice, splits) for `tiles` column tiles whose splits of K form one
    cluster each: the most splits (at most `max_splits`) whose grid stays
    within one wave of `resident[c - 1]` blocks (the kernel's blocks
    resident at once in clusters of c), each slice whole `stage_rows`
    stages and no split empty."""
    stages = -(-k // stage_rows)
    splits = max([1] + [c for c in range(2, min(max_splits, stages) + 1)
                        if tiles * c <= resident[c - 1]])
    k_slice = -(-stages // splits) * stage_rows
    return k_slice, -(-k // k_slice)


def resident_per_cluster(query, index: int, rows: int, max_splits: int,
                         name: str) -> tuple[int, ...]:
    """Blocks of a kernel for `rows` rows of x resident at once on card
    `index` in clusters of 1..max_splits blocks, from its C entry
    `query(rows, cluster, int* blocks)` (the CUDA runtime's occupancy)."""
    out = []
    with torch.cuda.device(index):
        for c in range(1, max_splits + 1):
            blocks = ctypes.c_int(0)
            err = query(rows, c, ctypes.byref(blocks))
            if err != 0 or (c == 1 and blocks.value < 1):
                raise RuntimeError(f"{name} occupancy query failed: CUDA error {err}")
            out.append(blocks.value)
    return tuple(out)
