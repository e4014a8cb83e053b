"""Multi-process data parallelism: the process group, the world's mesh, the
rows a rank serves and the agreement on host control (counterpart of
`voxtral_tpu/parallel/distributed.py`).

Every rank is one process with one `TensorParallel` (parallel/sharding.py)
on a ('data', 'model') mesh that spans the world. A data rank serves its
own contiguous rows of the global stream batch: it feeds only its own
audio and reads only its own tokens; the model ranks of one data index
hold the same rows and split the heads, FFN columns and vocabulary. The
fleet step runs collectives (TP sums and gathers over 'model', the
lockstep cursor's max over 'data'), so every rank must run the same
sequence of steps: the host's control decisions that gate a step (is any
stream ready anywhere?) are agreed through `any_across_hosts`, one small
all-reduce. FleetManager(tp=) (runtime/manager.py) is the serving loop
that uses this.

The JAX module's `put_local_rows` and `fetch_local_rows` (:90-124) build
and read global arrays placed over processes; here a rank's tensors hold
only its own rows already, so they have no counterpart.

Backends: NCCL when this host has a card for each of its ranks; gloo on
the CPU or when ranks share a card (NCCL refuses two ranks on one GPU;
gloo stages CUDA tensors through the host). The control agreement always
runs on a gloo group over the world, on CPU tensors: the default group
when it is gloo, else one that `init_distributed` makes beside the NCCL
group.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from voxtral_tpu_torch.parallel.sharding import TensorParallel, make_mesh

_CONTROL = None            # the world's gloo group beside an NCCL default group


def init_distributed(coordinator_address: str, num_processes: int, process_id: int):
    """Join the process group: `coordinator_address` is rank 0's
    "host:port" (a "tcp://" prefix is optional). NCCL when CUDA has a card
    for each rank on this host, else gloo. The ranks on this host are
    LOCAL_WORLD_SIZE (torchrun sets it), else the whole world. Under NCCL
    it also makes the gloo group over the world that `any_across_hosts`
    runs on. Call once per process, before any collective."""
    global _CONTROL
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= local else "gloo"
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id)
    _CONTROL = dist.new_group(backend="gloo") if backend == "nccl" else None


def global_mesh(n_data: int | None = None, n_model: int = 1,
                device_type: str = "cuda") -> TensorParallel:
    """This rank's `TensorParallel` on an (n_data, n_model) mesh of every
    rank of the world (sharding.make_mesh). n_data None: world // n_model.
    Raises ValueError when n_model does not divide the world, or the mesh
    does not hold every rank (a torch.distributed mesh spans the world)."""
    world = dist.get_world_size()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"world {world} is not a multiple of n_model {n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, "
                         f"the world has {world}")
    return make_mesh(n_data, n_model, device_type)


def host_row_range(tp: TensorParallel, batch: int) -> tuple[int, int]:
    """[lo, hi) of the global stream batch that this rank serves: the rows
    of its data index, data_rank * batch / n_data up to the next. Model
    ranks of one data index share the range. Raises ValueError when the
    data axis does not divide `batch`."""
    rows = tp.local_batch(batch)
    return tp.data_rank * rows, (tp.data_rank + 1) * rows


def any_across_hosts(flags) -> np.ndarray:
    """Elementwise OR of a small bool vector over every rank of the world:
    one all-reduce (MAX) of a uint8 CPU tensor on a gloo group (the
    default group, or the one `init_distributed` made beside NCCL). The
    identity with one rank or without a process group."""
    flags = np.asarray(flags, bool)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flags
    t = torch.from_numpy(flags.astype(np.uint8))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL)
    return t.numpy().astype(bool)
