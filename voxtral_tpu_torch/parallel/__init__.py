"""Tensor and data parallelism over torch.distributed (counterpart of
`voxtral_tpu/parallel/`): the layout and its rank-local slices in
`sharding`, the process group, the world's mesh, a rank's rows and the
host-control agreement in `distributed`, the process launcher in
`launch`."""

from voxtral_tpu_torch.parallel.distributed import (
    any_across_hosts, global_mesh, host_row_range, init_distributed,
)
from voxtral_tpu_torch.parallel.sharding import (
    DATA, MODEL, TensorParallel, fleet_state_shard_dims, make_mesh, param_shard_dims,
    shard_params,
)

__all__ = ["DATA", "MODEL", "TensorParallel", "any_across_hosts", "fleet_state_shard_dims",
           "global_mesh", "host_row_range", "init_distributed", "make_mesh",
           "param_shard_dims", "shard_params"]
