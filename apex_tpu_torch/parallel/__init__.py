"""Data parallelism over ``torch.distributed`` (counterpart of
:mod:`apex_tpu.parallel`): DistributedDataParallel's gradient
synchronization, SyncBatchNorm, LARC and the process bootstrap."""

from apex_tpu_torch.parallel.bootstrap import (
    get_chip_count,
    get_host_count,
    get_host_rank,
    get_rank,
    get_world_size,
    init_process_group,
)
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    flat_dist_call,
)
from apex_tpu_torch.parallel.larc import LARC
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
)

__all__ = [
    "DistributedDataParallel",
    "LARC",
    "SyncBatchNorm",
    "convert_syncbn_model",
    "flat_dist_call",
    "get_chip_count",
    "get_host_count",
    "get_host_rank",
    "get_rank",
    "get_world_size",
    "init_process_group",
]
