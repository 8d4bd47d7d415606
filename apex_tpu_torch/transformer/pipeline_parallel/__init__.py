"""Pipeline parallelism (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel`): imperative schedules over
``torch.distributed`` point-to-point transfers between the stages'
ranks, and their efficiency accounting."""

from apex_tpu_torch.transformer.pipeline_parallel import (  # noqa: F401
    efficiency,
    p2p_communication,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    spmd_pipeline,
    spmd_pipeline_interleaved,
)
