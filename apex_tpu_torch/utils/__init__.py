"""Shared utilities (counterpart of :mod:`apex_tpu.utils`): flat
communication buffers (:mod:`~apex_tpu_torch.utils.pytree`), grouped
all-reduces over ``torch.distributed``
(:mod:`~apex_tpu_torch.utils.collectives`), fault plans
(:mod:`~apex_tpu_torch.utils.faults`), artifact checksums
(:mod:`~apex_tpu_torch.utils.integrity`) and crash-safe checkpoints
(:mod:`~apex_tpu_torch.utils.checkpoint`)."""
