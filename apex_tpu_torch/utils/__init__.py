"""Shared utilities (counterpart of :mod:`apex_tpu.utils`): flat
communication buffers (:mod:`~apex_tpu_torch.utils.pytree`) and grouped
all-reduces over ``torch.distributed``
(:mod:`~apex_tpu_torch.utils.collectives`)."""
