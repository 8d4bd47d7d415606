"""Transformer building blocks (counterpart of :mod:`apex_tpu.transformer`):
the enums, the fused scale-mask softmax dispatcher, the model-parallel rank
layout (``parallel_state``) and Megatron tensor and sequence parallelism
(``tensor_parallel``), with its test helpers (``testing``), pipeline
parallelism (``pipeline_parallel``) and the microbatch calculators
(``microbatches``). MoE is not ported yet (ROADMAP A.4 item 20c)."""

from apex_tpu_torch.transformer import enums, functional  # noqa: F401
from apex_tpu_torch.transformer import microbatches  # noqa: F401
from apex_tpu_torch.transformer import parallel_state  # noqa: F401
from apex_tpu_torch.transformer import tensor_parallel  # noqa: F401
from apex_tpu_torch.transformer import pipeline_parallel  # noqa: F401
