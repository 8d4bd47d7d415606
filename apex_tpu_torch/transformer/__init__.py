"""Transformer building blocks (counterpart of :mod:`apex_tpu.transformer`):
the enums and the fused scale-mask softmax dispatcher so far. Tensor,
pipeline and sequence parallelism, microbatches and MoE are not ported
yet."""

from apex_tpu_torch.transformer import enums, functional  # noqa: F401
