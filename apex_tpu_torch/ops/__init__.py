"""Kernels and their plain versions (counterpart of :mod:`apex_tpu.ops`)."""

from apex_tpu_torch.ops._common import FILL, resolve_device, round_up
from apex_tpu_torch.ops.dequant_gemm import (
    dequant_gemm,
    dequant_matmul,
    dequant_matmul_plain,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm_reference,
    rms_norm_reference,
)
from apex_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_read_attention,
)

__all__ = [
    "FILL",
    "dequant_gemm",
    "dequant_matmul",
    "dequant_matmul_plain",
    "layer_norm_reference",
    "paged_decode_attention",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "paged_read_attention",
    "resolve_device",
    "rms_norm_reference",
    "round_up",
]
