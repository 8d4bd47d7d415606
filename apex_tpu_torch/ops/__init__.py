"""Kernels and their plain versions (counterpart of :mod:`apex_tpu.ops`)."""

from apex_tpu_torch.ops._common import (
    FILL,
    keep_threshold,
    mix_seed,
    philox_bits,
    resolve_device,
    round_up,
)
from apex_tpu_torch.ops.dequant_gemm import (
    dequant_gemm,
    dequant_matmul,
    dequant_matmul_plain,
)
from apex_tpu_torch.ops.dropout import dropout_plain, fused_dropout
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bsh,
    flash_keep_mask,
    mha_reference,
    mha_with_mask_reference,
)
from apex_tpu_torch.ops.kv_quant import kv_quant_write, kv_quant_write_plain
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    layer_norm_backward,
    layer_norm_backward_plain,
    layer_norm_forward,
    layer_norm_forward_plain,
    layer_norm_reference,
    rms_norm_reference,
)
from apex_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_read_attention,
)
from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
    softmax_bwd_plain,
    softmax_fwd_plain,
    softmax_reference,
)

__all__ = [
    "FILL",
    "dequant_gemm",
    "dequant_matmul",
    "dequant_matmul_plain",
    "dropout_plain",
    "flash_attention_bsh",
    "flash_keep_mask",
    "fused_dropout",
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "fused_rms_norm",
    "fused_rms_norm_affine",
    "keep_threshold",
    "kv_quant_write",
    "kv_quant_write_plain",
    "layer_norm_backward",
    "layer_norm_backward_plain",
    "layer_norm_forward",
    "layer_norm_forward_plain",
    "layer_norm_reference",
    "mha_reference",
    "mha_with_mask_reference",
    "mix_seed",
    "paged_decode_attention",
    "paged_prefill_attention",
    "paged_prefill_attention_plain",
    "paged_read_attention",
    "philox_bits",
    "resolve_device",
    "rms_norm_reference",
    "round_up",
    "scaled_masked_softmax",
    "scaled_softmax",
    "scaled_upper_triang_masked_softmax",
    "softmax_bwd_plain",
    "softmax_fwd_plain",
    "softmax_reference",
]
