"""Fused dropout with a counter-based mask replayed in the backward
(counterpart of :mod:`apex_tpu.ops.dropout`).

``fused_dropout(x, rate, seed)`` keeps element ``i`` of ``x`` iff
element ``i`` of the Philox4x32-10 stream keyed by ``seed``
(:func:`apex_tpu_torch.ops._common.philox_bits`) is below
``keep_threshold(rate)``, and scales kept elements by ``1 / (1 - rate)``.
The backward runs the same function on the gradient with the same seed,
so the mask is replayed, never stored. On CUDA tensors it launches the
hand-written kernel B3 (``csrc/dropout.cu``); on CPU tensors it runs
:func:`dropout_plain`, which draws the same bits, so the two agree bit
for bit.

``bits=`` takes explicit uint32 random bits in ``x``'s element order
instead of the seed's stream. It exists for parity with the JAX
package's interpret path (``jax.random.bits`` flattened, see
``apex_tpu/ops/dropout.py::_apply``) and runs on the CPU only.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import (
    DTYPE_CODES,
    keep_threshold,
    philox_bits,
)



def keep_scale(rate: float, dtype) -> float:
    """``1 / (1 - rate)`` rounded to ``dtype``: the JAX kernel multiplies
    by the weakly typed Python constant, which JAX rounds to ``x``'s
    dtype first."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype).item()


def dropout_plain(x, rate: float, seed=None, bits=None):
    """The plain version of kernel B3: the same bits, threshold and
    scale, in PyTorch."""
    if bits is None:
        bits = philox_bits(seed, 0, x.numel(), x.device)
    keep = bits.reshape(x.shape).to(torch.int64) < keep_threshold(rate)
    scale = torch.full((), keep_scale(rate, x.dtype), dtype=x.dtype,
                       device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dropout_kernel(x, rate: float, seed: int):
    """Launch kernel B3 on a CUDA tensor (fp32, bf16 or fp16). Raises on
    an unsupported dtype or a failed launch."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_dropout: x must be float32, bfloat16 or "
                         f"float16, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _build.lib()
    code = lib.fused_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), DTYPE_CODES[x.dtype],
        int(seed) & 0xFFFFFFFF, keep_threshold(rate),
        keep_scale(rate, x.dtype), _build.stream_ptr(x.device))
    _build.check(code, "fused_dropout")
    _build.launches["dropout"] += 1
    return y


def _dropout(x, rate, seed, bits):
    if bits is not None:
        if x.device.type != "cpu":
            raise ValueError("fused_dropout: explicit bits are a CPU parity "
                             "input; the kernel draws its own from the seed")
        return dropout_plain(x, rate, bits=bits)
    if x.device.type == "cpu":
        return dropout_plain(x, rate, seed)
    return dropout_kernel(x, rate, seed)


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, bits):
        ctx.rate, ctx.seed, ctx.bits = rate, seed, bits
        return _dropout(x, rate, seed, bits)

    @staticmethod
    def backward(ctx, g):
        # replay: dropout is self-adjoint up to the same mask and scale
        return _dropout(g, ctx.rate, ctx.seed, ctx.bits), None, None, None


def fused_dropout(x, rate: float, seed=None, bits=None):
    """``dropout(x, rate)`` with the mask drawn from ``seed`` (an int) and
    replayed in the backward. ``rate == 0`` returns ``x``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_dropout: rate must be in [0, 1), got "
                         f"{rate}")
    if rate == 0.0:
        return x
    if seed is None and bits is None:
        raise ValueError("fused_dropout with rate > 0 requires a seed")
    return _FusedDropout.apply(x, rate, seed, bits)
