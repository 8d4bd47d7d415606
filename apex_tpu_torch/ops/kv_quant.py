"""Quantized KV storage: the per-row int8/fp8 quantizer of the paged
cache and its write (counterpart of ``apex_tpu.serving.kv_cache.
quantize_kv_rows`` and of ``write_kv``'s quantized branch, which the JAX
package leaves to XLA's fusion).

Per (token, head) row: ``scale = max|row| / qmax`` (127 for int8, 448,
the e4m3 finite max, for fp8) and ``x = row / where(scale > 0, scale,
1)``; fp8 rounds ``x`` to nearest by the cast, int8 stochastically,
``floor(x + u)`` clamped to [-127, 127]. The JAX package draws ``u`` from
threefry keyed by ``fold_in(fold_in(PRNGKey(0x51CA17), stream),
position)``, which torch cannot reproduce; the port keeps the contract
that ``u`` is a pure function of (stream, absolute position, element) and
draws it from Philox4x32-10: element ``e = h * D + d`` of the row at
position ``p`` takes word ``e % 4`` of the generator at counter ``(e //
4, p, 0, 0)`` under key ``(0x51CA17, stream)``, and ``u = (word >> 8) *
2^-24``. The stream is ``2 * layer`` for K and ``2 * layer + 1`` for V.
So a token rounds the same way in any lane, block, chunk, ``decode_steps``
or preemption, and :func:`quantize_kv_rows_with` fed the JAX noise gives
the JAX bytes. ``h`` is the head's index in the whole token row: a model
shard holding heads ``h0 .. h0 + H - 1`` of a sharded pool draws with
``head_offset = h0``, so its bytes are the unsharded pool's head slice.

:func:`kv_quant_write` writes one layer's valid K and V rows, payload and
scales, at the coordinates of ``serving.kv_cache.write_coords``: one
launch of the hand-written kernel ``csrc/kv_quant_write.cu`` on CUDA
tensors, :func:`kv_quant_write_plain` on CPU tensors. There is no flag
and no fallback: the tensors' device decides.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import DTYPE_CODES, philox_words
from apex_tpu_torch.ops.multi_tensor import stochastic_round_with

# the storage modes of KVCache.create: None = full precision, "int8" =
# symmetric int8 with per-row fp32 scales, "fp8" = float8_e4m3fn with
# per-row fp32 scales
KV_QUANT_MODES = (None, "int8", "fp8")

# the rounding noise's key word (the JAX package's _KV_QUANT_SEED): a
# module constant, not the engine seed, so the same K/V at the same
# position round alike across engines and re-prefills
KV_QUANT_SEED = 0x51CA17

_POOL_MODE_CODES = {"int8": 0, "fp8": 1}


def fp8_kv_dtype() -> torch.dtype:
    """The fp8 storage dtype (e4m3, finite max 448)."""
    return torch.float8_e4m3fn


def quant_storage_dtype(quantization: str) -> torch.dtype:
    if quantization == "int8":
        return torch.int8
    if quantization == "fp8":
        return fp8_kv_dtype()
    raise ValueError(f"unknown kv quantization {quantization!r} "
                     f"(expected one of {KV_QUANT_MODES})")


def quant_value_max(quantization: str) -> float:
    """The quantizer's design max: the scale maps a row's largest
    magnitude onto it."""
    if quantization == "int8":
        return 127.0
    return float(torch.finfo(quant_storage_dtype(quantization)).max)


def pool_quantization(dtype: torch.dtype) -> Optional[str]:
    """The storage mode of a pool of ``dtype`` (None: full precision)."""
    if dtype == torch.int8:
        return "int8"
    if dtype == fp8_kv_dtype():
        return "fp8"
    return None


def kv_quant_noise(stream: int, positions: torch.Tensor, num_heads: int,
                   head_dim: int, head_offset: int = 0) -> torch.Tensor:
    """The int8 rounding noise of rows at ``positions`` (int, any shape
    ``P``) in ``stream``: fp32 ``P + (num_heads, head_dim)`` in [0, 1),
    a pure function of (stream, position, element). The heads are
    ``head_offset .. head_offset + num_heads - 1`` of the token row."""
    e0 = head_offset * head_dim
    E = num_heads * head_dim
    groups = torch.arange(e0 // 4, -(-(e0 + E) // 4), dtype=torch.int64,
                          device=positions.device)
    pos = positions.reshape(-1, 1).long()
    words = philox_words(groups[None, :], pos, KV_QUANT_SEED, int(stream))
    first = e0 - 4 * (e0 // 4)
    flat = words.reshape(pos.shape[0], 4 * groups.numel())[:, first:first + E]
    u = (flat >> 8).to(torch.float32) * 2.0 ** -24
    return u.reshape(tuple(positions.shape) + (num_heads, head_dim))


def quantize_kv_rows_with(values: torch.Tensor,
                          noise: Optional[torch.Tensor], quantization: str):
    """Quantize ``[..., H, D]`` rows given their int8 rounding noise (the
    same shape, in [0, 1); ignored for fp8). Returns ``(payload [..., H,
    D] in the storage dtype, scales [..., H] fp32)``; an all-zero row
    stores 0 with scale 0."""
    v32 = values.to(torch.float32)
    amax = v32.abs().amax(dim=-1)
    # a tensor divisor: CUDA torch divides by a Python scalar as a product
    # with its reciprocal, which rounds differently from the IEEE
    # quotient the CPU, the JAX package and the kernel take
    scale = amax / amax.new_tensor(quant_value_max(quantization))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    x = v32 / safe[..., None]
    if quantization == "fp8":
        return x.to(fp8_kv_dtype()), scale
    return stochastic_round_with(x, quant_storage_dtype(quantization),
                                 noise), scale


def quantize_kv_rows(values: torch.Tensor, positions: torch.Tensor,
                     quantization: str, stream: int = 0,
                     head_offset: int = 0):
    """Quantize ``[B, S, H, D]`` K/V rows at absolute ``positions`` ``[B,
    S]`` with the noise of ``stream`` (:func:`kv_quant_noise`); the rows
    hold heads ``head_offset ..`` of the token row."""
    noise = None
    if quantization == "int8":
        noise = kv_quant_noise(stream, positions, values.shape[-2],
                               values.shape[-1], head_offset)
    return quantize_kv_rows_with(values, noise, quantization)


def kv_quant_write_plain(k_pool, v_pool, k_scale, v_scale, layer: int,
                         coords, k_values, v_values,
                         head_offset: int = 0) -> None:
    """The plain version of :func:`kv_quant_write`: quantize the rows at
    ``coords`` (``(page, off, b, s, pos)``) and write payload and scales
    into ``layer`` of the pools, in place."""
    mode = pool_quantization(k_pool.dtype)
    page, off, b, s, pos = coords
    for pool, spool, vals, stream in (
            (k_pool, k_scale, k_values, 2 * layer),
            (v_pool, v_scale, v_values, 2 * layer + 1)):
        q, sc = quantize_kv_rows(vals[b, s], pos, mode, stream, head_offset)
        pool[layer, page, off] = q
        spool[layer, page, off] = sc


def _check_cuda_args(k_pool, v_pool, k_scale, v_scale, coords, k_values,
                     v_values):
    mode = pool_quantization(k_pool.dtype)
    if mode is None or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"kv_quant_write: int8 or fp8 pools, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if k_values.dtype not in DTYPE_CODES or v_values.dtype != k_values.dtype:
        raise ValueError(f"kv_quant_write: fp32, bf16 or fp16 values, got "
                         f"{k_values.dtype}/{v_values.dtype}")
    L, N, bs, H, D = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or k_values.dim() != 4 \
            or tuple(k_values.shape[2:]) != (H, D) \
            or v_values.shape != k_values.shape:
        raise ValueError(f"kv_quant_write: values {tuple(k_values.shape)} "
                         f"do not match the pool {tuple(k_pool.shape)}")
    for sc in (k_scale, v_scale):
        if sc is None or sc.dtype != torch.float32 \
                or tuple(sc.shape) != (L, N, bs, H):
            raise ValueError("kv_quant_write: scales must be fp32 "
                             "[L, N, bs, H]")
    if not 1 <= D <= 256:
        raise ValueError(f"kv_quant_write: head_dim {D} past 256")
    for t in (k_pool, v_pool, k_scale, v_scale, k_values, v_values,
              *coords):
        if t.device != k_pool.device:
            raise ValueError("kv_quant_write: every input must be on "
                             f"{k_pool.device}, got one on {t.device}")
    for t in (k_pool, v_pool, k_scale, v_scale):
        if not t.is_contiguous():
            raise ValueError("kv_quant_write: the pools are written in "
                             "place and must be contiguous")
    return mode


def kv_quant_write(k_pool, v_pool, k_scale, v_scale, layer: int, coords,
                   k_values, v_values, head_offset: int = 0) -> None:
    """Quantize and write one layer's valid K and V rows (``[B, S, H,
    D]``) into int8/fp8 pools ``[L, N, bs, H, D]`` and their fp32 scales
    ``[L, N, bs, H]``, in place, at ``coords`` = ``(page, off, b, s,
    pos)`` (int64, one entry a valid row). The pool holds heads
    ``head_offset .. head_offset + H - 1`` of the token row (a model
    shard's; the rounding noise is keyed by the global head). CUDA
    tensors launch the kernel (once, also when no row is valid); CPU
    tensors run :func:`kv_quant_write_plain`. Raises on an unsupported
    shape or dtype, or a failed launch."""
    if not head_offset >= 0:
        raise ValueError(f"kv_quant_write: head_offset must be >= 0, got "
                         f"{head_offset}")
    if k_pool.device.type == "cpu":
        kv_quant_write_plain(k_pool, v_pool, k_scale, v_scale, layer,
                             coords, k_values, v_values, head_offset)
        return
    mode = _check_cuda_args(k_pool, v_pool, k_scale, v_scale, coords,
                            k_values, v_values)
    L, N, bs, H, D = k_pool.shape
    k_values = k_values.contiguous()
    v_values = v_values.contiguous()
    page, off, b, s, pos = (c.to(torch.int64).contiguous() for c in coords)
    code = _build.lib().kv_quant_write(
        k_values.data_ptr(), v_values.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        page.data_ptr(), off.data_ptr(), b.data_ptr(), s.data_ptr(),
        pos.data_ptr(), page.numel(), k_values.shape[1], H, D, int(layer),
        N, bs, int(head_offset), DTYPE_CODES[k_values.dtype],
        _POOL_MODE_CODES[mode], _build.stream_ptr(k_pool.device))
    _build.check(code, "kv_quant_write")
    _build.launches["kv_quant_write"] += 1
