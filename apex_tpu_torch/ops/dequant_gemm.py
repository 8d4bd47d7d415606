"""Weight-only dequant-GEMM for quantized GPT weights (counterpart of
:mod:`apex_tpu.ops.dequant_gemm`).

``dequant_matmul(x, w_q, scale)`` computes ``(..., K) @ dequant(w_q)``
in fp32, where ``w_q`` is an int8 or float8_e4m3fn ``(K, N)`` kernel in
the JAX ``(in, out)`` layout and ``scale`` its ``(N,)`` fp32
per-output-channel scale. On CUDA tensors it runs the hand-written
kernel B15 (``csrc/dequant_gemm.cu``), which dequantizes weight tiles in
shared memory so the full-precision weights never exist in device
memory; on CPU tensors it runs :func:`dequant_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch import _build

_W_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def dequant_matmul_plain(x, w_q, scale):
    """Dequantize the whole kernel to fp32, then one fp32 matmul (the
    JAX ``dequant_matmul_reference``)."""
    w = w_q.float() * scale.float()[None, :]
    return torch.matmul(x.float(), w)


def dequant_gemm(x2d, w_q, scale):
    """Launch kernel B15 on CUDA tensors: ``x2d`` ``(M, K)`` (cast to
    fp32), ``w_q`` ``(K, N)`` int8/e4m3, ``scale`` ``(N,)``. Returns
    ``(M, N)`` fp32. Raises on an unsupported dtype, shape or device,
    or a failed launch."""
    if w_q.dtype not in _W_CODES:
        raise ValueError(f"dequant_gemm: weights must be int8 or "
                         f"float8_e4m3fn, got {w_q.dtype}")
    if x2d.dim() != 2 or w_q.dim() != 2 or x2d.shape[1] != w_q.shape[0]:
        raise ValueError(f"dequant_gemm: shapes {tuple(x2d.shape)} @ "
                         f"{tuple(w_q.shape)} do not contract")
    M, K = x2d.shape
    N = w_q.shape[1]
    if tuple(scale.shape) != (N,):
        raise ValueError(f"dequant_gemm: scale must be ({N},), got "
                         f"{tuple(scale.shape)}")
    for t in (w_q, scale):
        if t.device != x2d.device:
            raise ValueError("dequant_gemm: every input must be on "
                             f"{x2d.device}, got one on {t.device}")
    if not w_q.is_contiguous():
        # a copy here would move the whole weight on every call
        raise ValueError("dequant_gemm: w_q must be a contiguous (K, N) "
                         "row-major buffer")
    x2d = x2d.float().contiguous()
    scale = scale.float().contiguous()
    lib = _build.lib()
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    # the kernel splits K across blocks at small M; the splits' partial
    # sums go to this workspace and are added in a fixed order
    k_chunk = ctypes.c_int(0)
    splits = lib.dequant_gemm_splits(M, K, N, ctypes.byref(k_chunk))
    work = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=x2d.device) if splits > 1 else None)
    code = lib.dequant_gemm(
        x2d.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), M, K, N,
        _W_CODES[w_q.dtype], _build.stream_ptr(x2d.device))
    _build.check(code, "dequant_gemm")
    _build.launches["dequant_gemm"] += 1
    return out


def dequant_matmul(x, w_q, scale):
    """Quantized-weight matmul ``(..., K) @ dequant((K, N)) -> (..., N)``
    fp32. CUDA tensors run kernel B15; CPU tensors the plain chain."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = w_q.shape[1]
    x2d = x.reshape(-1, K)
    if x.device.type == "cpu":
        out = dequant_matmul_plain(x2d, w_q, scale)
    else:
        out = dequant_gemm(x2d, w_q, scale)
    return out.reshape(*lead, N)
