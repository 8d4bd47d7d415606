"""Shared helpers for the port's kernel wrappers and entry points
(counterpart of :mod:`apex_tpu.ops._common`)."""

from __future__ import annotations

import torch

# dtype codes of the training kernels' C interfaces (layer norm, dropout,
# softmax, flash attention; the types of csrc/dtypes.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the finite masked fill shared by every attention read: a dead key
# position scores FILL, not -inf, so a row with no visible key degrades
# to a uniform read instead of NaN (apex_tpu.ops.flash_attention.FILL)
FILL = -30000.0


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return (x + m - 1) // m * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    CUDA card. Without a CUDA device the default raises: the port never
    runs on the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def bf16_ulps(out, ref, floor=2.0 ** -8) -> float:
    """Largest ``|out - ref|`` in bf16 ulps (2^-7 of the binade) of the
    larger magnitude of the two, taken no smaller than at ``floor``: near
    0 two fp32 results differ by ~1e-6 of the terms they summed, not by a
    share of the result. The tolerance the port holds a bf16 kernel to
    against its plain version."""
    out, ref = out.detach().float(), ref.detach().float()
    mag = torch.maximum(out.abs(), ref.abs()).clamp(min=floor)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    return ((out - ref).abs() / ulp).max().item()


def keep_threshold(dropout_rate: float) -> int:
    """uint32 threshold shared by every fused-dropout kernel and its plain
    version: a lane is kept iff its random bits are < this. keep_prob maps
    onto the full uint32 range (the same compare-against-scaled-keep-prob
    construction as apex_tpu.ops._common.keep_threshold)."""
    keep = 1.0 - dropout_rate
    return min(int(keep * 4294967296.0), 4294967295)


def mix_seed(seed: int, n: int) -> int:
    """Decorrelated non-negative int32 seed from (seed, n): the
    golden-ratio multiplicative hash in uint32 wraparound arithmetic of
    apex_tpu.ops._common.mix_seed, on host ints."""
    mixed = (seed & _MASK32) ^ ((n * 0x9E3779B9) & _MASK32)
    return mixed & 0x7FFFFFFF


# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC'11; the Random123 constants). The CUDA kernels carry the same
# generator in csrc/philox.cuh; the dropout streams key it as counter =
# (element index // 4, 0, 0), key = (seed, 0), and element i takes word
# i % 4 of its counter's output, so a kernel and its plain version draw
# identical bits. The quantized KV write puts a token position in the
# counter's second word and a stream in the key's (philox_words).
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a in [0, 2^32) and
    a 32-bit constant m, without int64 overflow: m is split into 16-bit
    halves so every partial product stays below 2^49."""
    x = a * (m >> 16)
    y = a * (m & 0xFFFF)
    t = ((x & 0xFFFF) << 16) + y
    return ((x >> 16) + (t >> 32)) & _MASK32, t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors holding uint32 words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: int, offset: int, n: int, device="cpu"):
    """uint32 random bits (as int64 in [0, 2^32)) of elements ``offset ..
    offset + n - 1`` of the stream keyed by ``seed``."""
    g0 = offset >> 2
    g1 = (offset + n - 1) >> 2
    g = torch.arange(g0, g1 + 1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK32, g >> 32, zero, zero,
                          seed & _MASK32, 0)
    flat = torch.stack(words, dim=1).reshape(-1)
    start = offset - 4 * g0
    return flat[start:start + n]


def philox_words(c0, c1, k0: int, k1: int):
    """The four uint32 words (int64 in [0, 2^32), stacked on a new last
    dim) of counter ``(c0, c1, 0, 0)`` under key ``(k0, k1)``: ``c0`` and
    ``c1`` are broadcastable int64 tensors of uint32 words."""
    c0, c1 = torch.broadcast_tensors(c0 & _MASK32, c1 & _MASK32)
    zero = torch.zeros_like(c0)
    return torch.stack(philox4x32_10(c0, c1, zero, zero, k0 & _MASK32,
                                     k1 & _MASK32), dim=-1)
