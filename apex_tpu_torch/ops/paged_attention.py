"""Paged attention for the serving path: a chunk of queries against the
paged KV pool (counterpart of ``apex_tpu.ops.flash_attention.
paged_prefill_attention`` / ``paged_decode_attention`` and of the Pallas
read kernel in ``apex_tpu.ops.paged_attention_pallas``).

On a CUDA tensor the read runs on the hand-written kernel B14
(``csrc/paged_read.cu``): it walks each lane's block table, stages the
K/V rows of each pool block through shared memory and keeps an online
fp32 softmax, so the gathered ``[B, ctx, H, D]`` K/V never exist in
device memory. When (lane, head, query tile) blocks alone would leave
SMs idle, the table is split across blocks and a second kernel merges
the splits. On a CPU tensor it runs :func:`paged_prefill_attention_
plain`, the JAX package's XLA chain written in torch. There is no flag
and no fallback between the two: the tensor's device decides.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import FILL

# dtype codes of the C interface (csrc/paged_read.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
_MAX_HEAD_DIM = 128


def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables,
                                  q_positions, context_lens, scale=1.0,
                                  k_scales=None, v_scales=None):
    """The plain chain: clip the table into the pool, gather the lanes'
    K/V rows, fp32 scores, the FILL mask, a full softmax over every
    gathered row, an fp32 weighted sum. Same layouts and semantics as
    :func:`paged_prefill_attention`; the output takes ``q.dtype``."""
    B, C, H, D = q.shape
    N = k_pages.shape[0]
    tbl = block_tables.long().clamp(max=N - 1)
    k = k_pages[tbl].reshape(B, -1, H, D)             # [B, ctx_max, H, D]
    v = v_pages[tbl].reshape(B, -1, H, D)
    if k_scales is not None:
        k = k.float() * k_scales[tbl].reshape(B, -1, H)[..., None]
        v = v.float() * v_scales[tbl].reshape(B, -1, H)[..., None]
    ctx_max = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kpos = torch.arange(ctx_max, device=q.device)[None]  # [1, ctx_max]
    lens = context_lens.long()
    if q_positions is None:
        visible = (kpos < lens[:, None])[:, None, :]     # [B, 1, ctx_max]
    else:
        visible = ((kpos[:, None, :] <= q_positions.long()[:, :, None])
                   & (kpos[:, None, :] < lens[:, None, None]))
    s = torch.where(visible[:, None], s, torch.full_like(s, FILL))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _check_cuda_args(q, k_pages, v_pages, block_tables, q_positions,
                     context_lens, k_scales, v_scales):
    B, C, H, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_read: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_read: unsupported pool dtypes "
                         f"{k_pages.dtype}/{v_pages.dtype}")
    quant = k_pages.dtype in (torch.int8, torch.float8_e4m3fn)
    if quant != (k_scales is not None) or (k_scales is None) != (
            v_scales is None):
        raise ValueError("paged_read: int8/fp8 pools need k_scales and "
                         "v_scales, full-precision pools take none")
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (H, D) or (
            v_pages.shape != k_pages.shape):
        raise ValueError(f"paged_read: pools {tuple(k_pages.shape)} do not "
                         f"match q heads/dim ({H}, {D})")
    if not 1 <= D <= _MAX_HEAD_DIM or (D * k_pages.element_size()) % 16:
        raise ValueError(f"paged_read: head_dim {D} must be at most "
                         f"{_MAX_HEAD_DIM} and fill whole 16-byte loads "
                         f"of {k_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("paged_read: block_tables must be [B, M]")
    if tuple(context_lens.shape) != (B,):
        raise ValueError("paged_read: context_lens must be [B]")
    if q_positions is not None and tuple(q_positions.shape) != (B, C):
        raise ValueError("paged_read: q_positions must be [B, C]")
    tensors = [q, k_pages, v_pages, block_tables, context_lens]
    tensors += [t for t in (q_positions, k_scales, v_scales)
                if t is not None]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_read: every input must be on "
                             f"{q.device}, got one on {t.device}")
    if quant and tuple(k_scales.shape) != tuple(k_pages.shape[:3]):
        raise ValueError("paged_read: scales must be [N, bs, H]")


def paged_read_attention(q, k_pages, v_pages, block_tables, q_positions,
                         context_lens, scale=1.0, k_scales=None,
                         v_scales=None):
    """Launch kernel B14 on CUDA tensors (see ``csrc/paged_read.cu``).
    Raises on an unsupported shape or dtype, or a failed launch."""
    _check_cuda_args(q, k_pages, v_pages, block_tables, q_positions,
                     context_lens, k_scales, v_scales)
    B, C, H, D = q.shape
    N, bs = k_pages.shape[0], k_pages.shape[1]
    M = block_tables.shape[1]
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_read: pools must be 16-byte aligned")
    tbl = block_tables.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    qpos = (None if q_positions is None
            else q_positions.to(torch.int32).contiguous())
    if k_scales is not None:
        k_scales = k_scales.float().contiguous()
        v_scales = v_scales.float().contiguous()
    out = torch.empty_like(q)
    lib = _build.lib()
    # per split: running max, sum and unnormalized accumulator
    splits = lib.paged_read_splits(B, C, H, M, bs)
    work = (torch.empty(B * C * H * splits * (D + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    code = lib.paged_read(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        tbl.data_ptr(), None if qpos is None else qpos.data_ptr(),
        ctx.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, C, H, D, N, bs, M,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype], float(scale),
        _build.stream_ptr(q.device))
    _build.check(code, "paged_read")
    _build.launches["paged_read"] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, q_positions,
                            context_lens, scale=1.0, k_scales=None,
                            v_scales=None):
    """Chunked-prefill attention against one layer's paged pool.

    Args:
      q: ``[B, C, H, D]`` query chunk.
      k_pages, v_pages: ``[N, bs, H, D]`` one layer's pools, already
        holding this chunk's K/V.
      block_tables: ``[B, M]`` int32 block ids in sequence order;
        unallocated entries hold ``N`` (one past the pool) and are
        clipped into it, their positions masked by ``context_lens``.
      q_positions: ``[B, C]`` int32 absolute query positions, or None for
        the decode mask ``kpos < context_lens``.
      context_lens: ``[B]`` int32 valid tokens including this chunk's.
      scale: softmax temperature.
      k_scales, v_scales: ``[N, bs, H]`` fp32 per-row scales of int8/fp8
        pools (None = full precision).

    Returns ``[B, C, H, D]`` in ``q.dtype``. CUDA tensors run kernel B14;
    CPU tensors run the plain chain.
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, block_tables, q_positions, context_lens,
            scale, k_scales, v_scales)
    return paged_read_attention(q, k_pages, v_pages, block_tables,
                                q_positions, context_lens, scale,
                                k_scales, v_scales)


def paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                           scale=1.0, k_scales=None, v_scales=None):
    """Single-query attention: ``q`` is ``[B, H, D]``; the decode case
    (one query at the last cached position) of
    :func:`paged_prefill_attention`. Returns ``[B, H, D]``."""
    return paged_prefill_attention(
        q[:, None], k_pages, v_pages, block_tables, None, context_lens,
        scale, k_scales, v_scales)[:, 0]
