"""Flat communication buffers (counterpart of
:mod:`apex_tpu.utils.pytree`'s ``ravel_list``, ``unravel_list`` and
``flatten_buckets``).

A list of tensors is flattened into one contiguous 1-D buffer for one
collective (DDP's bucket all-reduce) and split back. A buffer of mixed
dtypes is concatenated in the widest of them (``torch.promote_types``,
which promotes bf16 with fp16 to fp32 as ``jnp.concatenate`` does) and
each piece is cast back to its leaf's dtype.

Each leaf's slot starts on a multiple of ``ALIGN_BYTES`` (zeros pad the
gaps). The pieces handed back are views of the buffer that the optimizer
reads next, and torch's CUDA kernels vectorize their loads only on
aligned pointers: a view behind a leaf of odd size (BERT's 30,522-entry
decoder bias) would send every kernel that reads it down its scalar
path.
"""

from __future__ import annotations

import functools

import torch

ALIGN_BYTES = 256


def ravel_list(leaves):
    """A new contiguous 1-D buffer of ``leaves`` (in the widest of their
    dtypes, each slot aligned; never a view of a leaf, so a collective may
    reduce it in place) and the ``(shape, dtype, numel, slot)`` of each,
    for :func:`unravel_list`."""
    leaves = list(leaves)
    if not leaves:
        return torch.zeros(0), []
    dtype = functools.reduce(torch.promote_types, (x.dtype for x in leaves))
    unit = max(ALIGN_BYTES // dtype.itemsize, 1)
    zeros = torch.zeros(unit, dtype=dtype, device=leaves[0].device)
    pieces, meta = [], []
    for x in leaves:
        n = x.numel()
        pad = -n % unit
        pieces.append(x.reshape(-1))
        if pad:
            pieces.append(zeros[:pad])
        meta.append((x.shape, x.dtype, n, n + pad))
    return torch.cat(pieces), meta


def unravel_list(flat, meta):
    """Inverse of :func:`ravel_list`: views of ``flat`` where a leaf has
    the buffer's dtype, casts where it does not."""
    slots = flat.split([slot for *_, slot in meta])
    return [s[:numel].view(shape).to(dtype)
            for s, (shape, dtype, numel, _) in zip(slots, meta)]


def flatten_buckets(leaves, bucket_numel):
    """Greedy, order-keeping partition of ``leaves`` into buckets of at
    most ``bucket_numel`` elements (a leaf larger than that is a bucket
    of its own), each raveled: ``[(indices, flat, meta), ...]``."""
    buckets = []
    cur_idx, cur, cur_numel = [], [], 0
    for i, leaf in enumerate(leaves):
        if cur and cur_numel + leaf.numel() > bucket_numel:
            buckets.append((cur_idx, *ravel_list(cur)))
            cur_idx, cur, cur_numel = [], [], 0
        cur_idx.append(i)
        cur.append(leaf)
        cur_numel += leaf.numel()
    if cur:
        buckets.append((cur_idx, *ravel_list(cur)))
    return buckets
