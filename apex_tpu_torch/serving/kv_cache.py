"""Paged KV cache for serving (counterpart of
:mod:`apex_tpu.serving.kv_cache`, full-precision pools only).

The pools are ``[num_layers, num_blocks, block_size, num_heads,
head_dim]`` tensors on the serving device, allocated once and updated IN
PLACE (the JAX pools are functional: scatter in, new pytree out).
:class:`BlockAllocator` hands out block ids on the host; sequences map
positions to blocks through ``[B, max_blocks_per_seq]`` block tables
whose unallocated entries hold ``num_blocks`` on the device (one past
the pool): writes never land there and reads clip into the pool and are
masked by context length.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def default_kv_dtype(dtype=None) -> torch.dtype:
    """The KV storage dtype: an explicit ``dtype`` wins, else fp32 (the
    model dtype; the port has no amp policy yet)."""
    return torch.float32 if dtype is None else dtype


@dataclasses.dataclass
class KVCache:
    """The device block pools. ``k_scale``/``v_scale`` are the per-row
    fp32 scales of int8/fp8 pools (``[L, N, bs, H]``): the attention
    read dequantizes them, but this slice writes full precision only,
    so :meth:`create` leaves them ``None``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_heads(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @classmethod
    def create(cls, num_layers: int, num_blocks: int, block_size: int,
               num_heads: int, head_dim: int, dtype=None,
               device=None) -> "KVCache":
        shape = (num_layers, num_blocks, block_size, num_heads, head_dim)
        dt = default_kv_dtype(dtype)
        return cls(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


class CacheOutOfBlocks(RuntimeError):
    """The allocator cannot serve an allocation."""


class BlockAllocator:
    """Host-side block-id accounting: a free list and reference counts
    (the JAX allocator without tenants, shards, spill or the prefix
    index). ``alloc`` hands out ids at refcount 1, ascending ids first;
    ``free`` drops one reference and returns the id at zero; ``acquire``
    adds a reference to a live block."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        # pop() from the end serves ascending ids first
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise CacheOutOfBlocks(
                f"requested {n} blocks, {len(self._free)} free of "
                f"{self.num_blocks}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def free(self, ids: Sequence[int]) -> None:
        for b in ids:
            b = int(b)
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)

    def acquire(self, ids: Sequence[int]) -> None:
        for b in ids:
            b = int(b)
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"cannot acquire free block {b}")
            self._ref[b] += 1


def blocks_needed(num_tokens: int, block_size: int) -> int:
    return -(-int(num_tokens) // int(block_size))


def device_block_table(host_tables, num_blocks: int,
                       device=None) -> torch.Tensor:
    """Host tables use -1 for unallocated entries; the device convention
    is ``num_blocks`` (one past the pool)."""
    t = np.asarray(host_tables, np.int32)
    return torch.from_numpy(np.where(t >= 0, t, num_blocks).astype(
        np.int32)).to(device)


def write_coords(block_tables, positions, valid, num_blocks: int,
                 block_size: int):
    """The scatter coordinates ``(page, off, b, s)`` of every VALID
    token write, as 1-D index tensors. Invalid tokens (padding, frozen
    lanes, positions below ``write_start``) and tokens whose table entry
    is unallocated are left out, which is what the JAX scatter's
    ``mode="drop"`` does with them: nothing is ever written to block
    ``num_blocks``. Filtering is a host sync on CUDA, so the model
    computes the coordinates once per forward and every layer's write
    shares them."""
    M = block_tables.shape[1]
    entry = (positions // block_size).clamp(max=M - 1).long()
    page = torch.gather(block_tables.long(), 1, entry)
    keep = valid & (page < num_blocks)
    b, s = keep.nonzero(as_tuple=True)
    return page[b, s], (positions[b, s] % block_size).long(), b, s


def paged_write(pages, layer: int, coords, values) -> None:
    """Write per-token K or V rows (``values`` ``[B, S, H, D]``) into one
    layer of the pool ``[L, N, bs, H, D]``, in place, at ``coords``
    (:func:`write_coords`)."""
    page, off, b, s = coords
    pages[layer, page, off] = values[b, s].to(pages.dtype)


def write_kv(cache: KVCache, layer: int, coords, k_values,
             v_values) -> KVCache:
    """Write one layer's K and V rows (full-precision pools)."""
    paged_write(cache.k, layer, coords, k_values)
    paged_write(cache.v, layer, coords, v_values)
    return cache
