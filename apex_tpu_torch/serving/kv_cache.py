"""Paged KV cache for serving (counterpart of
:mod:`apex_tpu.serving.kv_cache`; the engine writes full-precision
pools only).

The pools are ``[num_layers, num_blocks, block_size, num_heads,
head_dim]`` tensors on the serving device, allocated once and updated IN
PLACE (the JAX pools are functional: scatter in, new pytree out).
:class:`BlockAllocator` hands out block ids on the host and keeps the
prefix-cache index (chain hashes of full blocks); sequences map
positions to blocks through ``[B, max_blocks_per_seq]`` block tables
whose unallocated entries hold ``num_blocks`` on the device (one past
the pool): writes never land there and reads clip into the pool and are
masked by context length.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
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
    """The allocator cannot serve an allocation even after evicting every
    refcount-0 cached block."""


def hash_block_tokens(prev_hash: Optional[str],
                      tokens: Sequence[int]) -> str:
    """Chain hash of one FULL block of token ids: SHA-256 over the
    previous block's chain hash (none for the first block) and the ids as
    int64 bytes, so equal hashes mean equal prefixes through this block.
    The strings are the JAX package's, byte for byte (routing keys on
    them across engines)."""
    h = hashlib.sha256()
    if prev_hash is not None:
        h.update(prev_hash.encode("ascii"))
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


class BlockAllocator:
    """Host-side block-id accounting: a free list, reference counts and
    the prefix-cache index (the JAX allocator without tenants, shards or
    the spill tier; the same ids in the same order for the same calls).

    A block id is **free** (on the free list; ``alloc`` hands it out at
    refcount 1, ascending ids first), **active** (refcount >= 1:
    ``acquire`` adds a reference, ``free`` drops one) or **cached**
    (refcount 0 but registered in the prefix index: its contents stay
    matchable; ``alloc`` evicts cached blocks least recently used when
    the free list is empty, ``match_prefix`` revives them)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        # pop() from the end serves ascending ids first
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._hash_to_block: Dict[str, int] = {}
        self._block_to_hash: Dict[int, str] = {}
        # refcount-0 registered blocks; insertion order is LRU order
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.num_evictions = 0

    # -- accounting ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Refcount-0 blocks kept for prefix reuse (evictable)."""
        return len(self._evictable)

    @property
    def num_used(self) -> int:
        """Blocks referenced by live sequences."""
        return self.num_blocks - len(self._free) - len(self._evictable)

    @property
    def utilization(self) -> float:
        return self.num_used / max(self.num_blocks, 1)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    # -- alloc / free / share ------------------------------------------------

    def _evict_one(self) -> int:
        """Unregister and return the least recently used cached block."""
        b, _ = self._evictable.popitem(last=False)
        del self._hash_to_block[self._block_to_hash.pop(b)]
        self.num_evictions += 1
        return b

    def alloc(self, n: int) -> List[int]:
        """``n`` blocks at refcount 1, evicting cached blocks (LRU first)
        when the free list alone cannot serve them."""
        if n > len(self._free) + len(self._evictable):
            raise CacheOutOfBlocks(
                f"requested {n} blocks, {len(self._free)} free + "
                f"{len(self._evictable)} evictable of {self.num_blocks}")
        out = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_one()
            self._ref[b] = 1
            out.append(b)
        return out

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id. A registered block reaching 0 stays
        cached (the most recently used end); an unregistered one returns
        to the free list. Raises on an unknown id or a double free."""
        for b in ids:
            b = int(b)
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._block_to_hash:
                    self._evictable[b] = None
                else:
                    self._free.append(b)

    def acquire(self, ids: Sequence[int]) -> None:
        """Add one reference per id (prefix sharing); revives cached
        blocks. A free block holds nothing to share: raises."""
        for b in ids:
            b = int(b)
            if self._ref.get(b, 0) > 0:
                self._ref[b] += 1
            elif b in self._evictable:
                del self._evictable[b]
                self._ref[b] = 1
            else:
                raise ValueError(
                    f"cannot acquire block {b}: neither active nor cached")

    # -- the prefix index ----------------------------------------------------

    def register_prefix(self, block_hash: str, block_id: int) -> bool:
        """Index a FULL block under its chain hash. The first
        registration wins (a duplicate stays unregistered and is freed
        when released). Returns whether ``block_id`` is the indexed
        block."""
        block_id = int(block_id)
        if block_hash in self._hash_to_block:
            return self._hash_to_block[block_hash] == block_id
        if block_id in self._block_to_hash:
            return False
        self._hash_to_block[block_hash] = block_id
        self._block_to_hash[block_id] = block_hash
        return True

    def indexed_block(self, block_hash: str) -> Optional[int]:
        """The block serving a chain hash, or None."""
        return self._hash_to_block.get(block_hash)

    def lookup_prefix(self, hashes: Sequence[str]) -> List[int]:
        """The longest indexed prefix of the chain, taking no references
        and leaving the LRU order alone (for capacity checks)."""
        out: List[int] = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def match_prefix(self, hashes: Sequence[str]) -> List[int]:
        """:meth:`lookup_prefix`, acquiring a reference on each block;
        the caller frees them."""
        out = self.lookup_prefix(hashes)
        self.acquire(out)
        return out

    def trim_to(self, blocks: Sequence[int], keep: int) -> List[int]:
        """Release the blocks of a sequence past its first ``keep`` and
        return the kept prefix: the rollback of a speculative span's
        reservation. A trimmed block must be private (refcount 1) and
        unregistered, or it holds context something else still reads:
        a violation raises before anything is released. The tail is
        freed deepest first."""
        blocks = [int(b) for b in blocks]
        keep = int(keep)
        if not 0 <= keep <= len(blocks):
            raise ValueError(
                f"keep must be in [0, {len(blocks)}], got {keep}")
        tail = blocks[keep:]
        for b in tail:
            if self._ref.get(b, 0) != 1:
                raise ValueError(
                    f"cannot trim block {b}: refcount "
                    f"{self._ref.get(b, 0)} != 1 (shared or not owned)")
            if b in self._block_to_hash:
                raise ValueError(
                    f"cannot trim block {b}: registered in the prefix "
                    "index (it is matchable cached context)")
        self.free(list(reversed(tail)))
        return blocks[:keep]

    def flush_evictable(self) -> int:
        """Evict every cached block to the free list; returns how many
        (each counts as an eviction)."""
        n = len(self._evictable)
        while self._evictable:
            self._free.append(self._evict_one())
        return n

    def reset(self) -> None:
        """Every block free, the index empty (``num_evictions`` kept)."""
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref.clear()
        self._hash_to_block.clear()
        self._block_to_hash.clear()
        self._evictable.clear()

    # -- audit ---------------------------------------------------------------

    def snapshot_state(self) -> Dict[str, object]:
        """JSON-serializable picture: refcounts, the prefix index, the
        LRU order of the cached blocks, the free list, evictions."""
        return {
            "refcounts": {str(b): int(c) for b, c in self._ref.items()},
            "prefix_index": dict(self._hash_to_block),
            "evictable": [int(b) for b in self._evictable],
            "free": [int(b) for b in self._free],
            "num_evictions": int(self.num_evictions),
        }

    def check_integrity(self, expected_refcounts: Optional[Dict[int, int]]
                        = None) -> None:
        """Raise ``ValueError`` on a broken invariant: every block in
        exactly one of free, active and cached; the hash and block maps a
        bijection; cached blocks registered; no registered block free;
        and, given the refcounts the caller's own bookkeeping implies,
        an exact match with the internal ones."""
        free, active = set(self._free), set(self._ref)
        cached = set(self._evictable)
        if len(free) != len(self._free):
            raise ValueError("free list contains duplicates")
        for name, ids in (("free", free), ("active", active),
                          ("cached", cached)):
            bad = [b for b in ids if not 0 <= b < self.num_blocks]
            if bad:
                raise ValueError(f"{name} ids out of range: {bad}")
        overlaps = (free & active) | (free & cached) | (active & cached)
        if overlaps:
            raise ValueError(f"blocks in multiple states: {sorted(overlaps)}")
        if len(free) + len(active) + len(cached) != self.num_blocks:
            raise ValueError(
                f"state partition covers "
                f"{len(free) + len(active) + len(cached)} of "
                f"{self.num_blocks} blocks")
        if any(c <= 0 for c in self._ref.values()):
            raise ValueError("active block with non-positive refcount")
        if {b: h for h, b in self._hash_to_block.items()} \
                != self._block_to_hash:
            raise ValueError("prefix index hash<->block maps disagree")
        unregistered = cached - set(self._block_to_hash)
        if unregistered:
            raise ValueError(f"cached blocks missing from the index: "
                             f"{sorted(unregistered)}")
        registered_free = free & set(self._block_to_hash)
        if registered_free:
            raise ValueError(
                f"free blocks still indexed: {sorted(registered_free)}")
        if expected_refcounts is not None:
            expected = {int(b): int(c) for b, c in expected_refcounts.items()
                        if int(c) > 0}
            if expected != self._ref:
                raise ValueError(
                    f"refcounts diverge from caller bookkeeping: expected "
                    f"{expected}, allocator holds {self._ref}")


def blocks_needed(num_tokens: int, block_size: int) -> int:
    return -(-int(num_tokens) // int(block_size))


def seq_block_hashes(tokens: Sequence[int], block_size: int) -> List[str]:
    """The chain hashes of a token sequence's FULL blocks."""
    hashes: List[str] = []
    prev = None
    for j in range(len(tokens) // block_size):
        prev = hash_block_tokens(
            prev, tokens[j * block_size: (j + 1) * block_size])
        hashes.append(prev)
    return hashes


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


def copy_block(cache: KVCache, src: int, dst: int) -> KVCache:
    """Copy block ``src`` onto ``dst`` in every layer, in place, scales
    with their payload: the device half of copy-on-write."""
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if pool is not None:
            pool[:, dst] = pool[:, src]
    return cache


def gather_blocks(cache: KVCache, perm) -> KVCache:
    """Permute the pool's blocks in place (``new[i] = old[perm[i]]``),
    scales with their payload."""
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                           device=cache.k.device)
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if pool is not None:
            pool.copy_(pool[:, perm])
    return cache


def defragment(cache: KVCache, allocator: BlockAllocator, host_tables):
    """Compact the live blocks (those in ``host_tables``) to the lowest
    ids, in place: the pool is permuted, the allocator's refcounts and
    index are rewritten in the new ids and its cached blocks dropped
    (counted as evictions; no table reaches them). Returns ``(cache,
    new_host_tables)``. A maintenance operation, never per step."""
    tables = np.array(host_tables, np.int32, copy=True)
    live = np.unique(tables[tables >= 0])
    live_set = {int(x) for x in live}
    missing = [b for b in allocator._ref if b not in live_set]
    if missing:
        raise ValueError(
            f"defragment: blocks {sorted(missing)} hold references but "
            "appear in no table — allocator and tables are inconsistent")
    mapping = {int(old): new for new, old in enumerate(live)}
    perm = np.arange(cache.num_blocks, dtype=np.int64)
    perm[: len(live)] = live
    perm[len(live):] = np.setdiff1d(np.arange(cache.num_blocks), live)
    for idx, old in np.ndenumerate(tables):
        if old >= 0:
            tables[idx] = mapping[int(old)]
    allocator.num_evictions += len(allocator._evictable)
    allocator._evictable.clear()
    allocator._ref = {mapping[b]: c for b, c in allocator._ref.items()}
    allocator._hash_to_block = {
        h: mapping[b] for h, b in allocator._hash_to_block.items()
        if b in mapping}
    allocator._block_to_hash = {
        b: h for h, b in allocator._hash_to_block.items()}
    allocator._free = list(range(cache.num_blocks - 1, len(live) - 1, -1))
    return gather_blocks(cache, perm), tables
