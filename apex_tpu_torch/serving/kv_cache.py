"""Paged KV cache for serving (counterpart of
:mod:`apex_tpu.serving.kv_cache`, without the fleet's shared prefix
tier).

The pools are ``[num_layers, num_blocks, block_size, num_heads,
head_dim]`` tensors on the serving device, allocated once and updated IN
PLACE (the JAX pools are functional: scatter in, new pytree out).
``KVCache.create(quantization="int8" | "fp8")`` stores int8 or
float8_e4m3fn payloads with one fp32 scale per written (token, head) row
(``k_scale``/``v_scale``, ``[L, N, bs, H]``), moved with their payload by
every block op; :func:`write_kv` quantizes on the way in (the rounding
rule is :mod:`apex_tpu_torch.ops.kv_quant`'s) and the attention read
dequantizes. :class:`BlockAllocator` hands out block ids on the host,
keeps the prefix-cache index (chain hashes of full blocks) and the
per-tenant ledger; sequences map positions to blocks through ``[B,
max_blocks_per_seq]`` block tables whose unallocated entries hold
``num_blocks`` on the device (one past the pool): writes never land
there and reads clip into the pool and are masked by context length.

On a serving mesh (:mod:`apex_tpu_torch.serving.mesh`) the pool is a
:class:`ShardedKVCache`: shard ``(b, m)`` owns its own contiguous
``[L, N / B, bs, H / M, D]`` allocation, blocks ``[b N / B, (b + 1) N /
B)`` and heads ``[m H / M, (m + 1) H / M)``. The allocator's shards
(``num_shards``) keep every sequence's blocks inside its lane's batch
shard, and the block operations act on every model shard of the block's
batch shard.

:class:`HostSpillStore` is the prefix cache's host-RAM tier: with one
attached (:meth:`BlockAllocator.attach_spill`), a cached block the
allocator evicts is first copied to host memory under its chain hash and
tenant, with a SHA-256 checksum re-checked at every read, and a later
prefix match re-admits it by upload instead of recompute.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.kv_quant import (  # noqa: F401 (re-exported)
    KV_QUANT_MODES,
    KV_QUANT_SEED as _KV_QUANT_SEED,
    fp8_kv_dtype,
    kv_quant_write,
    pool_quantization,
    quant_storage_dtype as _quant_storage_dtype,
    quantize_kv_rows,
    quantize_kv_rows_with,
)
from apex_tpu_torch.utils.integrity import payload_checksum

# the tenant every unlabelled caller is accounted to: single-tenant
# traffic runs entirely under it, and allocation order never reads a
# tenant, so the default tenant's ids are the tenant-blind allocator's
DEFAULT_TENANT = "default"


def default_kv_dtype(dtype=None) -> torch.dtype:
    """The KV storage dtype: an explicit ``dtype`` wins, else fp32 (the
    model dtype; the port has no amp policy yet)."""
    return torch.float32 if dtype is None else dtype


def kv_block_bytes(num_layers: int, block_size: int, num_heads: int,
                   head_dim: int, dtype=None, quantization=None) -> int:
    """Device bytes one block costs across every layer: K + V payload,
    plus the per-row fp32 scales when quantized (the JAX formula). The
    tenant ledger charges a quantized block this over the full-precision
    block's bytes."""
    if quantization is None:
        item = torch.empty((), dtype=default_kv_dtype(dtype)).element_size()
        return 2 * num_layers * block_size * num_heads * head_dim * item
    item = torch.empty((), dtype=_quant_storage_dtype(
        quantization)).element_size()
    payload = 2 * num_layers * block_size * num_heads * head_dim * item
    scales = 2 * num_layers * block_size * num_heads * 4
    return payload + scales


@dataclasses.dataclass
class KVCache:
    """The device block pools. ``k_scale``/``v_scale`` are the per-row
    fp32 scales of int8/fp8 pools (``[L, N, bs, H]``, None at full
    precision): :func:`write_kv` writes them with their payload and the
    attention read dequantizes them."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantization(self) -> Optional[str]:
        """The storage mode (from the payload dtype): None, "int8" or
        "fp8"."""
        if self.k_scale is None:
            return None
        return pool_quantization(self.k.dtype)

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools, scales included."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)

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
               quantization: Optional[str] = None,
               device=None) -> "KVCache":
        """Zeroed pools; ``quantization`` (one of ``KV_QUANT_MODES``)
        stores int8/fp8 payloads with fp32 ``[L, N, bs, H]`` scales
        (``dtype`` is then unused)."""
        shape = (num_layers, num_blocks, block_size, num_heads, head_dim)
        if quantization is None:
            dt = default_kv_dtype(dtype)
            return cls(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device))
        dt = _quant_storage_dtype(quantization)
        return cls(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device),
                   k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device),
                   v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device))


@dataclasses.dataclass
class ShardedKVCache:
    """The pools of a ``(B, M)`` serving mesh: ``shards[b][m]`` is a
    :class:`KVCache` ``[L, N / B, bs, H / M, D]`` on the device of mesh
    coordinate ``(b, m)``, its own contiguous allocation (a head slice of
    one pool is not contiguous, and kernel B14 refuses a strided or
    misaligned pool). Global block ``g`` lives on batch shard ``g // (N /
    B)`` at local id ``g % (N / B)``, its heads ``[m H / M, (m + 1) H /
    M)`` on model shard ``m``. :meth:`block_payload` gathers a block's
    head shards and :meth:`upload` splits them, so payloads are full-head
    and carry no layout."""

    shards: List[List[KVCache]]

    @classmethod
    def create(cls, devices, num_layers: int, num_blocks: int,
               block_size: int, num_heads: int, head_dim: int, dtype=None,
               quantization: Optional[str] = None) -> "ShardedKVCache":
        """Zeroed pools, one a mesh coordinate: ``devices`` is the mesh's
        ``B x M`` grid of devices."""
        B, M = len(devices), len(devices[0])
        return cls([[KVCache.create(num_layers, num_blocks // B, block_size,
                                    num_heads // M, head_dim, dtype=dtype,
                                    quantization=quantization,
                                    device=devices[b][m])
                     for m in range(M)] for b in range(B)])

    @property
    def batch_shards(self) -> int:
        return len(self.shards)

    @property
    def model_shards(self) -> int:
        return len(self.shards[0])

    @property
    def blocks_per_shard(self) -> int:
        return self.shards[0][0].num_blocks

    @property
    def num_blocks(self) -> int:
        return self.batch_shards * self.blocks_per_shard

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for row in self.shards for c in row)

    def locate(self, block_id: int) -> Tuple[int, int]:
        """``(batch shard, local id)`` of a global block id."""
        return divmod(int(block_id), self.blocks_per_shard)

    def block_payload(self, block_id: int) -> Dict[str, torch.Tensor]:
        """One block's contents as CPU tensors in the pool's dtype, its
        model shards' heads gathered in order: ``{"k", "v"}`` ``[L, bs, H,
        D]`` (and ``"k_scale"``/``"v_scale"`` ``[L, bs, H]`` on a
        quantized pool). Each piece is a blocking copy, fresh in host
        memory when it returns."""
        b, local = self.locate(block_id)
        out = {}
        for key in ("k", "v", "k_scale", "v_scale"):
            pools = [getattr(c, key) for c in self.shards[b]]
            if pools[0] is None:
                continue
            parts = [p[:, local].to("cpu", copy=True) for p in pools]
            out[key] = parts[0] if len(parts) == 1 else torch.cat(parts,
                                                                  dim=2)
        return out

    def upload(self, block_ids: Sequence[int], payloads) -> None:
        """Write full-head payloads (:meth:`block_payload`'s layout) into
        global blocks ``block_ids``, in place: per batch shard and model
        shard one ``index_copy_`` a pool tensor of the payloads' head
        slice, stacked on the block axis. The copy is of raw bytes (a
        uint8 view), so every dtype lands as it was read, fp8
        included."""
        groups: Dict[int, List[Tuple[int, Dict[str, torch.Tensor]]]] = {}
        for g, p in zip(block_ids, payloads):
            b, local = self.locate(g)
            groups.setdefault(b, []).append((local, p))
        Hl = self.shards[0][0].num_heads
        M = self.model_shards
        for b, items in groups.items():
            for m, cache in enumerate(self.shards[b]):
                ids = torch.as_tensor([i for i, _ in items], dtype=torch.long,
                                      device=cache.k.device)
                for key in ("k", "v", "k_scale", "v_scale"):
                    pool = getattr(cache, key)
                    if pool is None:
                        continue
                    if M == 1:
                        src = torch.stack([p[key] for _, p in items], dim=1)
                    else:
                        src = torch.stack([p[key][:, :, m * Hl:(m + 1) * Hl]
                                           for _, p in items], dim=1)
                    pool.view(torch.uint8).index_copy_(
                        1, ids, src.to(pool.device).view(torch.uint8))

    def zero_(self) -> None:
        for row in self.shards:
            for c in row:
                for t in (c.k, c.v, c.k_scale, c.v_scale):
                    if t is not None:
                        t.zero_()


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
    """Host-side block-id accounting: a free list, reference counts, the
    prefix-cache index, the per-tenant ledger, the batch-axis shards and,
    when attached, the host spill tier (the JAX allocator: the same ids
    in the same order for the same calls).

    A block id is **free** (on the free list; ``alloc`` hands it out at
    refcount 1, ascending ids first), **active** (refcount >= 1:
    ``acquire`` adds a reference, ``free`` drops one) or **cached**
    (refcount 0 but registered in the prefix index: its contents stay
    matchable; ``alloc`` evicts cached blocks least recently used when
    the free list is empty, ``match_prefix`` revives them).

    Every reference is held by a tenant: a block shared across tenants
    charges each ``block_weight * tenant_refs / refs``
    (:meth:`tenant_charge`; ``block_weight`` is 1.0, or a quantized
    block's bytes over the full-precision block's), and a cached block
    belongs to the tenant that registered it, so its eviction or flush
    is counted against that tenant. The ledger is bookkeeping: no
    allocation or eviction reads it.

    ``num_shards`` (the mesh's batch axis) splits the ids into equal
    contiguous ranges: shard ``s`` owns ``[s * blocks_per_shard, (s + 1)
    * blocks_per_shard)``, and ``shard=`` on :meth:`alloc`,
    :meth:`lookup_prefix` and :meth:`match_prefix` keeps a sequence's
    blocks on its lane's shard. One shard makes every ``shard`` argument
    a no-op."""

    def __init__(self, num_blocks: int, block_weight: float = 1.0,
                 num_shards: int = 1):
        self.num_blocks = int(num_blocks)
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {num_shards}")
        if self.num_blocks % self.num_shards:
            raise ValueError(
                f"num_shards ({self.num_shards}) must divide num_blocks "
                f"({self.num_blocks}): the pool splits into equal "
                "contiguous shard ranges")
        self.blocks_per_shard = self.num_blocks // self.num_shards
        if not block_weight > 0:
            raise ValueError(
                f"block_weight must be > 0, got {block_weight}")
        self.block_weight = float(block_weight)
        # pop() from the end serves ascending ids first
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._hash_to_block: Dict[str, int] = {}
        self._block_to_hash: Dict[int, str] = {}
        # refcount-0 registered blocks; insertion order is LRU order
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.num_evictions = 0
        # the tenant ledger: each block's references split by holder, the
        # registering tenant of each indexed block, eviction and flush
        # counts by that tenant, and the running fractional charge
        # (_charge_block keeps it; check_integrity rebases it exactly)
        self._tenant_refs: Dict[int, Dict[str, int]] = {}
        self._cached_owner: Dict[int, str] = {}
        self._evicted_by_tenant: Dict[str, int] = {}
        self._flushed_by_tenant: Dict[str, int] = {}
        self._tenant_charge_acc: Dict[str, float] = {}
        # the host spill tier (attach_spill): evicted and flushed cached
        # blocks are copied there before reuse
        self.spill_store: Optional["HostSpillStore"] = None
        self._spill_fetch = None

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

    def shard_of(self, block_id: int) -> int:
        """The batch shard owning a block id (0 unsharded)."""
        return int(block_id) // self.blocks_per_shard

    def free_in_shard(self, shard: int) -> int:
        """Free blocks inside one shard's id range."""
        return sum(1 for b in self._free
                   if b // self.blocks_per_shard == shard)

    def cached_in_shard(self, shard: int) -> int:
        """Cached (evictable) blocks inside one shard's id range."""
        return sum(1 for b in self._evictable
                   if b // self.blocks_per_shard == shard)

    @property
    def utilization(self) -> float:
        return self.num_used / max(self.num_blocks, 1)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def tenant_refcount(self, block_id: int, tenant: str) -> int:
        """How many of a block's references ``tenant`` holds."""
        return self._tenant_refs.get(int(block_id), {}).get(tenant, 0)

    def _charge_block(self, b: int, sign: int) -> None:
        """Add (+1) or remove (-1) block ``b``'s current per-tenant shares
        to the running charge, around each change of its holders."""
        total = self._ref.get(b, 0)
        if not total:
            return
        w = self.block_weight
        for t, n in self._tenant_refs[b].items():
            self._tenant_charge_acc[t] = \
                self._tenant_charge_acc.get(t, 0.0) + sign * w * n / total

    def tenant_charge(self, tenant: str) -> float:
        """The tenant's fractional resident-block charge, in
        ``block_weight`` units: what ``TenantQuota.max_resident_blocks``
        is held against."""
        return max(0.0, self._tenant_charge_acc.get(tenant, 0.0))

    def tenant_stats(self) -> Dict[str, Dict[str, object]]:
        """Per tenant: resident charge, cached blocks it registered, and
        its evicted and flushed blocks."""
        tenants = set(self._evicted_by_tenant) | set(self._flushed_by_tenant)
        for refs in self._tenant_refs.values():
            tenants.update(refs)
        cached_by: Dict[str, int] = {}
        for b in self._evictable:
            owner = self._cached_owner.get(b)
            if owner is not None:
                tenants.add(owner)
                cached_by[owner] = cached_by.get(owner, 0) + 1
        return {t: {
            "resident_block_charge": round(self.tenant_charge(t), 6),
            "cached_blocks": cached_by.get(t, 0),
            "evicted_blocks": self._evicted_by_tenant.get(t, 0),
            "flushed_blocks": self._flushed_by_tenant.get(t, 0),
        } for t in sorted(tenants)}

    # -- alloc / free / share ------------------------------------------------

    # -- the host spill tier ---------------------------------------------------

    def attach_spill(self, store: "HostSpillStore", fetch) -> None:
        """Wire the host spill tier in: every block :meth:`_evict_one`
        drops (LRU pressure or a ladder flush; never :meth:`reset`) is
        first copied to ``store`` under its chain hash and owning tenant,
        its contents read by ``fetch(block_id) -> payload`` (the engine
        owns the pool, so it owns the fetch; a fetch returning None skips
        the spill). :meth:`register_prefix` discards the stored copy of a
        hash the moment a device block is indexed under it, which keeps
        the store disjoint from the device index."""
        self.spill_store = store
        self._spill_fetch = fetch

    def _evict_one(self, flushed: bool = False,
                   shard: Optional[int] = None) -> int:
        """Unregister and return the least recently used cached block,
        counting it against its registering tenant (``flushed``: the
        degradation ladder's flush counter). With a spill tier attached
        the block's contents are copied to the host store first, so the
        eviction becomes a future upload instead of a recompute.
        ``shard`` restricts the LRU walk to one shard's ids (callers
        check :meth:`cached_in_shard` first)."""
        if shard is None:
            b, _ = self._evictable.popitem(last=False)
        else:
            b = next(x for x in self._evictable
                     if x // self.blocks_per_shard == shard)
            del self._evictable[b]
        h = self._block_to_hash.pop(b)
        del self._hash_to_block[h]
        owner = self._cached_owner.pop(b, None)
        if self.spill_store is not None and self._spill_fetch is not None:
            payload = self._spill_fetch(b)
            if payload is not None:
                self.spill_store.put(h, payload,
                                     tenant=owner or DEFAULT_TENANT)
        if owner is not None:
            counter = (self._flushed_by_tenant if flushed
                       else self._evicted_by_tenant)
            counter[owner] = counter.get(owner, 0) + 1
        self.num_evictions += 1
        return b

    def alloc(self, n: int, tenant: str = DEFAULT_TENANT,
              shard: Optional[int] = None) -> List[int]:
        """``n`` blocks at refcount 1, held by ``tenant``, evicting cached
        blocks (LRU first) when the free list alone cannot serve them.
        ``shard`` takes them from that shard's range only (the most
        recently freed of the shard first, as the unsharded pop), and
        raises ``CacheOutOfBlocks`` when that shard cannot serve them,
        whatever the other shards hold."""
        if shard is None or self.num_shards == 1:
            if n > len(self._free) + len(self._evictable):
                raise CacheOutOfBlocks(
                    f"requested {n} blocks, {len(self._free)} free + "
                    f"{len(self._evictable)} evictable of "
                    f"{self.num_blocks}")
            out = []
            for _ in range(n):
                b = self._free.pop() if self._free else self._evict_one()
                self._ref[b] = 1
                self._tenant_refs[b] = {tenant: 1}
                self._charge_block(b, +1)
                out.append(b)
            return out
        shard = int(shard)
        if not 0 <= shard < self.num_shards:
            raise ValueError(
                f"shard {shard} out of range [0, {self.num_shards})")
        free_s = self.free_in_shard(shard)
        if n > free_s + self.cached_in_shard(shard):
            raise CacheOutOfBlocks(
                f"requested {n} blocks on shard {shard}, {free_s} free "
                f"+ {self.cached_in_shard(shard)} evictable of "
                f"{self.blocks_per_shard} shard blocks")
        out = []
        for _ in range(n):
            b = None
            for i in range(len(self._free) - 1, -1, -1):
                if self._free[i] // self.blocks_per_shard == shard:
                    b = self._free.pop(i)
                    break
            if b is None:
                b = self._evict_one(shard=shard)
            self._ref[b] = 1
            self._tenant_refs[b] = {tenant: 1}
            self._charge_block(b, +1)
            out.append(b)
        return out

    def free(self, ids: Sequence[int], tenant: str = DEFAULT_TENANT) -> None:
        """Drop one of ``tenant``'s references per id. A registered block
        reaching 0 stays cached (the most recently used end); an
        unregistered one returns to the free list. Raises on an unknown
        id, a double free, or a tenant dropping a reference it does not
        hold."""
        for b in ids:
            b = int(b)
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"double free of block {b}")
            holders = self._tenant_refs[b]
            if holders.get(tenant, 0) <= 0:
                raise ValueError(
                    f"tenant {tenant!r} holds no reference on block {b} "
                    f"(holders: {holders})")
            self._charge_block(b, -1)
            holders[tenant] -= 1
            if holders[tenant] == 0:
                del holders[tenant]
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                del self._tenant_refs[b]
                if b in self._block_to_hash:
                    self._evictable[b] = None
                else:
                    self._free.append(b)
            else:
                self._charge_block(b, +1)

    def acquire(self, ids: Sequence[int],
                tenant: str = DEFAULT_TENANT) -> None:
        """Add one reference per id for ``tenant`` (prefix sharing);
        revives cached blocks. A free block holds nothing to share:
        raises."""
        for b in ids:
            b = int(b)
            if self._ref.get(b, 0) > 0:
                self._charge_block(b, -1)
                self._ref[b] += 1
                holders = self._tenant_refs[b]
                holders[tenant] = holders.get(tenant, 0) + 1
                self._charge_block(b, +1)
            elif b in self._evictable:
                del self._evictable[b]
                self._ref[b] = 1
                self._tenant_refs[b] = {tenant: 1}
                self._charge_block(b, +1)
            else:
                raise ValueError(
                    f"cannot acquire block {b}: neither active nor cached")

    # -- the prefix index ----------------------------------------------------

    def register_prefix(self, block_hash: str, block_id: int,
                        tenant: str = DEFAULT_TENANT) -> bool:
        """Index a FULL block under its chain hash. The first
        registration wins (a duplicate stays unregistered and is freed
        when released) and records ``tenant`` as the block's cached
        owner. Returns whether ``block_id`` is the indexed block."""
        block_id = int(block_id)
        if block_hash in self._hash_to_block:
            return self._hash_to_block[block_hash] == block_id
        if block_id in self._block_to_hash:
            return False
        self._hash_to_block[block_hash] = block_id
        self._block_to_hash[block_id] = block_hash
        self._cached_owner[block_id] = tenant
        if self.spill_store is not None:
            # a device block serves this hash now: the host copy is
            # redundant (and would break the store's disjointness)
            self.spill_store.discard(block_hash)
        return True

    def indexed_block(self, block_hash: str) -> Optional[int]:
        """The block serving a chain hash, or None."""
        return self._hash_to_block.get(block_hash)

    def lookup_prefix(self, hashes: Sequence[str],
                      shard: Optional[int] = None) -> List[int]:
        """The longest indexed prefix of the chain, taking no references
        and leaving the LRU order alone (for capacity checks). ``shard``
        stops the walk at the first block outside that shard's range: a
        lane shares only blocks its own shard holds."""
        out: List[int] = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            if shard is not None and b // self.blocks_per_shard != shard:
                break
            out.append(b)
        return out

    def match_prefix(self, hashes: Sequence[str],
                     tenant: str = DEFAULT_TENANT,
                     shard: Optional[int] = None) -> List[int]:
        """:meth:`lookup_prefix`, acquiring a reference on each block for
        ``tenant``; the caller frees them under the same tenant."""
        out = self.lookup_prefix(hashes, shard=shard)
        self.acquire(out, tenant=tenant)
        return out

    def trim_to(self, blocks: Sequence[int], keep: int,
                tenant: str = DEFAULT_TENANT) -> List[int]:
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
        self.free(list(reversed(tail)), tenant=tenant)
        return blocks[:keep]

    def flush_evictable(self) -> int:
        """Evict every cached block to the free list (the degradation
        ladder's rung 2); returns how many. Each counts as an eviction
        and against its registering tenant's flush count."""
        n = len(self._evictable)
        while self._evictable:
            self._free.append(self._evict_one(flushed=True))
        return n

    def reset(self) -> None:
        """Every block free, the index and the references empty
        (``num_evictions`` and the eviction/flush counts kept). Nothing
        is spilled: reset follows a failed drain, and a pool that may be
        poisoned is never copied to the host tier."""
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref.clear()
        self._hash_to_block.clear()
        self._block_to_hash.clear()
        self._evictable.clear()
        self._tenant_refs.clear()
        self._cached_owner.clear()
        self._tenant_charge_acc.clear()

    # -- audit ---------------------------------------------------------------

    def snapshot_state(self) -> Dict[str, object]:
        """JSON-serializable picture: refcounts, the prefix index, the
        LRU order of the cached blocks, the free list, evictions and the
        tenant ledger."""
        return {
            "refcounts": {str(b): int(c) for b, c in self._ref.items()},
            "prefix_index": dict(self._hash_to_block),
            "evictable": [int(b) for b in self._evictable],
            "free": [int(b) for b in self._free],
            "num_evictions": int(self.num_evictions),
            "tenant_refs": {str(b): dict(refs)
                            for b, refs in self._tenant_refs.items()},
            "cached_owners": {str(b): t
                              for b, t in self._cached_owner.items()},
            "evicted_by_tenant": dict(self._evicted_by_tenant),
            "flushed_by_tenant": dict(self._flushed_by_tenant),
        }

    def check_integrity(self, expected_refcounts: Optional[Dict[int, int]]
                        = None,
                        expected_tenant_refs: Optional[
                            Dict[int, Dict[str, int]]] = None,
                        expected_shards: Optional[Dict[int, int]] = None
                        ) -> None:
        """Raise ``ValueError`` on a broken invariant: every block in
        exactly one of free, active and cached; the hash and block maps a
        bijection; cached blocks registered; no registered block free;
        the tenant split of each block summing to its refcount, and the
        running charges equal to the exact sums (then rebased to them);
        the spill store disjoint from the index and within its bound;
        given the refcounts (and their tenant split) that the caller's
        own bookkeeping implies, an exact match; and given the shard each
        referenced block must live on (its lanes' batch shard), shard
        residency."""
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
        if set(self._tenant_refs) != active:
            raise ValueError(
                f"tenant-ref map keys {sorted(self._tenant_refs)} != "
                f"active blocks {sorted(active)}")
        for b, refs in self._tenant_refs.items():
            if any(c <= 0 for c in refs.values()):
                raise ValueError(
                    f"block {b}: non-positive tenant refcount {refs}")
            if sum(refs.values()) != self._ref[b]:
                raise ValueError(
                    f"block {b}: tenant refs {refs} sum to "
                    f"{sum(refs.values())}, refcount is {self._ref[b]}")
        stray_owner = set(self._cached_owner) - set(self._block_to_hash)
        if stray_owner:
            raise ValueError(f"cached-owner entries for unregistered "
                             f"blocks: {sorted(stray_owner)}")
        # the spill tier: disjoint from the device index (re-admission
        # pops, registration discards) and within its byte bound
        if self.spill_store is not None:
            overlap = (set(self.spill_store.hashes())
                       & set(self._hash_to_block))
            if overlap:
                raise ValueError(
                    f"{len(overlap)} hash(es) both device-indexed and "
                    f"spilled (e.g. {sorted(overlap)[:2]})")
            if self.spill_store.total_bytes > self.spill_store.max_bytes:
                raise ValueError(
                    f"spill store holds {self.spill_store.total_bytes} "
                    f"bytes, over its {self.spill_store.max_bytes} bound")
        exact: Dict[str, float] = {}
        for b, refs in self._tenant_refs.items():
            for t, n in refs.items():
                exact[t] = exact.get(t, 0.0) \
                    + self.block_weight * n / self._ref[b]
        for t in set(exact) | set(self._tenant_charge_acc):
            if abs(exact.get(t, 0.0)
                   - self._tenant_charge_acc.get(t, 0.0)) > 1e-6:
                raise ValueError(
                    f"tenant {t!r}: incremental charge "
                    f"{self._tenant_charge_acc.get(t, 0.0)} diverged "
                    f"from exact {exact.get(t, 0.0)}")
        self._tenant_charge_acc = exact
        if expected_tenant_refs is not None:
            expect = {int(b): {t: int(c) for t, c in refs.items() if c > 0}
                      for b, refs in expected_tenant_refs.items()}
            expect = {b: refs for b, refs in expect.items() if refs}
            if expect != self._tenant_refs:
                raise ValueError(
                    f"tenant refs diverge from caller bookkeeping: "
                    f"expected {expect}, allocator holds "
                    f"{self._tenant_refs}")
        if expected_shards is not None:
            foreign = {int(b): (int(sh), self.shard_of(b))
                       for b, sh in expected_shards.items()
                       if self.shard_of(b) != int(sh)}
            if foreign:
                raise ValueError(
                    f"blocks off their lanes' shards (block: (lane shard, "
                    f"block shard)) {foreign}: batch-axis shard residency "
                    "violated")
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


def payload_nbytes(payload: Dict[str, object]) -> int:
    """The bytes of a payload's arrays (torch tensors or numpy arrays)."""
    return sum(int(a.nbytes) for a in payload.values()
               if isinstance(a, (torch.Tensor, np.ndarray)))


class HostSpillStore:
    """The host-RAM spill tier of the prefix cache: a bounded LRU of
    evicted prefix blocks keyed by the chain hash the device index uses
    (the JAX store's semantics and counters). Chain hashes are
    comparable across engines, so a spilled block is re-admittable by any
    engine of the same model and config.

    An entry is one block's contents as CPU tensors in the pool's storage
    dtype: ``{"k": [L, bs, H, D], "v": [L, bs, H, D]}``, plus
    ``"k_scale"``/``"v_scale"`` (``[L, bs, H]`` fp32) on a quantized pool,
    so a re-admitted block has the bytes it was spilled with. Torch
    tensors hold bf16 and fp8 where numpy cannot. ``max_bytes`` bounds the
    payload total: a put evicts least recently used entries past it, and
    an entry larger than the whole bound is refused (counted as an
    eviction too).

    The store is an optimization, never identity: a miss means recompute,
    and a hit is token-identical to recompute. With ``verify`` every entry
    keeps a SHA-256 checksum taken at :meth:`put` and re-checked at every
    read (:meth:`pop`, :meth:`export_entry`) and by :meth:`scrub`; a
    mismatch discards the entry, counts it (``corrupt_discards``),
    reports it through ``on_corrupt(site, block_hash)`` and reads as a
    miss. ``corrupt_hook(site, payload) -> payload`` is the fault seam
    (the engine's ``FaultPlan`` at ``"spill_put"`` and ``"spill_get"``)."""

    def __init__(self, max_bytes: int, verify: bool = True,
                 corrupt_hook=None, on_corrupt=None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.verify = bool(verify)
        self._corrupt_hook = corrupt_hook
        self._on_corrupt = on_corrupt
        # hash -> {"payload", "tenant", "bytes", "checksum"}; insertion
        # order is LRU order (a put re-inserts)
        self._entries: "OrderedDict[str, Dict[str, object]]" = \
            OrderedDict()
        self.total_bytes = 0
        self.puts = 0              # lifetime blocks spilled in
        self.evictions = 0         # entries dropped by the byte bound
        self.refused = 0           # oversize entries never admitted
        self.corrupt_discards = 0  # entries dropped on a checksum mismatch
        self._scrub_cursor = 0     # round-robin position of scrub()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, block_hash: str) -> bool:
        return block_hash in self._entries

    def hashes(self):
        return self._entries.keys()

    def entry_tenants(self) -> Dict[str, str]:
        """Chain hash -> owning tenant of every resident entry."""
        return {h: str(rec["tenant"]) for h, rec in self._entries.items()}

    def _drop(self, block_hash: str) -> None:
        rec = self._entries.pop(block_hash)
        self.total_bytes -= rec["bytes"]

    def put(self, block_hash: str, payload: Dict[str, torch.Tensor],
            tenant: str = DEFAULT_TENANT) -> bool:
        """Insert (or refresh) a block at the most recently used end,
        evicting least recently used entries past the byte bound. Returns
        whether the entry is resident after the call."""
        nbytes = payload_nbytes(payload)
        if block_hash in self._entries:
            self._drop(block_hash)
        self.puts += 1
        if nbytes > self.max_bytes:
            self.evictions += 1
            self.refused += 1
            return False
        # the checksum of the true bytes first, then the fault seam: a
        # flip in host memory happens after the checksum was taken
        checksum = payload_checksum(payload) if self.verify else None
        if self._corrupt_hook is not None:
            payload = self._corrupt_hook("spill_put", payload)
        self._entries[block_hash] = {
            "payload": payload, "tenant": tenant, "bytes": nbytes,
            "checksum": checksum}
        self.total_bytes += nbytes
        while self.total_bytes > self.max_bytes:
            self._drop(next(iter(self._entries)))
            self.evictions += 1
        return block_hash in self._entries

    def _read_ok(self, block_hash: str, payload, checksum) -> bool:
        """The read-side check against the put-time checksum; a mismatch
        counts a corrupt discard and reports it (the caller turns it into
        a miss)."""
        if not self.verify or checksum is None:
            return True
        if payload_checksum(payload) == checksum:
            return True
        self.corrupt_discards += 1
        if self._on_corrupt is not None:
            self._on_corrupt("spill_get", block_hash)
        return False

    def pop(self, block_hash: str) -> Optional[Dict[str, torch.Tensor]]:
        """Remove and return a block's payload: the re-admission read.
        None on a miss or a checksum mismatch (the corrupt entry is
        discarded and counted). Popping keeps the store disjoint from the
        device index the caller is about to register the block in."""
        rec = self._entries.get(block_hash)
        if rec is None:
            return None
        self._drop(block_hash)
        payload = rec["payload"]
        if self._corrupt_hook is not None:
            payload = self._corrupt_hook("spill_get", payload)
        if not self._read_ok(block_hash, payload, rec.get("checksum")):
            return None
        return payload

    def discard(self, block_hash: str) -> None:
        if block_hash in self._entries:
            self._drop(block_hash)

    def export_entry(self, block_hash: str
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """A copied payload for transport to another store (None on a
        miss): a peek that leaves the entry and its recency as they were.
        A checksum mismatch discards the entry and returns None."""
        rec = self._entries.get(block_hash)
        if rec is None:
            return None
        payload = {k: (v.clone() if isinstance(v, torch.Tensor)
                       else np.array(v, copy=True))
                   for k, v in rec["payload"].items()}
        if self._corrupt_hook is not None:
            payload = self._corrupt_hook("spill_get", payload)
        if not self._read_ok(block_hash, payload, rec.get("checksum")):
            self._drop(block_hash)
            return None
        return payload

    def import_entry(self, block_hash: str,
                     payload: Dict[str, torch.Tensor],
                     tenant: str = DEFAULT_TENANT) -> bool:
        """Insert a payload exported by another store: checked for its
        K/V keys, then :meth:`put`. Returns whether it is resident."""
        missing = [k for k in ("k", "v") if k not in payload]
        if missing:
            raise ValueError(
                f"imported payload for {block_hash!r} is missing "
                f"{missing} (expected the block's K/V arrays)")
        return self.put(block_hash, payload, tenant=tenant)

    def scrub(self, n: int) -> Tuple[int, int]:
        """Re-verify up to ``n`` resident entries against their put-time
        checksums, round robin from where the last scrub stopped, so rot
        in a cold entry is found before an admission needs it. A corrupt
        entry is discarded and counted as at a read. Returns
        ``(verified, corrupt)``; (0, 0) without verification or
        entries."""
        if not self.verify or n < 1 or not self._entries:
            return (0, 0)
        hashes = list(self._entries.keys())
        start = self._scrub_cursor % len(hashes)
        scanned = min(int(n), len(hashes))
        verified = corrupt = 0
        for j in range(scanned):
            h = hashes[(start + j) % len(hashes)]
            rec = self._entries.get(h)
            if rec is None or rec.get("checksum") is None:
                continue
            verified += 1
            if payload_checksum(rec["payload"]) != rec["checksum"]:
                self._drop(h)
                self.corrupt_discards += 1
                corrupt += 1
                if self._on_corrupt is not None:
                    self._on_corrupt("scrub", h)
        self._scrub_cursor = start + scanned
        return (verified, corrupt)

    def stats(self) -> Dict[str, int]:
        return {
            "blocks": len(self._entries),
            "bytes": int(self.total_bytes),
            "puts": int(self.puts),
            "evictions": int(self.evictions),
            "refused": int(self.refused),
            "corrupt_discards": int(self.corrupt_discards),
        }


class SharedPrefixStore(HostSpillStore):
    """The fleet's shared prefix tier: one byte-bounded, content-addressed
    store the router owns, fed by the replicas' spill evictions and by
    prefill handoffs, and probed at placement, so a prefix prefilled on
    any replica is warm on every one (the JAX ``SharedPrefixStore``'s
    semantics and counters). Entries keep :class:`HostSpillStore`'s
    discipline: CPU tensors in the pool's dtype with a put-time checksum
    re-checked at every read and by :meth:`scrub`, least recently used out
    past ``max_bytes``. On top of it:

    - refcounted dedupe: a publish of a resident hash adds a reference
      and a tenant share instead of bytes (``dedupe_hits``); an eviction
      or a corrupt discard drops the entry with all its references;
    - fractional attribution: :meth:`tenant_bytes` splits an entry's
      bytes across its publishing tenants by share;
    - :meth:`check_integrity` audits refcounts, shares and bytes."""

    def __init__(self, max_bytes: int, verify: bool = True,
                 corrupt_hook=None, on_corrupt=None):
        super().__init__(max_bytes, verify=verify,
                         corrupt_hook=corrupt_hook, on_corrupt=on_corrupt)
        # per resident hash: its publisher refcount and that count split
        # by tenant (the shares sum to it)
        self._refs: Dict[str, int] = {}
        self._owners: Dict[str, Dict[str, int]] = {}
        self.dedupe_hits = 0

    def _drop(self, block_hash: str) -> None:
        super()._drop(block_hash)
        self._refs.pop(block_hash, None)
        self._owners.pop(block_hash, None)

    def publish(self, block_hash: str,
                payload: Optional[Dict[str, torch.Tensor]] = None,
                tenant: str = DEFAULT_TENANT) -> bool:
        """Insert by content with refcounted dedupe. A resident hash gains
        a reference and a share for ``tenant`` (no payload needed: None is
        "I hold these bytes too") and moves to the most recently used end;
        a new hash needs its payload and takes :meth:`put`'s path. Returns
        whether the entry is resident after the call."""
        if block_hash in self._entries:
            self.dedupe_hits += 1
            self._refs[block_hash] += 1
            shares = self._owners[block_hash]
            shares[tenant] = shares.get(tenant, 0) + 1
            self._entries.move_to_end(block_hash)
            return True
        if payload is None:
            return False
        if self.put(block_hash, payload, tenant=tenant):
            self._refs[block_hash] = 1
            self._owners[block_hash] = {tenant: 1}
            return True
        return False

    def fetch(self, block_hash: str) -> Optional[Dict[str, torch.Tensor]]:
        """A copied payload for seeding a replica's spill tier (None on a
        miss or a checksum mismatch, which discards the entry). A peek
        like :meth:`export_entry`, but a hit: the entry becomes the most
        recently used."""
        payload = self.export_entry(block_hash)
        if payload is not None:
            self._entries.move_to_end(block_hash)
        return payload

    def probe(self, hashes: Sequence[str], start: int = 0) -> int:
        """Length of the run of resident ``hashes`` from ``start`` (read
        only)."""
        n = int(start)
        while n < len(hashes) and hashes[n] in self._entries:
            n += 1
        return n - int(start)

    def tenant_bytes(self) -> Dict[str, float]:
        """Each tenant's share of the resident bytes: an entry's bytes
        split across its publishers by share."""
        out: Dict[str, float] = {}
        for h, rec in self._entries.items():
            refs = self._refs.get(h, 1)
            for t, n in (self._owners.get(h) or {}).items():
                out[t] = out.get(t, 0.0) + rec["bytes"] * n / refs
        return {t: round(v, 6) for t, v in out.items()}

    def check_integrity(self) -> None:
        """Raise ``ValueError`` unless the byte total equals the resident
        entries' sum within the bound, the refcount and share tables name
        exactly the resident hashes, and each entry's shares are positive
        and sum to its refcount (at least 1)."""
        total = sum(int(rec["bytes"]) for rec in self._entries.values())
        if total != self.total_bytes:
            raise ValueError(
                f"shared tier byte accumulator {self.total_bytes} != "
                f"sum of resident entries {total}")
        if self.total_bytes > self.max_bytes:
            raise ValueError(
                f"shared tier holds {self.total_bytes} bytes over its "
                f"budget {self.max_bytes}")
        for name, table in (("refcount", self._refs),
                            ("ownership", self._owners)):
            if set(table) != set(self._entries):
                stray = set(table) ^ set(self._entries)
                raise ValueError(
                    f"shared tier {name} table out of sync with the "
                    f"resident entries (mismatched hashes: "
                    f"{sorted(stray)[:3]})")
        for h, refs in self._refs.items():
            if refs < 1:
                raise ValueError(
                    f"shared entry {h!r} has refcount {refs} < 1")
            shares = self._owners[h]
            if any(n < 1 for n in shares.values()):
                raise ValueError(
                    f"shared entry {h!r} has a non-positive ownership "
                    f"share: {shares}")
            if sum(shares.values()) != refs:
                raise ValueError(
                    f"shared entry {h!r} ownership shares {shares} do "
                    f"not sum to its refcount {refs}")

    def stats(self) -> Dict[str, int]:
        out = super().stats()
        out["dedupe_hits"] = int(self.dedupe_hits)
        return out


def device_block_table(host_tables, num_blocks: int,
                       device=None) -> torch.Tensor:
    """Host tables use -1 for unallocated entries; the device convention
    is ``num_blocks`` (one past the pool)."""
    t = np.asarray(host_tables, np.int32)
    return torch.from_numpy(np.where(t >= 0, t, num_blocks).astype(
        np.int32)).to(device)


def write_coords(block_tables, positions, valid, num_blocks: int,
                 block_size: int):
    """The scatter coordinates ``(page, off, b, s, pos)`` of every VALID
    token write, as 1-D int64 tensors (``pos`` is the token's absolute
    position, ``positions[b, s]``, which keys the quantized write's
    rounding). Invalid tokens (padding, frozen lanes, positions below
    ``write_start``) and tokens whose table entry is unallocated are left
    out, which is what the JAX scatter's ``mode="drop"`` does with them:
    nothing is ever written to block ``num_blocks``. Filtering is a host
    sync on CUDA, so the model computes the coordinates once per forward
    and every layer's write shares them."""
    M = block_tables.shape[1]
    entry = (positions // block_size).clamp(max=M - 1).long()
    page = torch.gather(block_tables.long(), 1, entry)
    keep = valid & (page < num_blocks)
    b, s = keep.nonzero(as_tuple=True)
    pos = positions[b, s].long()
    return page[b, s], pos % block_size, b, s, pos


def paged_write(pages, layer: int, coords, values) -> None:
    """Write per-token K or V rows (``values`` ``[B, S, H, D]``) into one
    layer of a full-precision pool ``[L, N, bs, H, D]``, in place, at
    ``coords`` (:func:`write_coords`)."""
    page, off, b, s = coords[:4]
    pages[layer, page, off] = values[b, s].to(pages.dtype)


def write_kv(cache: KVCache, layer: int, coords, k_values,
             v_values, head_offset: int = 0) -> KVCache:
    """Write one layer's K and V rows at ``coords``: two
    :func:`paged_write` calls into full-precision pools; into int8/fp8
    pools, :func:`~apex_tpu_torch.ops.kv_quant.kv_quant_write` (payload
    and scales, the kernel on CUDA tensors). ``head_offset``: the global
    index of the pool's first head (a model shard's), which keys the
    quantized rounding."""
    if cache.k_scale is None:
        paged_write(cache.k, layer, coords, k_values)
        paged_write(cache.v, layer, coords, v_values)
    else:
        kv_quant_write(cache.k, cache.v, cache.k_scale, cache.v_scale,
                       layer, coords, k_values, v_values, head_offset)
    return cache


def copy_block(cache, src: int, dst: int):
    """Copy block ``src`` onto ``dst`` in every layer, in place, scales
    with their payload: the device half of copy-on-write. On a
    :class:`ShardedKVCache` both ids lie on one batch shard, and every
    model shard of it copies its heads."""
    if isinstance(cache, ShardedKVCache):
        (bs_, ls), (bd, ld) = cache.locate(src), cache.locate(dst)
        if bs_ != bd:
            raise ValueError(f"copy_block: blocks {src} and {dst} lie on "
                             f"batch shards {bs_} and {bd}")
        for shard in cache.shards[bs_]:
            copy_block(shard, ls, ld)
        return cache
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if pool is not None:
            pool[:, dst] = pool[:, src]
    return cache


def gather_blocks(cache, perm):
    """Permute the pool's blocks in place (``new[i] = old[perm[i]]``),
    scales with their payload. On a :class:`ShardedKVCache` the
    permutation keeps every block on its batch shard, and each shard
    applies its local part."""
    perm = np.asarray(perm, np.int64)
    if isinstance(cache, ShardedKVCache):
        Nl = cache.blocks_per_shard
        if np.any(perm // Nl != np.arange(len(perm)) // Nl):
            raise ValueError("gather_blocks: the permutation moves blocks "
                             "across batch shards")
        for b, row in enumerate(cache.shards):
            local = perm[b * Nl:(b + 1) * Nl] - b * Nl
            for shard in row:
                gather_blocks(shard, local)
        return cache
    perm = torch.as_tensor(perm, dtype=torch.long, device=cache.k.device)
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if pool is not None:
            pool.copy_(pool[:, perm])
    return cache


def defragment(cache, allocator: BlockAllocator, host_tables):
    """Compact the live blocks (those in ``host_tables``) to the lowest
    ids of their batch shard, in place: the pool is permuted (every
    shard of a :class:`ShardedKVCache`), the allocator's refcounts and
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
    Nl = allocator.blocks_per_shard
    mapping: Dict[int, int] = {}
    perm = np.arange(cache.num_blocks, dtype=np.int64)
    for sh in range(allocator.num_shards):
        base = sh * Nl
        own = live[(live >= base) & (live < base + Nl)]
        mapping.update({int(old): base + new for new, old in enumerate(own)})
        rest = np.setdiff1d(np.arange(base, base + Nl), own)
        perm[base:base + len(own)] = own
        perm[base + len(own):base + Nl] = rest
    new_live = set(mapping.values())
    for idx, old in np.ndenumerate(tables):
        if old >= 0:
            tables[idx] = mapping[int(old)]
    for b in allocator._evictable:       # dropped, counted as evictions
        owner = allocator._cached_owner.pop(b, None)
        if owner is not None:
            allocator._evicted_by_tenant[owner] = \
                allocator._evicted_by_tenant.get(owner, 0) + 1
    allocator.num_evictions += len(allocator._evictable)
    allocator._evictable.clear()
    allocator._ref = {mapping[b]: c for b, c in allocator._ref.items()}
    allocator._tenant_refs = {mapping[b]: refs for b, refs in
                              allocator._tenant_refs.items()}
    allocator._hash_to_block = {
        h: mapping[b] for h, b in allocator._hash_to_block.items()
        if b in mapping}
    allocator._block_to_hash = {
        b: h for h, b in allocator._hash_to_block.items()}
    allocator._cached_owner = {
        mapping[b]: t for b, t in allocator._cached_owner.items()
        if b in mapping}
    # descending, so pop() serves ascending ids first
    allocator._free = [b for b in range(cache.num_blocks - 1, -1, -1)
                       if b not in new_live]
    return gather_blocks(cache, perm), tables
