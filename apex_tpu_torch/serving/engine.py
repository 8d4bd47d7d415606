"""Continuous-batching inference engine for the port's GPT
(counterpart of :mod:`apex_tpu.serving.engine`).

Usage::

    engine = InferenceEngine(model, EngineConfig(...))    # on the card
    engine.add_request(Request("a", prompt, max_new_tokens=32))
    outputs = engine.run()          # {"a": [tok, tok, ...]}

The scheduler keeps the JAX engine's structure: admission on current
need (the prompt's uncached blocks plus the first decode write), one
``[1, prefill_chunk]`` prefill chunk per tick, a K-step decode dispatch
over every started lane (``-1`` sentinels, budget and EOS freezing
through ``write_start``), preemption with recompute when the pool runs
dry, and a drain deferred to the next tick. Token ``j`` of the request
that arrived ``a``-th draws from ``token_generator(seed, a, j)``, so
outputs do not depend on ``decode_steps``, lane placement, preemption,
priorities or tenants.

``enable_prefix_caching`` shares block-aligned prompt prefixes through
the allocator's chain-hash index: admission takes the longest cached
prefix by reference and prefills only the tail, full blocks are
registered as they fill, finished requests leave their registered
blocks cached (LRU-evictable), and a decode write into a shared block
copies it first. ``spec_tokens > 0`` swaps the K-step decode for
draft-and-verify: a drafter (:class:`~apex_tpu_torch.serving.drafter.
NgramDrafter` by default) proposes up to ``spec_tokens`` tokens a lane,
ONE ``[max_batch, spec_tokens + 1]`` forward through the paged cache
scores every candidate, and :func:`~apex_tpu_torch.serving.sampling.
spec_verify_tokens` emits 1 to ``spec_tokens + 1`` tokens a lane; the
span's blocks are reserved for the worst case and those rejection
strands go back at the drain (``BlockAllocator.trim_to``). With
``spec_adapt`` an acceptance EWMA walks the per-plan draft cap down and
back up.

``kv_quantization`` ("int8" or "fp8") stores the KV pool quantized with
per-row scales: the write quantizes (:mod:`apex_tpu_torch.ops.kv_quant`,
position-keyed rounding, so outputs stay schedule-invariant within a
mode), the attention read dequantizes, and a quantized block charges the
tenant ledger its reduced bytes (``block_weight``).

Overload and tenancy: the waiting queue is bounded (``max_waiting``:
:class:`QueueFullError`, or ``try_add`` returns False); requests carry
a ``priority`` class (0 most urgent; strict priority between classes,
preemption takes the lowest class, then the youngest) and a ``tenant``
(weighted deficit round robin across tenants within a class,
:class:`TenantQuota` limits on waiting entries, resident block charge
and token rate, a shed over quota ending ``"throttled"``); a
``deadline_s`` ends a request ``"timeout"``, and an admit-time
feasibility gate ends one whose deadline cannot cover a contention-free
service estimate ``"rejected"``; :meth:`InferenceEngine.abort` ends one
``"cancelled"``; :meth:`InferenceEngine.pop_stream_events` streams
``(uid, token, is_last)``. Under sustained pressure (queue or free-block
watermarks) a degradation ladder suspends speculation, then flushes the
prefix cache every tick, then pauses the classes at or past
``degrade_admit_priority``, and climbs back once pressure clears.
Deadlines, the token-rate estimator and the service EWMAs read the
engine's clock (``clock=``, ``time.monotonic`` by default).

Faults and recovery: with ``faults=`` (a :class:`~apex_tpu_torch.utils.
faults.FaultPlan`) every prefill chunk, decode (or verify) dispatch and
drafter call fires the plan at its site (``"prefill"``, ``"decode"``,
``"draft"``) before it runs, under the retry policy of
:func:`~apex_tpu_torch.utils.faults.guarded_call`
(``max_dispatch_retries``, ``retry_backoff_s``). A prefill whose retries
run out ends its request ``"failed"`` (quarantine, tokens kept); a decode
dispatch whose retries run out quarantines the lowest-class, youngest
lane and dispatches again over the rest; a drafter that raises (or runs
out of retries) is quarantined for good, and decoding goes on without
proposals. A fetch failure at the drain counts against the same budget,
then requeues every resident with its tokens and resets the allocator and
the pool, whose contents re-derive by re-prefill. A ``"corrupt"`` fire at
``"decode"`` perturbs one drained token (the silent-data-corruption
model). :meth:`InferenceEngine.snapshot` (after a drain) and
:meth:`InferenceEngine.checkpoint` (without one; every
``snapshot_interval_ticks`` ticks into ``last_checkpoint``) build a
sealed JSON-able picture; :meth:`InferenceEngine.restore` verifies it
(``verify_artifacts``), checks the config fingerprint, and re-queues
every unfinished request with its arrival index and tokens, so a
restored run continues the uninterrupted one's tokens. A CUDA error is
not retried (it is sticky; ROADMAP C7): recovery from one is a restore
in a new process.

``spill_max_bytes`` adds a bounded host-RAM tier under the prefix cache
(:class:`~apex_tpu_torch.serving.kv_cache.HostSpillStore`): a cached block
the allocator evicts is first copied to the host with a checksum, and an
admission whose chain continues into the store re-admits those blocks by
one in-place upload instead of prefilling them; a corrupt entry
(``verify_artifacts``) is discarded and recomputed. Every
``scrub_interval_ticks`` ticks a scrub re-verifies
``scrub_spill_blocks`` entries and audits the allocator. Unlike the JAX
engine's, the spill fetch catches no error: a CUDA error is sticky
(ROADMAP C7, C8).

``obs=`` (an :class:`~apex_tpu_torch.observability.Observability`)
traces every request's lifecycle, records the engine's decisions in a
flight recorder and keeps the latency histograms (TTFT and inter-token
times at the moment a token's copy reaches the host). Observation changes
no token, counter or launch.

``mesh_shape`` (and ``mesh=``, a :func:`~apex_tpu_torch.serving.mesh.
build_mesh` grid whose devices may repeat) serves the model over a
``("batch", "model")`` grid of shards (:mod:`apex_tpu_torch.serving.
mesh`): at model axis ``M > 1`` every forward runs each model shard's
heads on its own pool and weight shards and sums the two row-parallel
partials a block (counted ``all-reduce`` s, :meth:`InferenceEngine.
audit_collectives`); at batch axis ``B > 1`` lanes and blocks split into
``B`` groups, each running only its lanes against its own block range.
Every shard's kernel is an ordinary single-device call. ``(1, 1)`` is the
engine without a mesh.

The replica and migration surface (:meth:`InferenceEngine.pop_results`,
``load``, ``export_requests``, ``import_requests``,
``export_prefix_payloads``, ``import_prefix_payloads``, ...) moves live
requests between engines as sealed, layout-free records that keep their
arrival index, so a migrated request continues its token stream on any
engine of the same model and seed, at any mesh shape.

Not in this engine: the fleet's router and its shared prefix tier
(ROADMAP A.3 item 19b).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.models.gpt import (
    WEIGHT_QUANT_MODES,
    gpt_param_bytes,
    quantize_gpt_model,
    sharded_serve_forward,
)
from apex_tpu_torch.observability import QUANT_MODE_CODES
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.serving import mesh as mesh_lib
from apex_tpu_torch.serving.drafter import NgramDrafter
from apex_tpu_torch.serving.kv_cache import (
    DEFAULT_TENANT,
    KV_QUANT_MODES,
    BlockAllocator,
    CacheOutOfBlocks,
    HostSpillStore,
    ShardedKVCache,
    blocks_needed,
    copy_block,
    device_block_table,
    hash_block_tokens,
    kv_block_bytes,
    seq_block_hashes,
)
from apex_tpu_torch.serving.sampling import (
    SamplingParams,
    sample_with_uniforms,
    spec_uniforms,
    spec_verify_tokens,
    token_generator,
    uniforms,
)
from apex_tpu_torch.utils.faults import (
    TRANSIENT_ERRORS,
    DispatchFailedError,
    SimulatedCrash,
    guarded_call,
    perturb_json,
    perturb_payload,
    perturb_tokens,
)
from apex_tpu_torch.utils.integrity import (
    IntegrityError,
    payload_checksum,
    seal_record,
    verify_payload,
    verify_record,
)

# new-observation weight of the service-time EWMAs (the feasibility
# gate) and of the speculation acceptance EWMA (spec_adapt)
_EWMA_ALPHA = 0.25
# degradation-ladder rungs (cumulative): 1 = speculation suspended,
# 2 = + prefix cache flushed every tick, 3 = + the lower classes'
# admission paused
_LADDER_TOP = 3
# while the spec_adapt cap sits at 0, every Nth decode phase runs a
# 1-token probe, so acceptance is measured again and the cap can climb
_SPEC_PROBE_EVERY = 16
# the FaultPlan sites that take only "corrupt" specs: the spill tier's
# write and read, the periodic checkpoint, and migration records out
# (export_requests, one fire a record) and in (import_requests). The spill
# sites fire when a spill tier is configured.
_INTEGRITY_SITES = ("spill_put", "spill_get", "checkpoint",
                    "export", "import")


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant bounds (``EngineConfig.tenant_quotas``), each optional:

    - ``max_waiting``: waiting entries the tenant may hold; the door
      sheds past it (``"throttled"``).
    - ``max_resident_blocks``: ceiling of the tenant's fractional
      resident-block charge (``BlockAllocator.tenant_charge``, in
      ``block_weight`` units). The door sheds a request whose worst case
      exceeds it, admission skips the tenant while over it, and decode
      growth past it preempts the tenant's own youngest other lane.
    - ``tokens_per_s``: the door sheds while the tenant's decayed token
      rate (``tenant_rate_tau_s``) exceeds it.
    """

    max_waiting: Optional[int] = None
    max_resident_blocks: Optional[int] = None
    tokens_per_s: Optional[float] = None

    def validate(self, tenant: str) -> None:
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(
                f"tenant {tenant!r}: max_waiting must be >= 1 (or None), "
                f"got {self.max_waiting}")
        if (self.max_resident_blocks is not None
                and self.max_resident_blocks < 1):
            raise ValueError(
                f"tenant {tenant!r}: max_resident_blocks must be >= 1 "
                f"(or None), got {self.max_resident_blocks}")
        if self.tokens_per_s is not None and self.tokens_per_s <= 0:
            raise ValueError(
                f"tenant {tenant!r}: tokens_per_s must be > 0 (or "
                f"None), got {self.tokens_per_s}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: runs until EOS (if ``eos_token_id`` is
    set) or ``max_new_tokens``, or leaves early: past ``deadline_s``
    seconds of the engine's clock from ``add_request`` (``"timeout"``),
    shed by the feasibility gate (``"rejected"``) or a tenant quota
    (``"throttled"``), or aborted (``"cancelled"``); tokens already
    emitted are kept. ``priority`` (0 most urgent) and ``tenant`` only
    schedule: sampling is arrival-keyed. ``status`` is written by the
    engine when the request leaves it."""

    uid: str
    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    eos_token_id: Optional[int] = None
    deadline_s: Optional[float] = None
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    status: Optional[str] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """One entry of ``run(return_status=True)``: the emitted tokens and
    the terminal status ("finished", "timeout", "rejected", "throttled",
    "cancelled" or "failed")."""

    tokens: List[int]
    status: str


class QueueFullError(RuntimeError):
    """``add_request`` refused: the waiting queue holds ``max_waiting``
    entries. The request never entered the engine (no status)."""


class TenantThrottledError(RuntimeError):
    """``add_request`` refused by the tenant's :class:`TenantQuota`; the
    request ends ``"throttled"`` with no tokens, drained by ``run()``."""


class EngineStalledError(RuntimeError):
    """``has_work`` is true but a full ``step()`` made no progress;
    ``engine_stats`` holds ``stats()`` at the stall, ``recorder_tail`` the
    flight recorder's last events when an observer was attached (else
    None)."""

    def __init__(self, message: str, stats: Dict[str, object],
                 recorder_tail=None):
        super().__init__(f"{message} (stats: {stats})")
        self.engine_stats = stats
        self.recorder_tail = recorder_tail


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8            # decode lanes
    block_size: int = 16
    num_blocks: int = 256         # pool size (per layer)
    max_prefill_len: int = 64     # default prefill chunk
    max_seq_len: int = 256        # prompt + generation cap per sequence
    prefill_chunk: Optional[int] = None   # None inherits max_prefill_len
    decode_steps: int = 1         # decode iterations per dispatch
    # share block-aligned prompt prefixes through the chain-hash index;
    # finished requests' registered blocks stay cached, not freed
    enable_prefix_caching: bool = False
    kv_dtype: Optional[torch.dtype] = None    # None = fp32
    # None | "int8" | "fp8": quantized KV blocks with per-row scales
    kv_quantization: Optional[str] = None
    weight_quantization: Optional[str] = None  # None | "int8" | "fp8"
    # the host-RAM spill tier: evicted and flushed prefix blocks are
    # copied to a host store of at most this many payload bytes and
    # re-admitted by upload (None: off). Needs enable_prefix_caching.
    # Operational: it stays out of the snapshot fingerprint
    spill_max_bytes: Optional[int] = None
    # > 0: draft-and-verify decoding with up to this many proposals a
    # lane (decode_steps is then unused: the verify forward is the
    # dispatch)
    spec_tokens: int = 0
    # -- overload --------------------------------------------------------
    # bound on the waiting queue (None: unbounded); preemption requeues
    # pass it (by at most max_batch)
    max_waiting: Optional[int] = None
    # the ladder's pressure: queue depth >= queue_high_watermark, or
    # (free + cached) / num_blocks <= free_block_low_watermark; a rung
    # down after degrade_patience pressure ticks in a row, a rung up
    # after as many clear ones; rung 3 pauses classes >=
    # degrade_admit_priority. Both watermarks None: ladder off
    queue_high_watermark: Optional[int] = None
    free_block_low_watermark: Optional[float] = None
    degrade_patience: int = 2
    degrade_admit_priority: int = 1
    # -- tenancy -----------------------------------------------------------
    # DRR weight per tenant (unlisted: 1); each walk visit credits weight
    # x drr_quantum tokens, a request costs len(prompt) + max_new_tokens
    # once
    tenant_weights: Optional[Mapping[str, int]] = None
    tenant_quotas: Optional[Mapping[str, TenantQuota]] = None
    drr_quantum: int = 64
    # time constant of the per-tenant token-rate estimator (seconds)
    tenant_rate_tau_s: float = 1.0
    # -- adaptive speculation ------------------------------------------------
    # an acceptance EWMA shrinks the draft cap by one below
    # spec_accept_low and restores it by one above spec_accept_high
    spec_adapt: bool = False
    spec_accept_low: float = 0.5
    spec_accept_high: float = 0.8
    # -- faults and recovery -------------------------------------------------
    # a failed prefill/decode/draft call is retried up to
    # max_dispatch_retries times, sleeping retry_backoff_s * 2**(attempt -
    # 1) before each retry
    max_dispatch_retries: int = 2
    retry_backoff_s: float = 0.0
    # checkpoint() every N ticks into last_checkpoint (None: off)
    snapshot_interval_ticks: Optional[int] = None
    # verify the checksums of snapshots at restore() and of spilled
    # blocks at every read
    verify_artifacts: bool = True
    # every N ticks re-verify scrub_spill_blocks spill entries (round
    # robin) and audit the allocator (None: off); operational
    scrub_interval_ticks: Optional[int] = None
    scrub_spill_blocks: int = 4
    # the (batch, model) serving mesh (apex_tpu_torch.serving.mesh): the
    # model axis splits heads and weights, the batch axis lanes and
    # blocks; part of the snapshot fingerprint (snapshots restore across
    # equal meshes only)
    mesh_shape: Tuple[int, int] = (1, 1)
    seed: int = 0

    @property
    def chunk(self) -> int:
        return (self.prefill_chunk if self.prefill_chunk is not None
                else self.max_prefill_len)

    def __post_init__(self):
        for name in ("max_batch", "block_size", "num_blocks",
                     "max_seq_len", "max_prefill_len"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.chunk}")
        if self.chunk > self.max_seq_len:
            raise ValueError(f"prefill_chunk ({self.chunk}) exceeds "
                             f"max_seq_len ({self.max_seq_len})")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got "
                             f"{self.decode_steps}")
        if self.kv_quantization not in KV_QUANT_MODES:
            raise ValueError(
                f"kv_quantization must be one of {KV_QUANT_MODES}, "
                f"got {self.kv_quantization!r}")
        if self.weight_quantization not in WEIGHT_QUANT_MODES:
            raise ValueError(
                f"weight_quantization must be one of "
                f"{WEIGHT_QUANT_MODES}, got {self.weight_quantization!r}")
        if self.spill_max_bytes is not None:
            if self.spill_max_bytes < 1:
                raise ValueError(
                    f"spill_max_bytes must be >= 1 (or None for no "
                    f"spill tier), got {self.spill_max_bytes}")
            if not self.enable_prefix_caching:
                raise ValueError(
                    "spill_max_bytes requires enable_prefix_caching: "
                    "the spill tier is keyed by the prefix index's "
                    "hash chains, and nothing registers without it")
        if self.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {self.spec_tokens}")
        if self.max_dispatch_retries < 0:
            raise ValueError(
                f"max_dispatch_retries must be >= 0, got "
                f"{self.max_dispatch_retries}")
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(
                f"max_waiting must be >= 1 (or None for unbounded), "
                f"got {self.max_waiting}")
        if (self.queue_high_watermark is not None
                and self.queue_high_watermark < 1):
            raise ValueError(
                f"queue_high_watermark must be >= 1, got "
                f"{self.queue_high_watermark}")
        if (self.queue_high_watermark is not None
                and self.max_waiting is not None
                and self.queue_high_watermark
                > self.max_waiting + self.max_batch):
            # the queue never exceeds max_waiting + max_batch: a higher
            # watermark would leave the ladder's queue signal inert
            raise ValueError(
                f"queue_high_watermark ({self.queue_high_watermark}) is "
                f"unreachable: the queue never exceeds max_waiting + "
                f"max_batch ({self.max_waiting} + {self.max_batch})")
        if (self.free_block_low_watermark is not None
                and not 0.0 < self.free_block_low_watermark <= 1.0):
            raise ValueError(
                f"free_block_low_watermark must be in (0, 1], got "
                f"{self.free_block_low_watermark}")
        if self.degrade_patience < 1:
            raise ValueError(
                f"degrade_patience must be >= 1, got "
                f"{self.degrade_patience}")
        if self.degrade_admit_priority < 1:
            raise ValueError(
                f"degrade_admit_priority must be >= 1 (0 would pause "
                f"every class), got {self.degrade_admit_priority}")
        if self.tenant_weights is not None:
            for t, w in self.tenant_weights.items():
                if int(w) < 1:
                    raise ValueError(
                        f"tenant_weights[{t!r}] must be >= 1, got {w}")
        if self.tenant_quotas is not None:
            for t, q in self.tenant_quotas.items():
                if not isinstance(q, TenantQuota):
                    raise ValueError(
                        f"tenant_quotas[{t!r}] must be a TenantQuota, "
                        f"got {type(q).__name__}")
                q.validate(t)
        if self.drr_quantum < 1:
            raise ValueError(
                f"drr_quantum must be >= 1, got {self.drr_quantum}")
        if self.tenant_rate_tau_s <= 0:
            raise ValueError(
                f"tenant_rate_tau_s must be > 0, got "
                f"{self.tenant_rate_tau_s}")
        if (self.snapshot_interval_ticks is not None
                and self.snapshot_interval_ticks < 1):
            raise ValueError(
                f"snapshot_interval_ticks must be >= 1 (or None for no "
                f"periodic checkpointing), got "
                f"{self.snapshot_interval_ticks}")
        if self.spec_adapt and self.spec_tokens < 1:
            raise ValueError(
                "spec_adapt requires spec_tokens >= 1 (there is no "
                "draft cap to adapt at spec_tokens == 0)")
        if not 0.0 <= self.spec_accept_low <= self.spec_accept_high <= 1.0:
            raise ValueError(
                f"spec acceptance thresholds must satisfy 0 <= low <= "
                f"high <= 1, got low={self.spec_accept_low} "
                f"high={self.spec_accept_high}")
        if (self.scrub_interval_ticks is not None
                and self.scrub_interval_ticks < 1):
            raise ValueError(
                f"scrub_interval_ticks must be >= 1 (or None for no "
                f"background scrubbing), got {self.scrub_interval_ticks}")
        if self.scrub_spill_blocks < 1:
            raise ValueError(
                f"scrub_spill_blocks must be >= 1, got "
                f"{self.scrub_spill_blocks}")
        # the geometry half of the mesh check (the model's heads are
        # checked by the engine), normalized to a tuple
        object.__setattr__(self, "mesh_shape",
                           mesh_lib.validate_mesh_shape(
                               self.mesh_shape, max_batch=self.max_batch,
                               num_blocks=self.num_blocks))


@dataclasses.dataclass
class _QueueEntry:
    """A waiting (or preempted) request. ``generated`` carries tokens
    already emitted, so re-admission re-prefills ``prompt +
    generated[:-1]`` and resumes from ``generated[-1]``; ``arrival``
    keys the request's sampling and survives preemption. ``enq_t`` /
    ``enq_tick`` stamp when it (re-)entered the queue (the wait
    statistics); ``drr_charged``: its DRR cost was paid (preemption
    requeues re-admit free, ahead of uncharged work)."""

    request: Request
    arrival: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    hashes: Optional[List[str]] = None   # the full blocks' chain hashes
    enq_t: float = 0.0
    enq_tick: int = 0
    drr_charged: bool = False


class _ClassQueue:
    """One priority class: per-tenant FIFO deques and the class's DRR
    walk state (``ring``: tenants with waiting entries in first-enqueue
    order; ``cursor``: the walk's ring position; ``credited``: whether
    the cursor tenant got its quantum this visit; ``deficits``). A
    tenant whose deque drains leaves the ring and forfeits its
    deficit."""

    __slots__ = ("queues", "ring", "cursor", "credited", "deficits")

    def __init__(self):
        self.queues: Dict[str, deque] = {}
        self.ring: List[str] = []
        self.cursor: int = 0
        self.credited: bool = False
        self.deficits: Dict[str, float] = {}

    def remove_tenant(self, tenant: str) -> None:
        i = self.ring.index(tenant)
        self.ring.pop(i)
        del self.queues[tenant]
        self.deficits.pop(tenant, None)
        if not self.ring:
            self.cursor, self.credited = 0, False
            return
        if i < self.cursor:
            self.cursor -= 1
        elif i == self.cursor:
            # the cursor now points at the next tenant: a fresh visit
            self.credited = False
            if self.cursor >= len(self.ring):
                self.cursor = 0


class _WaitingQueue:
    """Strict priority between classes (ascending, 0 most urgent),
    weighted deficit round robin across tenants within a class.
    ``append`` enqueues at the tail of the request's (class, tenant)
    FIFO, ``appendleft`` (preemption requeues) at its head. Entries whose
    DRR cost was paid are served ahead of the walk without touching it,
    so one tenant reduces to per-class FIFO with front requeues.
    Iteration is class by class, ring order, FIFO within a tenant."""

    def __init__(self, weights: Optional[Mapping[str, int]] = None,
                 quantum: int = 64):
        self._classes: Dict[int, _ClassQueue] = {}
        self._weights = dict(weights or {})
        self._quantum = max(1, int(quantum))
        self._tenant_depth: Dict[str, int] = {}

    @staticmethod
    def _cost(entry: _QueueEntry) -> int:
        """The DRR cost of admitting an entry: its committed token
        budget, charged once a request lifetime."""
        if entry.drr_charged:
            return 0
        return len(entry.request.prompt) + entry.request.max_new_tokens

    def _weight(self, tenant: str) -> int:
        return max(1, int(self._weights.get(tenant, 1)))

    def tenant_depth(self, tenant: str) -> int:
        """Waiting entries of ``tenant`` in every class."""
        return self._tenant_depth.get(tenant, 0)

    def _classes_ascending(self, below: Optional[int]):
        for p in sorted(self._classes):
            if below is not None and p >= below:
                return
            yield self._classes[p]

    def _note_removed(self, cq: _ClassQueue, tenant: str) -> None:
        self._tenant_depth[tenant] -= 1
        if not self._tenant_depth[tenant]:
            del self._tenant_depth[tenant]
        if not cq.queues[tenant]:
            cq.remove_tenant(tenant)

    def append(self, entry: _QueueEntry) -> None:
        self._enqueue(entry, left=False)

    def appendleft(self, entry: _QueueEntry) -> None:
        self._enqueue(entry, left=True)

    def _enqueue(self, entry: _QueueEntry, left: bool) -> None:
        cq = self._classes.setdefault(entry.request.priority,
                                      _ClassQueue())
        t = entry.request.tenant
        q = cq.queues.get(t)
        if q is None:
            q = cq.queues[t] = deque()
            cq.ring.append(t)           # new tenants join at the tail
            cq.deficits.setdefault(t, 0.0)
        (q.appendleft if left else q.append)(entry)
        self._tenant_depth[t] = self._tenant_depth.get(t, 0) + 1

    def _walk(self, cq: _ClassQueue, skip, mutate: bool):
        """The entry the class would admit next: ``mutate=False`` peeks,
        ``True`` pops it and commits the walk. ``skip`` tenants are
        passed without credit. None when nothing is servable."""
        skip = skip or ()
        n = len(cq.ring)
        # phase 1: charged heads (requeues) serve out of band, ring order
        # from the cursor, the walk state untouched
        for k in range(n):
            t = cq.ring[(cq.cursor + k) % n]
            if t in skip:
                continue
            q = cq.queues[t]
            if q and q[0].drr_charged:
                if not mutate:
                    return q[0]
                e = q.popleft()
                self._note_removed(cq, t)
                return e
        # phase 2: the weighted DRR walk
        candidates = [t for t in cq.ring if t not in skip]
        if not candidates:
            return None
        deficits = cq.deficits if mutate else dict(cq.deficits)
        cursor, credited = cq.cursor, cq.credited
        # termination bound (a bug guard): each credit costs two
        # iterations (the credit, then the advance after the re-check)
        max_cost = max(self._cost(cq.queues[t][0]) for t in candidates)
        limit = 2 * len(cq.ring) * (max_cost // self._quantum + 2) + 16
        for _ in range(limit):
            t = cq.ring[cursor]
            if t in skip:
                cursor = (cursor + 1) % len(cq.ring)
                credited = False
                continue
            head = cq.queues[t][0]
            cost = self._cost(head)
            if deficits[t] >= cost:
                if not mutate:
                    return head
                e = cq.queues[t].popleft()
                deficits[t] -= cost
                e.drr_charged = True
                # the cursor stays on the serving tenant while its
                # deficit lasts
                cq.cursor, cq.credited = cursor, credited
                self._note_removed(cq, t)
                return e
            if not credited:
                deficits[t] += self._quantum * self._weight(t)
                credited = True
                continue
            cursor = (cursor + 1) % len(cq.ring)
            credited = False
        raise RuntimeError(
            "DRR walk failed to terminate — invariant bug "
            f"(ring={cq.ring}, deficits={deficits})")

    def head(self, below: Optional[int] = None,
             skip=None) -> Optional[_QueueEntry]:
        """The next admissible entry, or None. ``below`` restricts to
        classes under it (the ladder's pause); ``skip`` tenants are
        passed over (quota holds), and a class whose every tenant is
        skipped falls through to the next."""
        for cq in self._classes_ascending(below):
            e = self._walk(cq, skip, mutate=False)
            if e is not None:
                return e
        return None

    def popleft(self, below: Optional[int] = None,
                skip=None) -> _QueueEntry:
        """Pop exactly the entry :meth:`head` (same arguments)
        returns."""
        for p in sorted(self._classes):
            if below is not None and p >= below:
                break
            cq = self._classes[p]
            e = self._walk(cq, skip, mutate=True)
            if e is not None:
                if not cq.ring:
                    del self._classes[p]
                return e
        raise IndexError("pop from an empty waiting queue")

    def has_priority_below(self, limit: int) -> bool:
        return any(True for _ in self._classes_ascending(limit))

    def expel(self, pred) -> List[_QueueEntry]:
        """Remove and return (in iteration order) every entry matching
        ``pred``, keeping the survivors' order and walk state: the
        deadline and abort sweep."""
        removed: List[_QueueEntry] = []
        for p in sorted(self._classes):
            cq = self._classes[p]
            for t in list(cq.ring):
                q = cq.queues[t]
                kept: deque = deque()
                while q:
                    e = q.popleft()
                    if pred(e):
                        removed.append(e)
                        self._tenant_depth[t] -= 1
                        if not self._tenant_depth[t]:
                            del self._tenant_depth[t]
                    else:
                        kept.append(e)
                cq.queues[t] = kept
                if not kept:
                    cq.remove_tenant(t)
            if not cq.ring:
                del self._classes[p]
        return removed

    def snapshot_state(self) -> Dict[str, object]:
        """The JSON-able DRR walk state a class: ring order, the cursor's
        tenant, its credited flag and the deficits."""
        out = {}
        for p, cq in self._classes.items():
            out[str(p)] = {
                "ring": list(cq.ring),
                "cursor_tenant": (cq.ring[cq.cursor] if cq.ring
                                  else None),
                "credited": bool(cq.credited),
                "deficits": {t: float(d) for t, d in cq.deficits.items()},
            }
        return out

    def restore_state(self, state: Mapping[str, object]) -> None:
        """Re-apply :meth:`snapshot_state` after the entries were
        appended again: the serialized ring order first (tenants it no
        longer holds drop out), tenants new to it at the tail; the cursor
        re-anchors on its tenant."""
        for key, rec in (state or {}).items():
            cq = self._classes.get(int(key))
            if cq is None:
                continue
            serialized = [t for t in rec.get("ring", ()) if t in cq.queues]
            cq.ring = serialized + [t for t in cq.ring
                                    if t not in serialized]
            for t, d in (rec.get("deficits") or {}).items():
                if t in cq.queues:
                    cq.deficits[t] = float(d)
            cur = rec.get("cursor_tenant")
            if cur in cq.ring:
                cq.cursor = cq.ring.index(cur)
                cq.credited = bool(rec.get("credited", False))
            else:
                cq.cursor, cq.credited = 0, False

    def __iter__(self):
        for p in sorted(self._classes):
            cq = self._classes[p]
            for t in cq.ring:
                yield from cq.queues[t]

    def __len__(self) -> int:
        return sum(self._tenant_depth.values())


@dataclasses.dataclass
class _Slot:
    """Host-side state of one lane."""

    entry: _QueueEntry
    admit_seq: int          # admission order (preemption takes the largest)
    tokens: List[int]       # tokens whose K/V belong in the cache
    prefill_len: int
    prefill_pos: int        # prompt tokens already cached
    context_len: int        # tokens currently valid in the cache
    blocks: List[int]       # owned or shared block ids, sequence order
    block_hashes: List[str]  # chain hashes of the full blocks (lazy tail)
    num_registered: int     # full blocks already in the prefix index
    generated: List[int]
    last_token: int
    started: bool           # first token known -> decoding

    @property
    def request(self) -> Request:
        return self.entry.request


class InferenceEngine:
    """Drives a :class:`~apex_tpu_torch.models.GPTLMHeadModel` through
    continuous-batching generation on ``device`` (the CUDA card unless
    the caller asks for another; the model is moved there). With
    ``config.weight_quantization`` set the engine serves a quantized
    copy of the model. ``drafter`` proposes the speculative tokens when
    ``config.spec_tokens > 0`` (default :class:`NgramDrafter`).
    ``clock`` (a function returning seconds, ``time.monotonic`` by
    default) is what deadlines, the tenant token rates and the service
    EWMAs read. ``faults`` (a :class:`~apex_tpu_torch.utils.faults.
    FaultPlan`) fires at ``"prefill"``, ``"decode"``, ``"draft"`` and
    ``"checkpoint"``, and with a spill tier at ``"spill_put"`` and
    ``"spill_get"``, and at ``"export"`` and ``"import"`` when requests
    migrate. ``obs`` (an :class:`~apex_tpu_torch.observability.
    Observability`) observes; it reads the engine's clock and nothing of
    the device. ``mesh`` (a :class:`~apex_tpu_torch.serving.mesh.
    ServingMesh` of ``config.mesh_shape``) places the shards; by default
    ``(1, 1)`` is ``device`` and a larger shape the first CUDA devices.
    With a mesh, ``device`` (the host's side: inputs, sampling, the
    drained tokens) is its shard ``(0, 0)``'s."""

    mode = "in_process"

    def __init__(self, model, config: EngineConfig, *, drafter=None,
                 clock=None, device=None, faults=None, obs=None, mesh=None):
        if mesh is not None:
            if (tuple(mesh.axis_names) != mesh_lib.MESH_AXES
                    or tuple(mesh.mesh_shape)
                    != tuple(config.mesh_shape)):
                raise ValueError(
                    f"mesh= (axes {tuple(mesh.axis_names)}, shape "
                    f"{tuple(mesh.mesh_shape)}) does not match "
                    f"mesh_shape {tuple(config.mesh_shape)} over axes "
                    f"{mesh_lib.MESH_AXES}")
            if device is not None and torch.device(device).type \
                    != mesh.device(0, 0).type:
                raise ValueError(
                    f"device={device!r} does not match the mesh's shard "
                    f"(0, 0) device {mesh.device(0, 0)}")
            device = mesh.device(0, 0)
        self.device = resolve_device(device)
        if mesh is None:
            mesh = mesh_lib.build_mesh(
                config.mesh_shape,
                devices=([self.device] if config.mesh_shape == (1, 1)
                         else None))
        self.mesh = mesh
        self.config = config
        self.faults = faults
        if faults is not None:
            # serving outputs are integer tokens: a nan fire there would
            # corrupt nothing
            bad = [s.site for s in getattr(faults, "specs", ())
                   if s.kind == "nan"
                   and s.site in ("prefill", "decode", "draft")]
            if bad:
                raise ValueError(
                    f"nan faults are not supported at serving sites "
                    f"{sorted(set(bad))}; use transient/crash (the "
                    f"train loop's watchdog owns nan handling)")
            # the integrity sites take only "corrupt", and "corrupt" at a
            # dispatch site only at "decode" (a wrong drained token)
            bad = [s.site for s in getattr(faults, "specs", ())
                   if (s.site in _INTEGRITY_SITES
                       and s.kind != "corrupt")
                   or (s.kind == "corrupt"
                       and s.site in ("prefill", "draft"))]
            if bad:
                raise ValueError(
                    f"unsupported fault kind/site combination at "
                    f"{sorted(set(bad))}: integrity sites "
                    f"{_INTEGRITY_SITES} take only 'corrupt' specs, "
                    f"and 'corrupt' dispatch faults are supported at "
                    f"'decode' only (docs/robustness.md)")
        self._clock = time.monotonic if clock is None else clock
        # observation only: no decision reads observer state, and every
        # observer timestamp comes from the engine's clock
        self._obs = obs
        # (dispatch time, dispatch number) of the decode in flight, kept
        # only for an observer's dispatch-to-drain span
        self._pending_obs = None
        if config.spec_tokens > 0:
            self.drafter = NgramDrafter() if drafter is None else drafter
        elif drafter is not None:
            raise ValueError(
                "a drafter requires spec_tokens >= 1 (speculative "
                "decoding is off at spec_tokens == 0)")
        else:
            self.drafter = None
        # the coming dispatch's proposals, {lane: [token, ...]}
        self._draft_plan: Dict[int, List[int]] = {}
        model = model.to(self.device)
        self._weight_bytes = gpt_param_bytes(model)
        fp_bytes = self._weight_bytes
        if config.weight_quantization is not None:
            model = quantize_gpt_model(model, config.weight_quantization)
            self._weight_bytes = gpt_param_bytes(model)
        self.model = model.eval()
        if obs is not None:
            obs.bind_engine(self._clock)
            obs.gauge("kv_quant_mode",
                      QUANT_MODE_CODES[config.kv_quantization])
            obs.gauge("weight_quant_mode",
                      QUANT_MODE_CODES[config.weight_quantization])
            if config.weight_quantization is not None:
                obs.record("dequant_gemm",
                           mode=config.weight_quantization,
                           fp_bytes=fp_bytes, quant_bytes=self._weight_bytes)
        cfg = model.cfg
        if config.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len ({config.max_seq_len}) exceeds the model's "
                f"max_position_embeddings ({cfg.max_position_embeddings})")
        self.max_blocks_per_seq = blocks_needed(config.max_seq_len,
                                                config.block_size)
        head_dim = cfg.hidden_size // cfg.num_heads
        # -- the mesh: the model half of its check, the batch split, each
        # shard's pools and weights
        mesh_lib.validate_mesh_shape(config.mesh_shape,
                                     num_heads=cfg.num_heads)
        self._batch_shards, self._model_axis = config.mesh_shape
        self._lanes_per_shard = config.max_batch // self._batch_shards
        self._blocks_per_shard = config.num_blocks // self._batch_shards
        self._pools = ShardedKVCache.create(
            mesh.devices, cfg.num_layers, config.num_blocks,
            config.block_size, cfg.num_heads, head_dim,
            dtype=config.kv_dtype, quantization=config.kv_quantization)
        # batch group b's inputs live on its shard (b, 0)'s device
        self._group_device = [mesh.device(b, 0)
                              for b in range(self._batch_shards)]
        # at model axis 1 each batch group's one shard shares the model's
        # weights where it lies on the model's device
        self._model_shards = mesh_lib.shard_params(mesh, self.model)
        self._collectives = mesh_lib.CollectiveLog()
        # the tenant ledger's charge unit: a quantized block charges its
        # bytes over the full-precision block's, so max_resident_blocks
        # counts full-precision block equivalents
        self._block_weight = 1.0
        if config.kv_quantization is not None:
            self._block_weight = (
                kv_block_bytes(cfg.num_layers, config.block_size,
                               cfg.num_heads, head_dim,
                               quantization=config.kv_quantization)
                / kv_block_bytes(cfg.num_layers, config.block_size,
                                 cfg.num_heads, head_dim,
                                 dtype=config.kv_dtype))
        self.allocator = BlockAllocator(config.num_blocks,
                                        block_weight=self._block_weight,
                                        num_shards=self._batch_shards)
        # the host spill tier: the allocator copies evicted and flushed
        # blocks into it, _admit re-admits them by upload
        self.spill: Optional[HostSpillStore] = None
        self._spill_hits = 0
        self._spill_misses = 0
        self._num_scrubs = 0
        self._num_scrub_blocks_verified = 0
        if config.spill_max_bytes is not None:
            self.spill = HostSpillStore(
                config.spill_max_bytes, verify=config.verify_artifacts,
                # the fault seam exists only where a plan does
                corrupt_hook=(self._corrupt_payload_hook
                              if faults is not None else None),
                on_corrupt=self._note_corruption)
            self.allocator.attach_spill(self.spill, self._spill_payload)
        self.slots: List[Optional[_Slot]] = [None] * config.max_batch
        self.waiting = _WaitingQueue(weights=config.tenant_weights,
                                     quantum=config.drr_quantum)
        self._live_uids: set = set()    # every uid waiting or resident
        self.finished: Dict[str, List[int]] = {}
        self.statuses: Dict[str, str] = {}
        self._deadline: Dict[str, float] = {}   # uid -> absolute deadline
        self._arrival_count = 0
        self._admit_count = 0
        self._num_ticks = 0
        self._num_prefills = 0
        self._num_prefill_chunks = 0
        self._num_prefill_tokens = 0
        self._num_decode_dispatches = 0
        self._num_tokens_decoded = 0
        self._num_preemptions = 0
        self._num_cow_copies = 0
        self._prefix_hit_blocks = 0
        self._prefix_lookup_blocks = 0
        self._prompt_blocks_allocated = 0
        self._num_draft_tokens = 0
        self._num_accepted_tokens = 0
        self._num_spec_blocks_rolled_back = 0
        # -- overload --------------------------------------------------------
        self._num_timeouts = 0
        self._queue_depth_peak = 0
        self._queue_wait_count = 0
        self._queue_wait_ticks_sum = 0
        self._queue_wait_ticks_max = 0
        self._queue_wait_s_sum = 0.0
        self._queue_wait_s_max = 0.0
        self._num_rejected_queue_full = 0
        self._num_rejected_infeasible = 0
        # the feasibility gate's service-time EWMAs (None: not observed,
        # the gate is open)
        self._ewma_prefill_s: Optional[float] = None
        self._ewma_decode_s: Optional[float] = None
        # the degradation ladder: rung, the streaks of its hysteresis,
        # transitions
        self._degradation_level = 0
        self._pressure_streak = 0
        self._clear_streak = 0
        self._num_degrade_steps_down = 0
        self._num_degrade_steps_up = 0
        self._num_degrade_flushed_blocks = 0
        # -- tenancy ---------------------------------------------------------
        self._num_throttled = 0
        self._num_cancelled = 0
        # every tenant seen (listed tenants stay, others drop out when
        # idle), delivered tokens, the decayed token rate and its time,
        # terminal statuses, quota preemptions
        self._tenant_seen: set = {DEFAULT_TENANT}
        self._tenant_tokens: Dict[str, int] = {}
        self._tenant_rate: Dict[str, float] = {}
        self._tenant_rate_t: Dict[str, float] = {}
        self._tenant_status: Dict[str, Dict[str, int]] = {}
        self._tenant_preemptions: Dict[str, int] = {}
        # streaming: (uid, token, is_last) as tokens reach the host; every
        # terminal transition appends (uid, -1, True)
        self._stream: deque = deque()
        # spec_adapt: the per-plan draft cap, its acceptance EWMA, the
        # probe countdown while the cap is 0
        self._spec_cap = config.spec_tokens
        self._spec_accept_ewma: Optional[float] = None
        self._spec_probe_countdown = _SPEC_PROBE_EVERY
        self._num_spec_cap_shrinks = 0
        self._num_spec_cap_restores = 0
        # -- faults and recovery ----------------------------------------------
        # False once the drafter is quarantined (every later plan empty)
        self._drafter_ok = config.spec_tokens > 0
        self._num_dispatch_retries = 0
        self._num_quarantines = 0
        self._num_draft_retries = 0
        self._num_drafter_quarantines = 0
        self._num_snapshots = 0
        self._num_restores = 0
        self._num_checkpoints = 0
        self._num_corruptions_detected = 0
        self._num_import_refusals = 0
        self._fetch_failures = 0    # consecutive failed drains
        # -- migration: requests moved out and in, and the arrival index
        # each exported uid left with (the source's clean copy)
        self._num_migrated_in = 0
        self._num_migrated_out = 0
        self._exported_arrivals: Dict[str, int] = {}
        # the corruption seed of the in-flight dispatch (a "corrupt" fire
        # at "decode"), applied at its drain
        self._pending_corrupt: Optional[int] = None
        # the latest checkpoint() (every snapshot_interval_ticks ticks)
        self.last_checkpoint: Optional[Dict[str, object]] = None
        # the in-flight decode: (device [B, K] tokens, lanes, {lane: uid}),
        # fetched at the next tick's drain
        self._pending = None
        # the decode block table a batch group (local ids), rebuilt when
        # lanes change
        self._dev_tables: Optional[List[Optional[torch.Tensor]]] = None

    @property
    def cache(self):
        """The KV pool: a :class:`~apex_tpu_torch.serving.kv_cache.KVCache`
        on a one-shard mesh, else the :class:`~apex_tpu_torch.serving.
        kv_cache.ShardedKVCache`."""
        if self._batch_shards == 1 and self._model_axis == 1:
            return self._pools.shards[0][0]
        return self._pools

    # -- client surface ------------------------------------------------------

    def add_request(self, request: Request) -> int:
        """Validate, check the tenant's quota and the queue bound, and
        enqueue; returns the request's arrival index (its sampling
        identity). Raises :class:`TenantThrottledError` (the request
        ends ``"throttled"``) or :class:`QueueFullError` (it never
        entered)."""
        n = len(request.prompt)
        if n == 0:
            raise ValueError(f"request {request.uid!r}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.uid!r}: max_new_tokens must be >= 1 "
                f"(got {request.max_new_tokens}); prefill always samples "
                "the first token")
        if n + request.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"request {request.uid!r}: prompt + max_new_tokens "
                f"({n} + {request.max_new_tokens}) exceeds max_seq_len "
                f"({self.config.max_seq_len})")
        if request.deadline_s is not None and request.deadline_s <= 0:
            raise ValueError(
                f"request {request.uid!r}: deadline_s must be positive "
                f"(got {request.deadline_s})")
        if request.priority < 0:
            raise ValueError(
                f"request {request.uid!r}: priority must be >= 0 "
                f"(got {request.priority}); 0 is the most urgent class")
        if not isinstance(request.tenant, str) or not request.tenant:
            raise ValueError(
                f"request {request.uid!r}: tenant must be a non-empty "
                f"string (got {request.tenant!r})")
        request.sampling.validate()
        uid = request.uid
        if uid in self._live_uids:
            raise ValueError(
                f"request uid {uid!r} is already waiting or resident in "
                "this engine; drain it (run()) or pick a distinct uid")
        if uid in self.statuses:
            raise ValueError(
                f"request uid {uid!r} has a terminal result "
                f"({self.statuses[uid]!r}) awaiting drain; run() before "
                "reusing the uid, or pick a distinct one")
        object.__setattr__(request, "status", None)
        self._tenant_seen.add(request.tenant)
        reason = self._door_throttle_reason(request)
        if reason is not None:
            if self._obs is not None:
                self._obs.note_shed(uid, "throttled", queued=False)
            self.finished[uid] = []
            self._set_status(request, "throttled")
            self._num_throttled += 1
            raise TenantThrottledError(
                f"request {uid!r} throttled: tenant "
                f"{request.tenant!r} {reason}")
        if (self.config.max_waiting is not None
                and len(self.waiting) >= self.config.max_waiting):
            self._num_rejected_queue_full += 1
            if self._obs is not None:
                # the request never entered (no status), but the trace
                # shows the refusal
                self._obs.note_shed(uid, "queue_full", queued=False)
            raise QueueFullError(
                f"request {uid!r} rejected: waiting queue is at "
                f"max_waiting ({self.config.max_waiting})")
        self._live_uids.add(uid)
        if request.deadline_s is not None:
            self._deadline[uid] = self._clock() + request.deadline_s
        enq_t = self._clock()
        arrival = self._arrival_count
        self.waiting.append(_QueueEntry(request=request, arrival=arrival,
                                        enq_t=enq_t,
                                        enq_tick=self._num_ticks))
        if self._obs is not None:
            self._obs.note_enqueue(uid, tenant=request.tenant,
                                   priority=request.priority,
                                   prompt_len=n, t=enq_t)
        self._arrival_count += 1
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.waiting))
        return arrival

    def try_add(self, request: Request) -> bool:
        """:meth:`add_request` returning False where the queue bound or
        a tenant quota sheds the request (validation errors still
        raise)."""
        try:
            self.add_request(request)
        except (QueueFullError, TenantThrottledError):
            return False
        return True

    def abort(self, uid: str) -> bool:
        """Cancel a waiting or resident request: its queue entry or lane
        and blocks are released now and it ends ``"cancelled"`` with the
        tokens it emitted. A dispatch in flight over its lane is
        discarded at the drain (matched by uid). False for a uid the
        engine does not hold."""
        if uid not in self._live_uids:
            return False
        removed = self.waiting.expel(lambda e: e.request.uid == uid)
        if removed:
            entry = removed[0]
            self.finished[uid] = list(entry.generated)
            self._set_status(entry.request, "cancelled")
            self._num_cancelled += 1
            return True
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.uid == uid:
                self._finish(i, status="cancelled")
                self._num_cancelled += 1
                return True
        return False

    def pop_stream_events(self) -> List[Tuple[str, int, bool]]:
        """Drain the stream: ``(uid, token, is_last)`` in emission order
        (a prefill's first token when it is sampled, decode tokens at
        the drain), and one ``(uid, -1, True)`` at every terminal
        transition. ``run()`` drops what was not popped."""
        out = list(self._stream)
        self._stream.clear()
        return out

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or self._pending is not None
                or any(s is not None for s in self.slots))

    def run(self, return_status: bool = False):
        """Step until every request is terminal. Returns ``{uid:
        tokens}``, or ``{uid: RequestResult}`` with ``return_status``.
        Raises :class:`EngineStalledError` when a full step makes no
        progress while work remains; with an observer, an exception that
        escapes writes its crash dump first."""
        try:
            while self.has_work:
                if not self.step():
                    tail = None
                    if self._obs is not None:
                        self._obs.record("stall")
                        if self._obs.recorder is not None:
                            tail = self._obs.recorder.tail()
                    raise EngineStalledError(
                        "engine has work but a full step made no progress",
                        self.stats(), recorder_tail=tail)
        except Exception as e:
            if self._obs is not None:
                # the post-mortem; the exception goes on
                self._obs.crash_dump(e)
            raise
        out, self.finished = self.finished, {}
        statuses, self.statuses = self.statuses, {}
        self._stream.clear()
        if return_status:
            return {uid: RequestResult(tokens=toks,
                                       status=statuses.get(uid, "finished"))
                    for uid, toks in out.items()}
        return out

    def step(self) -> bool:
        """One tick: the ladder, expire deadlines, admit, one prefill
        chunk, drain the previous decode, expire and admit again, then
        dispatch one K-step decode over every started lane, and with
        ``scrub_interval_ticks`` a scrub, with ``snapshot_interval_ticks``
        a checkpoint. Returns whether
        anything progressed (a quarantine counts)."""
        self._num_ticks += 1
        pre_shed = self._num_rejected_infeasible
        stepped = self._update_ladder()
        # waiting entries and mid-prefill lanes expire up front; started
        # lanes only with no dispatch in flight over them
        expired = self._expire_deadlines(
            include_started=self._pending is None)
        admitted = self._admit()
        chunked = self._prefill_tick()
        synced = self._drain_decode()
        expired += self._expire_deadlines(include_started=True)
        if synced or expired:
            admitted += self._admit()
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.waiting))
        shed = self._num_rejected_infeasible - pre_shed
        made = bool(admitted or chunked or synced or expired or stepped
                    or shed)
        if all(s is None for s in self.slots):
            if self.waiting and not made:
                entry = self.waiting.head()
                need = blocks_needed(len(entry.request.prompt) + 1,
                                     self.config.block_size)
                if self._obs is not None:
                    self._obs.record("alloc_pressure",
                                     uid=entry.request.uid, need=need)
                raise CacheOutOfBlocks(
                    f"request {entry.request.uid!r} needs {need} blocks "
                    f"to admit but only {self.allocator.num_blocks} exist "
                    "in the pool")
            self._maybe_scrub()
            self._maybe_checkpoint()
            self._record_tick(admitted, chunked, synced, expired, shed,
                              made)
            return made
        pre_preempt = self._num_preemptions
        pre_quarantine = self._num_quarantines
        active = self._started_lanes()
        if active and self.config.spec_tokens > 0:
            # proposals first: they size each lane's span reservation
            self._build_draft_plan(active)
        if active:
            self._ensure_decode_blocks()
        active = self._started_lanes()
        if active:
            self._dispatch_decode(active)
        progressed = bool(made or self._pending is not None
                          or self._num_preemptions > pre_preempt
                          or self._num_quarantines > pre_quarantine)
        self._maybe_scrub()
        self._maybe_checkpoint()
        self._record_tick(admitted, chunked, synced, expired, shed,
                          progressed)
        return progressed

    def _maybe_checkpoint(self) -> None:
        """Every ``snapshot_interval_ticks``-th tick: :meth:`checkpoint`
        (which never drains) into ``last_checkpoint``."""
        interval = self.config.snapshot_interval_ticks
        if interval is not None and self._num_ticks % interval == 0:
            self.checkpoint()

    def _record_tick(self, admitted: int, chunked: bool, synced: bool,
                     expired: int, shed: int, progress: bool) -> None:
        """One flight-recorder ``tick`` summary a ``step()``, only with a
        recorder attached."""
        obs = self._obs
        if obs is None or obs.recorder is None:
            return
        obs.record(
            "tick", tick=self._num_ticks, admitted=int(admitted),
            chunked=bool(chunked), drained=bool(synced),
            expired=int(expired), shed=int(shed),
            progress=bool(progress),
            active=sum(s is not None for s in self.slots),
            waiting=len(self.waiting),
            blocks_free=self.allocator.num_free,
            level=self._degradation_level)

    def probe_prefix(self, hashes: Sequence[str]) -> int:
        """How many leading blocks of a chain this engine could serve
        without recompute: the device index's match extended by the run
        of hashes the spill tier holds (read only: no references, no LRU
        change)."""
        if not self.config.enable_prefix_caching:
            return 0
        n = len(self.allocator.lookup_prefix(hashes))
        if self.spill is not None:
            while n < len(hashes) and hashes[n] in self.spill:
                n += 1
        return n

    def spilled_hashes(self) -> Dict[str, str]:
        """Chain hash -> owning tenant of every entry in the spill tier
        (empty without one)."""
        if self.spill is None:
            return {}
        return self.spill.entry_tenants()

    @property
    def block_weight(self) -> float:
        """The ledger's charge a block (1.0 at full precision)."""
        return float(self._block_weight)

    def tenant_charge(self, tenant: str) -> float:
        """The tenant's resident-block charge (``block_weight`` units)."""
        return self.allocator.tenant_charge(tenant)

    def check_allocator_integrity(self) -> None:
        """The allocator's invariants, its refcounts (and their tenant
        split) exactly the resident lanes holding each block, and at batch
        axis ``B > 1`` every block on its lanes' shard (the local tables
        rely on it: a foreign block would read masked rows, not raise)."""
        expected: Dict[int, int] = {}
        expected_tenants: Dict[int, Dict[str, int]] = {}
        shards: Dict[int, int] = {}
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            t = slot.request.tenant
            for b in slot.blocks:
                expected[b] = expected.get(b, 0) + 1
                per = expected_tenants.setdefault(b, {})
                per[t] = per.get(t, 0) + 1
                # a block held across shards can match neither
                sh = self._lane_shard(i)
                shards[b] = sh if shards.get(b, sh) == sh else -1
        self.allocator.check_integrity(
            expected_refcounts=expected,
            expected_tenant_refs=expected_tenants,
            expected_shards=shards if self._batch_shards > 1 else None)

    # -- the mesh's collective audit ------------------------------------------

    def program_collective_stats(self, program: str) -> Dict[str, Dict]:
        """``{"all-reduce": {"ops", "bytes"}}``, the one collective kind
        the port runs: the sums across model shards in the newest forward
        of one batch group of ``program``: ``"prefill"``, ``"decode"`` or
        ``"verify"``
        (``"verify"`` insists speculation is on). The JAX engine lowers
        its programs from abstract arguments; the port has no compiler to
        ask, so it reads what its forwards did, and a program must have
        run once (``ValueError`` before)."""
        if program not in mesh_lib.PROGRAMS:
            raise ValueError(
                f"unknown program {program!r} (expected 'prefill', "
                "'decode', or 'verify')")
        if program == "verify" and self.config.spec_tokens < 1:
            raise ValueError(
                "program 'verify' requires spec_tokens >= 1 (the decode "
                "slot holds the plain scan otherwise)")
        stats = self._collectives.last.get(program)
        if stats is None:
            raise ValueError(
                f"program {program!r} has not run on this engine yet: the "
                "audit reads the sums its forwards counted")
        return {"all-reduce": dict(stats)}

    def audit_collectives(self) -> Dict[str, Dict[str, Dict]]:
        """Hold the prefill and the decode (or verify) program to the
        mesh's contract (:func:`~apex_tpu_torch.serving.mesh.
        expected_collectives`): no sum at model axis 1, at least ``2 *
        num_layers`` ``all-reduce`` a forward past it. Raises
        ``AssertionError`` on a violation; returns ``{program: stats}``."""
        contract = mesh_lib.expected_collectives(
            self.config.mesh_shape, num_layers=self.model.cfg.num_layers)
        exact = contract.get("exact_total_ops")
        floor = contract.get("min_ops", {}).get("all-reduce", 0)
        out = {}
        for prog in ("prefill",
                     "verify" if self.config.spec_tokens > 0 else "decode"):
            stats = self.program_collective_stats(prog)
            ops = stats["all-reduce"]["ops"]
            if (exact is not None and ops != exact) or ops < floor:
                raise AssertionError(
                    f"{prog}@mesh{tuple(self.config.mesh_shape)}: "
                    f"{ops} all-reduce a forward, the contract is "
                    f"{contract}")
            out[prog] = stats
        return out

    # -- the replica surface ---------------------------------------------------

    def pop_results(self) -> Dict[str, RequestResult]:
        """Every terminal result so far, without stepping: ``{uid:
        RequestResult}``; each drained uid becomes reusable, as after
        ``run()``. Stream events stay (:meth:`pop_stream_events`)."""
        out, self.finished = self.finished, {}
        statuses, self.statuses = self.statuses, {}
        return {uid: RequestResult(tokens=toks,
                                   status=statuses.get(uid, "finished"))
                for uid, toks in out.items()}

    def load(self) -> Dict[str, float]:
        """The cheap load signal a router polls (a float subset of
        ``stats()``): queue depth, active lanes, the service EWMAs and the
        allocatable blocks (free plus cached)."""
        return {
            "queue_depth": float(len(self.waiting)),
            "active_slots": float(sum(s is not None for s in self.slots)),
            "ewma_prefill_dispatch_s": float(self._ewma_prefill_s or 0.0),
            "ewma_decode_dispatch_s": float(self._ewma_decode_s or 0.0),
            "blocks_allocatable": float(self.allocator.num_free
                                        + self.allocator.num_cached),
        }

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active_slot_count(self) -> int:
        return sum(s is not None for s in self.slots)

    def tenant_depth(self, tenant: str) -> int:
        """The tenant's waiting entries."""
        return self.waiting.tenant_depth(tenant)

    def decoding_uids(self) -> List[str]:
        """Uids of the resident lanes whose prefill has completed (first
        token known), in admission order."""
        started = [(s.admit_seq, s.request.uid) for s in self.slots
                   if s is not None and s.started]
        return [uid for _, uid in sorted(started)]

    # -- migration ---------------------------------------------------------------

    def export_requests(self, uids: Optional[Sequence[str]] = None
                        ) -> List[Dict]:
        """Remove the given waiting and resident requests (all of them
        with ``uids`` None) and return them as sealed snapshot-format
        records that :meth:`import_requests` resumes on another engine.
        The decode in flight is drained first (one host sync), so the
        records carry every emitted token; a resident's blocks are
        released deepest first (cached under prefix caching), and its
        deadline travels as the time remaining. Terminal requests awaiting
        :meth:`pop_results` stay. Each record fires the plan at
        ``"export"`` (one fire a record) after it is sealed. The records
        keep the arrival index, so an engine of the same model and seed
        continues the token stream, at any mesh shape."""
        self._drain_decode()
        want = None if uids is None else {str(u) for u in uids}
        now = self._clock()
        records: List[Dict] = []
        live = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                      if s is not None)
        for _, i in live:
            slot = self.slots[i]
            if want is not None and slot.request.uid not in want:
                continue
            records.append(self._entry_record(
                _QueueEntry(request=slot.request, arrival=slot.entry.arrival,
                            generated=self._resume_tokens(slot),
                            drr_charged=True), now))
            self.allocator.free(list(reversed(slot.blocks)),
                                tenant=slot.request.tenant)
            self.slots[i] = None
            self._invalidate_lanes()
            self._release_exported(slot.request)
        for entry in self.waiting.expel(
                lambda e: want is None or e.request.uid in want):
            records.append(self._entry_record(entry, now))
            self._release_exported(entry.request)
        # the clean arrival index, kept before the fault site can touch
        # the caller's copy
        for rec in records:
            self._exported_arrivals[str(rec["uid"])] = int(rec["arrival"])
        records = [self._maybe_corrupt_record("export", seal_record(rec))
                   for rec in records]
        self._num_migrated_out += len(records)
        return records

    def drop_stream_events(self, uid: str) -> int:
        """Discard the undrained stream events of ``uid`` (a re-injected
        request re-emits them); returns how many."""
        uid = str(uid)
        before = len(self._stream)
        self._stream = deque(ev for ev in self._stream if ev[0] != uid)
        return before - len(self._stream)

    def exported_arrival(self, uid: str) -> Optional[int]:
        """The arrival index this engine last exported ``uid`` with
        (None if it never left by :meth:`export_requests`)."""
        v = self._exported_arrivals.get(str(uid))
        return None if v is None else int(v)

    def _release_exported(self, request: Request) -> None:
        """Forget an exported request without a terminal transition: it
        lives on in another engine (no status, no stream sentinel)."""
        self._live_uids.discard(request.uid)
        self._deadline.pop(request.uid, None)
        self._prune_tenant_if_idle(request.tenant)

    def import_requests(self, records: Sequence[Dict]) -> int:
        """Enqueue records another engine exported (or checkpointed).
        Each keeps its arrival index (``_arrival_count`` moves past it)
        and its DRR standing: an exported resident re-admits ahead of the
        walk, as a preemption requeue does; a record without ``arrival``
        takes a fresh one. Deadlines re-anchor on this clock. No door
        quota is applied: the request was accepted at its first door.
        Each record fires the plan at ``"import"``. Raises, before
        touching anything, ``ValueError`` for a uid live or awaiting drain
        here and, with ``verify_artifacts``, ``IntegrityError`` for a
        sealed record whose checksum fails (counted in
        ``num_import_refusals``); an unsealed record imports as it is.
        Returns how many were enqueued."""
        now = self._clock()
        if self.faults is not None:
            records = [self._maybe_corrupt_record("import", rec)
                       for rec in records]
        for rec in records:
            if self.config.verify_artifacts:
                try:
                    verify_record(rec, "import")
                except IntegrityError as e:
                    self._num_import_refusals += 1
                    self._note_corruption("import", e.detail)
                    raise
            uid = rec["uid"]
            if uid in self._live_uids:
                raise ValueError(
                    f"cannot import uid {uid!r}: already waiting or "
                    "resident in this engine")
            if uid in self.statuses:
                raise ValueError(
                    f"cannot import uid {uid!r}: a terminal result "
                    "awaits drain here")
        for rec in records:
            deadline = rec.get("deadline_remaining_s")
            req = Request(
                uid=rec["uid"], prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                sampling=SamplingParams(
                    temperature=rec["sampling"]["temperature"],
                    top_k=rec["sampling"]["top_k"],
                    top_p=rec["sampling"]["top_p"]),
                eos_token_id=rec.get("eos_token_id"),
                deadline_s=deadline,
                priority=int(rec.get("priority", 0)),
                tenant=str(rec.get("tenant", DEFAULT_TENANT)))
            if deadline is not None:
                # a blown deadline stays blown
                self._deadline[req.uid] = now + float(deadline)
            arrival = rec.get("arrival")
            arrival = self._arrival_count if arrival is None else int(arrival)
            self._arrival_count = max(self._arrival_count, arrival + 1)
            # the uid lives here now: an export stamp of ours is stale
            self._exported_arrivals.pop(req.uid, None)
            self._live_uids.add(req.uid)
            self._tenant_seen.add(req.tenant)
            self.waiting.append(_QueueEntry(
                request=req, arrival=arrival,
                generated=[int(t) for t in rec.get("generated", ())],
                enq_t=now, enq_tick=self._num_ticks,
                drr_charged=bool(rec.get("drr_charged", False))))
            if self._obs is not None:
                # a requeue, as restore() anchors its records: the submit
                # time belongs to the source
                self._obs.note_enqueue(req.uid, tenant=req.tenant,
                                       priority=req.priority,
                                       prompt_len=len(req.prompt),
                                       requeue=True, t=now)
        self._num_migrated_in += len(records)
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.waiting))
        return len(records)

    def export_prefix_payloads(self, hashes: Sequence[str]
                               ) -> Dict[str, Dict]:
        """The leading run of a chain as host payloads (the KV transport
        between engines): device-indexed blocks read as the spill fetch
        reads them (full-head, layout-free), spilled ones copied out of
        the store. Stops at the first hash served by neither, or whose
        spilled copy fails its checksum. Unlike the JAX engine's, a failed
        device read is not taken for a miss: it raises (ROADMAP C8, C9).
        With ``verify_artifacts`` each payload carries a ``"checksum"``
        string the importer verifies."""
        out: Dict[str, Dict] = {}
        if not self.config.enable_prefix_caching:
            return out
        for h in hashes:
            b = self.allocator.indexed_block(h)
            if b is not None:
                payload = self._spill_payload(b, record=False)
            elif self.spill is not None:
                payload = self.spill.export_entry(h)
            else:
                payload = None
            if payload is None:
                break
            if self.config.verify_artifacts:
                payload = dict(payload)
                payload["checksum"] = payload_checksum(payload)
            out[h] = payload
        return out

    def import_prefix_payloads(self, payloads: Mapping[str, Dict]) -> int:
        """Seed the spill tier with another engine's payloads: the next
        admission matching those hashes uploads them instead of
        recomputing. Hashes a device block already serves are skipped; a
        payload whose ``"checksum"`` fails is skipped and counted (a
        recompute, not a refusal). Returns how many entries the tier took
        (0 without a spill tier)."""
        if self.spill is None:
            return 0
        n = 0
        for h, payload in payloads.items():
            if self.allocator.indexed_block(h) is not None:
                continue
            payload = dict(payload)
            checksum = payload.pop("checksum", None)
            if self.config.verify_artifacts and checksum is not None:
                try:
                    verify_payload(payload, checksum, "import_payload")
                except IntegrityError as e:
                    self._note_corruption("import_payload", e.detail)
                    continue
            if self.spill.import_entry(h, payload):
                n += 1
        return n

    def stats(self, deep: bool = False) -> Dict[str, object]:
        """The engine's counters; ``deep`` adds the observer's section
        (``"observability"``: metric values, recorder and trace depth)
        when one is attached."""
        alloc = self.allocator
        spill = self.spill
        lookups = self._prefix_lookup_blocks
        drafted = self._num_draft_tokens
        waits = self._queue_wait_count
        spill_lookups = self._spill_hits + self._spill_misses
        out = {
            # the mesh, static per config as in the JAX engine
            "mesh_devices": (self.config.mesh_shape[0]
                             * self.config.mesh_shape[1]),
            "mesh_model_axis": self.config.mesh_shape[1],
            "mesh_batch_axis": self.config.mesh_shape[0],
            "kv_quantization": self.config.kv_quantization,
            "weight_quantization": self.config.weight_quantization,
            "num_ticks": self._num_ticks,
            "num_prefills": self._num_prefills,
            "num_prefill_chunks": self._num_prefill_chunks,
            "num_prefill_tokens": self._num_prefill_tokens,
            "num_decode_dispatches": self._num_decode_dispatches,
            "num_tokens_decoded": self._num_tokens_decoded,
            "num_preemptions": self._num_preemptions,
            "active_slots": sum(s is not None for s in self.slots),
            "waiting": len(self.waiting),
            "queue_depth": len(self.waiting),
            # prefix caching: blocks served from the index at admission
            # out of the full prompt blocks looked up, copy-on-write
            # copies, and the allocator's cached and evicted blocks
            "num_cow_copies": self._num_cow_copies,
            "num_cache_evictions": alloc.num_evictions,
            "blocks_free": alloc.num_free,
            "blocks_cached": alloc.num_cached,
            "blocks_active": alloc.num_used,
            "cache_utilization": alloc.utilization,
            "prefix_lookup_blocks": lookups,
            "prefix_hit_blocks": self._prefix_hit_blocks,
            "prefix_cache_hit_rate": (self._prefix_hit_blocks / lookups
                                      if lookups else 0.0),
            "prompt_blocks_allocated": self._prompt_blocks_allocated,
            # the spill tier: residency, traffic, re-admissions by block
            # (`is not None`: an empty store is falsy)
            "spill_blocks": len(spill) if spill is not None else 0,
            "spill_bytes": spill.total_bytes if spill is not None else 0,
            "num_blocks_spilled": spill.puts if spill is not None else 0,
            "num_spill_evictions": (spill.evictions if spill is not None
                                    else 0),
            "spill_hits": self._spill_hits,
            "spill_misses": self._spill_misses,
            "spill_hit_rate": (self._spill_hits / spill_lookups
                               if spill_lookups else 0.0),
            "num_spill_refused": spill.refused if spill is not None else 0,
            "num_spill_corrupt_discards": (spill.corrupt_discards
                                           if spill is not None else 0),
            "num_scrubs": self._num_scrubs,
            "num_scrub_blocks_verified": self._num_scrub_blocks_verified,
            # overload: deadlines, queue depth and wait, sheds, the
            # service EWMAs and the ladder
            "num_timeouts": self._num_timeouts,
            "queue_depth_peak": self._queue_depth_peak,
            "queue_wait_mean_ticks": (self._queue_wait_ticks_sum / waits
                                      if waits else 0.0),
            "queue_wait_max_ticks": self._queue_wait_ticks_max,
            "queue_wait_mean_s": (self._queue_wait_s_sum / waits
                                  if waits else 0.0),
            "queue_wait_max_s": self._queue_wait_s_max,
            "num_rejected_queue_full": self._num_rejected_queue_full,
            "num_rejected_infeasible": self._num_rejected_infeasible,
            "ewma_prefill_dispatch_s": float(self._ewma_prefill_s or 0.0),
            "ewma_decode_dispatch_s": float(self._ewma_decode_s or 0.0),
            "degradation_level": self._degradation_level,
            "num_degrade_steps_down": self._num_degrade_steps_down,
            "num_degrade_steps_up": self._num_degrade_steps_up,
            "num_degrade_flushed_blocks": self._num_degrade_flushed_blocks,
            "admission_paused": int(
                self._admission_priority_limit() is not None),
            # speculative decoding: proposals verified and accepted, span
            # blocks returned by the rollback, and spec_adapt's cap
            "num_draft_tokens": drafted,
            "num_accepted_tokens": self._num_accepted_tokens,
            "draft_acceptance_rate": (self._num_accepted_tokens / drafted
                                      if drafted else 0.0),
            "num_draft_retries": self._num_draft_retries,
            "num_drafter_quarantines": self._num_drafter_quarantines,
            "num_spec_blocks_rolled_back":
                self._num_spec_blocks_rolled_back,
            # 0 once the drafter is quarantined, or while the ladder
            # suspends speculation
            "speculation_active": int(self._drafter_ok
                                      and self._degradation_level < 1),
            "spec_cap": self._spec_cap,
            "spec_accept_ewma": float(self._spec_accept_ewma or 0.0),
            "num_spec_cap_shrinks": self._num_spec_cap_shrinks,
            "num_spec_cap_restores": self._num_spec_cap_restores,
            # tenancy: sheds, cancellations, the stream backlog, the ledger
            "num_throttled": self._num_throttled,
            "num_cancelled": self._num_cancelled,
            "stream_backlog": len(self._stream),
            "tenants": self._tenant_section(),
            # faults and recovery: retries, quarantines, snapshots,
            # checkpoints, restores and detected corruptions
            "num_dispatch_retries": self._num_dispatch_retries,
            "num_quarantines": self._num_quarantines,
            "num_snapshots": self._num_snapshots,
            "num_restores": self._num_restores,
            "num_checkpoints": self._num_checkpoints,
            "num_corruptions_detected": self._num_corruptions_detected,
            "num_import_refusals": self._num_import_refusals,
            # migration: requests moved out and in
            "num_migrated_in": self._num_migrated_in,
            "num_migrated_out": self._num_migrated_out,
            "weight_bytes": self._weight_bytes,
            "kv_pool_bytes": self._pools.nbytes,
            # the serving path's kernels (the counters also hold training's)
            "kernel_launches": {k: _build.launches[k]
                                for k in ("paged_read", "dequant_gemm",
                                          "kv_quant_write")},
        }
        if deep and self._obs is not None:
            out["observability"] = self._obs.deep_stats()
        return out

    def _tenant_section(self) -> Dict[str, Dict[str, object]]:
        """``stats()["tenants"]``: a row a tenant seen (or holding
        blocks): delivered tokens, the decayed rate, queue and residency
        footprint, the eviction and flush attribution, quota
        preemptions, terminal statuses."""
        alloc_ts = self.allocator.tenant_stats()
        out: Dict[str, Dict[str, object]] = {}
        for t in sorted(self._tenant_seen | set(alloc_ts)):
            a = alloc_ts.get(t, {})
            out[t] = {
                "tokens": self._tenant_tokens.get(t, 0),
                "rate_tokens_per_s": round(self._tenant_rate_now(t), 6),
                "waiting": self.waiting.tenant_depth(t),
                "resident_slots": sum(
                    1 for s in self.slots
                    if s is not None and s.request.tenant == t),
                "resident_block_charge":
                    a.get("resident_block_charge", 0.0),
                "cached_blocks": a.get("cached_blocks", 0),
                "evicted_blocks": a.get("evicted_blocks", 0),
                "flushed_blocks": a.get("flushed_blocks", 0),
                "quota_preemptions": self._tenant_preemptions.get(t, 0),
                "statuses": dict(self._tenant_status.get(t, {})),
            }
        return out

    # -- snapshot / checkpoint / restore ---------------------------------------

    def _config_fingerprint(self) -> Dict[str, object]:
        """The config as JSON-able values: a snapshot restores only into
        an engine of the same fingerprint. The operational knobs (retries,
        overload, tenancy, ``spec_adapt``, the spill tier, the checkpoint
        and scrub cadences, verification) change no token and stay out, so
        a restore into a bigger queue, retry budget or spill bound works; ``kv_dtype`` is the dtype's
        plain name (``"float32"``, ``"bfloat16"``)."""
        d = {f.name: getattr(self.config, f.name)
             for f in dataclasses.fields(self.config)}
        d["kv_dtype"] = (None if self.config.kv_dtype is None
                         else str(self.config.kv_dtype).replace("torch.",
                                                                ""))
        # a sharded snapshot restores across equal meshes only
        d["mesh_shape"] = [int(v) for v in self.config.mesh_shape]
        for knob in ("max_dispatch_retries", "retry_backoff_s",
                     "max_waiting", "queue_high_watermark",
                     "free_block_low_watermark", "degrade_patience",
                     "degrade_admit_priority",
                     "tenant_weights", "tenant_quotas", "drr_quantum",
                     "tenant_rate_tau_s", "spill_max_bytes",
                     "spec_adapt", "spec_accept_low", "spec_accept_high",
                     "snapshot_interval_ticks", "verify_artifacts",
                     "scrub_interval_ticks", "scrub_spill_blocks"):
            d.pop(knob, None)
        return d

    def _entry_record(self, entry: _QueueEntry, now: float) -> Dict:
        """One unfinished request as JSON: the request, its arrival index
        (its sampling identity), its emitted tokens, and its deadline as
        the time remaining."""
        req = entry.request
        rec = {
            "uid": req.uid,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": (None if req.eos_token_id is None
                             else int(req.eos_token_id)),
            "sampling": {"temperature": float(req.sampling.temperature),
                         "top_k": int(req.sampling.top_k),
                         "top_p": float(req.sampling.top_p)},
            "arrival": int(entry.arrival),
            "priority": int(req.priority),
            "tenant": str(req.tenant),
            "drr_charged": bool(entry.drr_charged),
            "generated": [int(t) for t in entry.generated],
        }
        dl = self._deadline.get(req.uid)
        if dl is not None:
            rec["deadline_remaining_s"] = float(dl - now)
        return rec

    def snapshot(self) -> Dict[str, object]:
        """A sealed, JSON-serializable picture of the engine, taken after
        draining the in-flight decode (one host sync), so no emitted
        token is lost at its boundary. Resident lanes serialize as
        resumable entries (prompt, emitted tokens, arrival index) in
        admission order, ahead of the waiting queue. The block tables, the
        allocator, the spill tier's counters and the observer's recorder
        tail ride along for audit only: KV contents do not survive a
        process, and :meth:`restore` re-prefills them."""
        self._drain_decode()
        self._num_snapshots += 1
        snap = self._build_snapshot()
        if self._obs is not None:
            self._obs.record("snapshot", requests=len(snap["requests"]))
        return snap

    def checkpoint(self) -> Dict[str, object]:
        """:meth:`snapshot` without the drain (no host sync): the tokens
        of the dispatch in flight are absent and re-derived on restore.
        Fires the plan at site ``"checkpoint"``, where a ``"corrupt"``
        fire perturbs the sealed record. Stored on ``last_checkpoint``
        and returned."""
        self._num_checkpoints += 1
        snap = self._build_snapshot(lightweight=True)
        snap = self._maybe_corrupt_record("checkpoint", snap)
        self.last_checkpoint = snap
        if self._obs is not None:
            self._obs.record("snapshot", requests=len(snap["requests"]),
                             lightweight=True)
        return snap

    def _build_snapshot(self, lightweight: bool = False
                        ) -> Dict[str, object]:
        """The body of both: host reads only, sealed last."""
        now = self._clock()
        live = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                      if s is not None)
        requests = []
        for _, i in live:
            slot = self.slots[i]
            requests.append(self._entry_record(
                _QueueEntry(request=slot.request, arrival=slot.entry.arrival,
                            generated=self._resume_tokens(slot),
                            # its DRR cost was paid at admission
                            drr_charged=True), now))
        for entry in self.waiting:
            requests.append(self._entry_record(entry, now))
        snap = {
            "version": 1,
            "config": self._config_fingerprint(),
            "arrival_count": int(self._arrival_count),
            "requests": requests,
            "finished": {uid: [int(t) for t in toks]
                         for uid, toks in self.finished.items()},
            "statuses": dict(self.statuses),
            "counters": self.stats(),
            # a quarantined drafter stays quarantined across a restore
            "drafter_ok": bool(self._drafter_ok),
            # the ladder with its streaks, the gate's EWMAs and the
            # spec_adapt walk continue where they were
            "overload": {
                "degradation_level": int(self._degradation_level),
                "pressure_streak": int(self._pressure_streak),
                "clear_streak": int(self._clear_streak),
                "ewma_prefill_s": self._ewma_prefill_s,
                "ewma_decode_s": self._ewma_decode_s,
                "spec_cap": int(self._spec_cap),
                "spec_accept_ewma": self._spec_accept_ewma,
                "spec_probe_countdown": int(self._spec_probe_countdown),
            },
            # the DRR walk state, the token-rate estimators (ages, which
            # re-anchor on the restoring clock) and the tallies
            "tenancy": {
                "classes": self.waiting.snapshot_state(),
                "rates": {t: {"rate": float(r),
                              "age_s": float(now - self._tenant_rate_t[t])}
                          for t, r in self._tenant_rate.items()},
                "tokens": {t: int(n)
                           for t, n in self._tenant_tokens.items()},
                "status_counts": {t: dict(c) for t, c in
                                  self._tenant_status.items()},
                "preemptions": dict(self._tenant_preemptions),
                "seen": sorted(self._tenant_seen),
            },
            "block_tables": {
                self.slots[i].request.uid: [int(b) for b in
                                            self.slots[i].blocks]
                for _, i in live},
            "allocator": self.allocator.snapshot_state(),
        }
        if self.spill is not None:
            # audit only, as the allocator section: spilled bytes do not
            # ride a snapshot, and a restored engine starts with an empty
            # tier (restore never reads this)
            snap["spill"] = dict(self.spill.stats(), audit_only=True,
                                 hits=int(self._spill_hits),
                                 misses=int(self._spill_misses),
                                 scrub_cursor=int(
                                     self.spill._scrub_cursor))
        if self._obs is not None:
            # audit only: the recorder tail and trace depth for a
            # post-mortem; restore never reads observer state
            audit = {"audit_only": True}
            if self._obs.recorder is not None:
                audit["recorder_tail"] = self._obs.recorder.tail()
                audit["recorder_dropped"] = self._obs.recorder.dropped
            if self._obs.tracer is not None:
                audit["trace_events"] = len(self._obs.tracer)
            snap["observability"] = audit
        if lightweight:
            snap["lightweight"] = True
        return seal_record(snap)

    def _maybe_corrupt_record(self, site: str, rec: Dict) -> Dict:
        """Fire the plan at a record site and, on a ``"corrupt"`` hit,
        perturb the sealed record (its checksum goes stale)."""
        if self.faults is None:
            return rec
        self.faults.fire(site)
        seed = self.faults.corrupt_seed(site)
        if seed is None:
            return rec
        return perturb_json(rec, seed)

    def restore(self, snap: Dict[str, object]) -> None:
        """Load a :meth:`snapshot` or :meth:`checkpoint` into a FRESH
        engine of the same model and config. With ``verify_artifacts`` a
        sealed snapshot must verify first (``IntegrityError``, counted in
        ``num_corruptions_detected``; an unsealed one loads). Then the
        version, the config fingerprint and freshness are checked, and
        every unfinished request re-enters the queue in snapshot order
        with its arrival index and emitted tokens: re-admission
        re-prefills ``prompt + generated[:-1]``, and the arrival-keyed
        sampler continues the uninterrupted run's tokens."""
        if self.config.verify_artifacts:
            try:
                verify_record(snap, "restore")
            except IntegrityError as e:
                self._note_corruption("restore", e.detail)
                raise
        if snap.get("version") != 1:
            raise ValueError(
                f"unknown snapshot version {snap.get('version')!r}")
        mine, theirs = self._config_fingerprint(), dict(snap["config"])
        diff = {k: (theirs.get(k), mine.get(k))
                for k in set(mine) | set(theirs)
                if mine.get(k) != theirs.get(k)}
        if diff:
            raise ValueError(
                f"snapshot config mismatch (snapshot vs engine): {diff}")
        if self.has_work or self._arrival_count or self.finished:
            raise RuntimeError(
                "restore() requires a fresh engine: this one has queued, "
                "resident, in-flight, or finished requests")
        now = self._clock()
        for rec in snap["requests"]:
            deadline = rec.get("deadline_remaining_s")
            req = Request(
                uid=rec["uid"], prompt=list(rec["prompt"]),
                max_new_tokens=int(rec["max_new_tokens"]),
                sampling=SamplingParams(
                    temperature=rec["sampling"]["temperature"],
                    top_k=rec["sampling"]["top_k"],
                    top_p=rec["sampling"]["top_p"]),
                eos_token_id=rec.get("eos_token_id"),
                deadline_s=deadline,
                priority=int(rec.get("priority", 0)),
                tenant=str(rec.get("tenant", DEFAULT_TENANT)))
            if deadline is not None:
                # a blown deadline stays blown
                self._deadline[req.uid] = now + deadline
            self._live_uids.add(req.uid)
            self._tenant_seen.add(req.tenant)
            self.waiting.append(_QueueEntry(
                request=req, arrival=int(rec["arrival"]),
                generated=[int(t) for t in rec["generated"]],
                enq_t=now, enq_tick=self._num_ticks,
                drr_charged=bool(rec.get("drr_charged", False))))
            if self._obs is not None:
                # a requeue, not an enqueue: its submit time belongs to
                # the process that took the snapshot
                self._obs.note_enqueue(req.uid, tenant=req.tenant,
                                       priority=req.priority,
                                       prompt_len=len(req.prompt),
                                       requeue=True, t=now)
        self._arrival_count = int(snap["arrival_count"])
        self.finished.update({uid: [int(t) for t in toks]
                              for uid, toks in snap["finished"].items()})
        self.statuses.update(snap["statuses"])
        self._drafter_ok = (bool(snap["drafter_ok"])
                            and self.config.spec_tokens > 0)
        # the ladder resumes only where this engine has one (else its rung
        # could never climb back)
        overload = snap.get("overload", {})
        if self._ladder_enabled():
            self._degradation_level = int(
                overload.get("degradation_level", 0))
            self._pressure_streak = int(overload.get("pressure_streak", 0))
            self._clear_streak = int(overload.get("clear_streak", 0))
        for attr, key in (("_ewma_prefill_s", "ewma_prefill_s"),
                          ("_ewma_decode_s", "ewma_decode_s")):
            v = overload.get(key)
            if v is not None:
                setattr(self, attr, float(v))
        if self.config.spec_adapt:
            self._spec_cap = int(overload.get("spec_cap",
                                              self.config.spec_tokens))
            ewma = overload.get("spec_accept_ewma")
            if ewma is not None:
                self._spec_accept_ewma = float(ewma)
            self._spec_probe_countdown = int(
                overload.get("spec_probe_countdown", _SPEC_PROBE_EVERY))
        tenancy = snap.get("tenancy", {})
        self.waiting.restore_state(tenancy.get("classes", {}))
        for t, rec in (tenancy.get("rates") or {}).items():
            self._tenant_rate[t] = float(rec["rate"])
            self._tenant_rate_t[t] = now - max(0.0, float(rec["age_s"]))
        for t, n in (tenancy.get("tokens") or {}).items():
            self._tenant_tokens[t] = int(n)
        for t, counts in (tenancy.get("status_counts") or {}).items():
            self._tenant_status[t] = {s: int(c)
                                      for s, c in counts.items()}
        for t, n in (tenancy.get("preemptions") or {}).items():
            self._tenant_preemptions[t] = int(n)
        self._tenant_seen.update(tenancy.get("seen", ()))
        self._num_restores += 1
        if self._obs is not None:
            self._obs.record("restore", requests=len(snap["requests"]))

    # -- the tenant ledger ---------------------------------------------------

    def _tenant_quota(self, tenant: str) -> Optional[TenantQuota]:
        quotas = self.config.tenant_quotas
        return None if quotas is None else quotas.get(tenant)

    def _tenant_rate_now(self, tenant: str) -> float:
        """The tenant's token rate decayed to now."""
        r = self._tenant_rate.get(tenant, 0.0)
        if r == 0.0:
            return 0.0
        dt = max(0.0, self._clock() - self._tenant_rate_t[tenant])
        return r * math.exp(-dt / self.config.tenant_rate_tau_s)

    def _note_tenant_tokens(self, tenant: str, n: int) -> None:
        """Count ``n`` delivered tokens: the total and the decayed rate
        (each token adds ``1 / tau``, so a steady rate R settles at R)."""
        self._tenant_tokens[tenant] = \
            self._tenant_tokens.get(tenant, 0) + n
        now = self._clock()
        tau = self.config.tenant_rate_tau_s
        r = self._tenant_rate.get(tenant, 0.0)
        if r:
            dt = max(0.0, now - self._tenant_rate_t[tenant])
            r *= math.exp(-dt / tau)
        self._tenant_rate[tenant] = r + n / tau
        self._tenant_rate_t[tenant] = now

    def _door_throttle_reason(self, request: Request) -> Optional[str]:
        """Why the tenant's quota sheds this submission, or None; read
        before the request touches the queue or the pool."""
        q = self._tenant_quota(request.tenant)
        if q is None:
            return None
        if q.max_resident_blocks is not None:
            # its worst case in block_weight units
            worst = self._block_weight * blocks_needed(
                len(request.prompt) + request.max_new_tokens,
                self.config.block_size)
            if worst > q.max_resident_blocks + 1e-9:
                return (f"needs up to {worst:g} block-units but is "
                        f"capped at max_resident_blocks="
                        f"{q.max_resident_blocks} (it could never run)")
        if (q.max_waiting is not None
                and self.waiting.tenant_depth(request.tenant)
                >= q.max_waiting):
            return (f"already holds {q.max_waiting} waiting entries "
                    f"(max_waiting)")
        if q.tokens_per_s is not None:
            rate = self._tenant_rate_now(request.tenant)
            if rate > q.tokens_per_s:
                return (f"is over its token-rate budget "
                        f"({rate:.1f} > {q.tokens_per_s} tokens/s)")
        return None

    def _tenant_has_resident(self, tenant: str) -> bool:
        return any(s is not None and s.request.tenant == tenant
                   for s in self.slots)

    def _tenant_is_listed(self, tenant: str) -> bool:
        return (tenant == DEFAULT_TENANT
                or tenant in (self.config.tenant_weights or {})
                or tenant in (self.config.tenant_quotas or {}))

    def _prune_tenant_if_idle(self, tenant: str) -> None:
        """Drop an unlisted tenant's ledger rows once it holds nothing
        waiting or resident, so fresh tenant ids cannot grow them without
        bound."""
        if self._tenant_is_listed(tenant):
            return
        if (self.waiting.tenant_depth(tenant)
                or self._tenant_has_resident(tenant)):
            return
        self._tenant_seen.discard(tenant)
        self._tenant_tokens.pop(tenant, None)
        self._tenant_rate.pop(tenant, None)
        self._tenant_rate_t.pop(tenant, None)
        self._tenant_status.pop(tenant, None)
        self._tenant_preemptions.pop(tenant, None)

    # -- lifecycle -----------------------------------------------------------

    def _set_status(self, request: Request, status: str,
                    lane: Optional[int] = None) -> None:
        """Every terminal transition: the drainable status, the request's
        own field, the deadline and live sets, the tenant's tally, the
        stream's terminal event and the observer's (``lane``: the lane it
        left, None from the queue)."""
        self.statuses[request.uid] = status
        object.__setattr__(request, "status", status)
        self._deadline.pop(request.uid, None)
        self._live_uids.discard(request.uid)
        tally = self._tenant_status.setdefault(request.tenant, {})
        tally[status] = tally.get(status, 0) + 1
        self._stream.append((request.uid, -1, True))
        if self._obs is not None:
            self._obs.note_terminal(request.uid, status, lane=lane)
        self._prune_tenant_if_idle(request.tenant)

    def _yield_key(self, idx: int):
        """Preemption order: the lowest class first (largest value), then
        the youngest; ``max()`` picks the victim."""
        slot = self.slots[idx]
        return (slot.request.priority, slot.admit_seq, idx)

    @staticmethod
    def _resume_tokens(slot: _Slot) -> List[int]:
        """The tokens a request carries out of its lane: a started lane's
        ``generated``, else its queue entry's history."""
        return (list(slot.generated) if slot.started
                else list(slot.entry.generated))

    def _expire_deadlines(self, include_started: bool) -> int:
        """End every request past its deadline ``"timeout"`` with its
        tokens: waiting entries and mid-prefill lanes at any time,
        started lanes only when ``include_started`` (no dispatch in
        flight over them)."""
        if not self._deadline:
            return 0
        now = self._clock()
        due = {uid for uid, dl in self._deadline.items() if now >= dl}
        if not due:
            return 0
        expired = 0
        if self.waiting:
            for entry in self.waiting.expel(
                    lambda e: e.request.uid in due):
                self.finished[entry.request.uid] = list(entry.generated)
                self._set_status(entry.request, "timeout")
                self._num_timeouts += 1
                expired += 1
        for i, slot in enumerate(self.slots):
            if slot is None or (slot.started and not include_started):
                continue
            if slot.request.uid in due:
                self._finish(i, status="timeout")
                self._num_timeouts += 1
                expired += 1
        return expired

    @staticmethod
    def _ewma_update(prev: Optional[float], dt: float) -> float:
        dt = max(0.0, float(dt))
        return dt if prev is None else (1.0 - _EWMA_ALPHA) * prev \
            + _EWMA_ALPHA * dt

    # -- scheduling ----------------------------------------------------------

    def _started_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.started]

    def _invalidate_lanes(self) -> None:
        self._dev_tables = None

    def _admission_priority_limit(self) -> Optional[int]:
        """Rung 3's pause: classes >= ``degrade_admit_priority`` wait,
        unless nothing more urgent is resident or waiting (an otherwise
        idle engine serves what it has)."""
        if self._degradation_level < 3:
            return None
        limit = self.config.degrade_admit_priority
        if (any(s is not None for s in self.slots)
                or self.waiting.has_priority_below(limit)):
            return limit
        return None

    def _estimate_service_s(self, prompt_tail: int, remaining: int,
                            skips_prefill: bool = False) -> Optional[float]:
        """A contention-free lower bound on serving a request: its
        uncached prompt's chunks at the prefill EWMA plus its decode
        dispatches at the decode EWMA (one token a dispatch speculating,
        ``decode_steps`` otherwise). None before any observation."""
        pf, dc = self._ewma_prefill_s, self._ewma_decode_s
        if pf is None and dc is None:
            return None
        if skips_prefill and prompt_tail <= 0:
            chunks = 0
        else:
            chunks = max(1, -(-max(prompt_tail, 0) // self.config.chunk))
        per = 1 if self.config.spec_tokens > 0 else self.config.decode_steps
        dispatches = -(-max(remaining, 0) // per)
        return chunks * (pf or 0.0) + dispatches * (dc or 0.0)

    def _shed_if_infeasible(self, entry: _QueueEntry, uncached_tail: int,
                            below: Optional[int], skip=None) -> bool:
        """The feasibility gate: a head whose deadline cannot cover the
        service estimate ends ``"rejected"`` before it takes blocks."""
        req = entry.request
        dl = self._deadline.get(req.uid)
        if dl is None:
            return False
        remaining = req.max_new_tokens - len(entry.generated)
        if not entry.generated:
            remaining -= 1      # the final prefill chunk emits one
        est = self._estimate_service_s(
            uncached_tail, remaining,
            skips_prefill=bool(entry.generated) and uncached_tail <= 0)
        if est is None or self._clock() + est <= dl:
            return False
        if self._obs is not None:
            self._obs.note_shed(req.uid, "rejected", queued=True)
        self.waiting.popleft(below=below, skip=skip)  # exactly this entry
        self.finished[req.uid] = list(entry.generated)
        self._set_status(req, "rejected")
        self._num_rejected_infeasible += 1
        return True

    def _note_admitted_wait(self, entry: _QueueEntry):
        """Count an admission's queue wait; returns ``(wait_s, now)``."""
        wait_ticks = self._num_ticks - entry.enq_tick
        now = self._clock()
        wait_s = max(0.0, now - entry.enq_t)
        self._queue_wait_count += 1
        self._queue_wait_ticks_sum += wait_ticks
        self._queue_wait_ticks_max = max(self._queue_wait_ticks_max,
                                         wait_ticks)
        self._queue_wait_s_sum += wait_s
        self._queue_wait_s_max = max(self._queue_wait_s_max, wait_s)
        return wait_s, now

    def _admit(self) -> int:
        """Move waiting requests into free lanes while the pool covers
        their current need: the blocks through the first decode write
        (position L), less the longest cached block-aligned prefix,
        which is shared by reference. The run of chain hashes that
        continues that prefix in the spill tier is re-admitted by one
        upload into fresh blocks instead of prefilled; a corrupt or
        missing entry ends the run, and the blocks it would have covered
        are prefilled. Candidates come class by class,
        weighted DRR across tenants within a class; the feasibility gate
        sheds an infeasible head; a head whose tenant would pass its
        ``max_resident_blocks`` is held (the tenant is skipped this pass,
        other tenants flow past); a head that does not fit the pool
        blocks the queue. At batch axis ``B > 1`` free lanes are taken
        round robin across the batch shards, every match and allocation
        of a lane stays in its shard's block range, and a head that does
        not fit its lane's shard blocks only that lane."""
        bs = self.config.block_size
        alloc = self.allocator
        admitted = 0
        below = self._admission_priority_limit()
        skip: set = set()
        for idx in self._admit_lane_order():
            if self.slots[idx] is not None:
                continue
            # None (the whole pool) unsharded
            shard = (self._lane_shard(idx) if self._batch_shards > 1
                     else None)
            while True:
                entry = self.waiting.head(below=below, skip=skip)
                if entry is None:
                    return admitted
                seq = list(entry.request.prompt)
                if entry.generated:
                    seq += entry.generated[:-1]     # resume: re-cache history
                L = len(seq)
                matched: List[int] = []
                hashes: List[str] = []
                if self.config.enable_prefix_caching:
                    if entry.hashes is None:
                        entry.hashes = seq_block_hashes(seq, bs)
                    hashes = entry.hashes
                    matched = alloc.lookup_prefix(hashes, shard=shard)
                # the spill run continues the device match: a spilled
                # block past a gap is unreachable, as in the index
                spill_run: List[str] = []
                if self.spill is not None:
                    j = len(matched)
                    while j < len(hashes) and hashes[j] in self.spill:
                        spill_run.append(hashes[j])
                        j += 1
                n_up = len(spill_run)
                m_tok = (len(matched) + n_up) * bs
                if self._shed_if_infeasible(entry, L - m_tok, below, skip):
                    continue
                tail = blocks_needed(L, bs) - len(matched) - n_up
                # uploads take fresh blocks too, so they count
                need = blocks_needed(L + 1, bs) - len(matched)
                tenant = entry.request.tenant
                q = self._tenant_quota(tenant)
                if q is not None and q.max_resident_blocks is not None:
                    # new private blocks charge one unit each, a matched
                    # block a 1 / (refs + 1) share
                    extra = self._block_weight * (need + sum(
                        1.0 / (alloc.refcount(b) + 1) for b in matched))
                    if (alloc.tenant_charge(tenant) + extra
                            > q.max_resident_blocks + 1e-9):
                        if not self._tenant_has_resident(tenant):
                            # nothing of the tenant's will free a block
                            if self._obs is not None:
                                self._obs.note_shed(entry.request.uid,
                                                    "throttled", queued=True)
                            self.waiting.popleft(below=below, skip=skip)
                            self.finished[entry.request.uid] = \
                                list(entry.generated)
                            self._set_status(entry.request, "throttled")
                            self._num_throttled += 1
                            continue
                        skip.add(tenant)
                        continue
                # cached blocks this admission revives stop being evictable
                reviving = sum(1 for b in matched if alloc.refcount(b) == 0)
                if shard is None:
                    capacity = alloc.num_free + alloc.num_cached
                else:
                    capacity = (alloc.free_in_shard(shard)
                                + alloc.cached_in_shard(shard))
                if need > capacity - reviving:
                    if shard is not None:
                        # this shard cannot fit the head; another shard's
                        # free lane may
                        break
                    return admitted         # head-of-line blocking
                alloc.acquire(matched, tenant=tenant)
                self.waiting.popleft(below=below, skip=skip)
                wait_s, admit_t = self._note_admitted_wait(entry)
                if self._obs is not None:
                    self._obs.note_admit(entry.request.uid, idx, wait_s,
                                         cached_blocks=len(matched),
                                         t=admit_t)
                up_blocks: List[int] = []
                if spill_run:
                    # pop before the alloc: the alloc may evict cached
                    # blocks into the store, whose byte bound could then
                    # drop the very entries this admission probed. The
                    # run stops at the first miss or corrupt entry; the
                    # lost blocks are prefilled instead (the same number
                    # of fresh blocks, so the checks above still hold)
                    payloads = []
                    for h in spill_run:
                        p = self.spill.pop(h)
                        if p is None:
                            break
                        payloads.append(p)
                    if len(payloads) < n_up:
                        tail += n_up - len(payloads)
                        n_up = len(payloads)
                        spill_run = spill_run[:n_up]
                        m_tok = (len(matched) + n_up) * bs
                if spill_run:
                    up_blocks = alloc.alloc(n_up, tenant=tenant, shard=shard)
                    self._upload_blocks(up_blocks, payloads)
                    for h, nb in zip(spill_run, up_blocks):
                        alloc.register_prefix(h, nb, tenant=tenant)
                    self._spill_hits += n_up
                    if self._obs is not None:
                        self._obs.record("spill_upload",
                                         uid=entry.request.uid, blocks=n_up)
                if self.spill is not None:
                    # misses by block, the hits' unit, counted only at a
                    # committed admission
                    self._spill_misses += len(hashes) - len(matched) - n_up
                blocks = matched + up_blocks + (
                    alloc.alloc(tail, tenant=tenant, shard=shard)
                    if tail else [])
                self._prefix_lookup_blocks += len(hashes)
                self._prefix_hit_blocks += len(matched)
                self._prompt_blocks_allocated += tail
                self._admit_count += 1
                slot = _Slot(
                    entry=entry, admit_seq=self._admit_count, tokens=seq,
                    prefill_len=L, prefill_pos=m_tok, context_len=m_tok,
                    blocks=blocks, block_hashes=list(hashes),
                    num_registered=len(matched) + n_up, generated=[],
                    last_token=0, started=False)
                if entry.generated and m_tok == L:
                    # resumed and fully cached: nothing to recompute
                    slot.generated = list(entry.generated)
                    slot.last_token = slot.generated[-1]
                    slot.started = True
                self.slots[idx] = slot
                self._invalidate_lanes()
                admitted += 1
                break
        return admitted

    def _register_full_blocks(self, slot: _Slot) -> None:
        """Index every newly full block of the slot (prompt blocks as
        chunks land, generated ones as decode crosses boundaries)."""
        if not self.config.enable_prefix_caching:
            return
        bs = self.config.block_size
        n_full = slot.context_len // bs
        while slot.num_registered < n_full:
            j = slot.num_registered
            if j >= len(slot.block_hashes):
                prev = slot.block_hashes[j - 1] if j else None
                slot.block_hashes.append(hash_block_tokens(
                    prev, slot.tokens[j * bs: (j + 1) * bs]))
            self.allocator.register_prefix(slot.block_hashes[j],
                                           slot.blocks[j],
                                           tenant=slot.request.tenant)
            slot.num_registered += 1

    def _prefill_tick(self) -> bool:
        """Run ONE ``[1, prefill_chunk]`` piece of the oldest lane still
        mid-prompt; the final chunk samples the first token from the
        prompt's last position (token index 0 of the request). A prompt
        cached whole runs one pass with its writes suppressed
        (``write_start`` = L) for the last position's logits. The
        prefill EWMA times the chunk."""
        cand = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                if s is not None and not s.started]
        if not cand:
            return False
        idx = min(cand)[1]
        slot = self.slots[idx]
        L, C = slot.prefill_len, self.config.chunk
        if slot.prefill_pos < L:
            start = slot.prefill_pos
        else:                       # cached whole: a logits-only pass
            start = max(0, L - C)
        end = min(start + C, L)
        ids = np.zeros((1, C), np.int64)
        ids[0, : end - start] = slot.tokens[start:end]
        positions = (start + np.arange(C, dtype=np.int64))[None]
        # the lane's batch group runs the chunk, its table in local ids
        group = self._lane_shard(idx)
        table = np.full((1, self.max_blocks_per_seq), -1, np.int32)
        table[0, : len(slot.blocks)] = (np.asarray(slot.blocks, np.int32)
                                        - group * self._blocks_per_shard)
        dev = self._group_device[group]
        # the successful attempt's service time and start: the token is
        # host-visible at their sum (its read is inside the attempt)
        attempt_s = [0.0, 0.0]

        def attempt():
            # the chunk and the sampling of its token (a host read) in one
            # retry unit; the plan fires before the chunk writes the pool
            t0 = self._clock()
            with torch.no_grad():
                logits = self._group_forward(
                    "prefill", group, torch.from_numpy(ids).to(dev),
                    device_block_table(table, self._blocks_per_shard, dev),
                    torch.from_numpy(positions).to(dev),
                    torch.tensor([end], dtype=torch.int64, device=dev),
                    torch.tensor([slot.prefill_pos], dtype=torch.int64,
                                 device=dev))
                tok = None
                if end == L and not slot.entry.generated:
                    sp = slot.request.sampling
                    tok = int(sample_with_uniforms(
                        logits[:, (L - 1) - start],
                        uniforms([token_generator(self.config.seed,
                                                  slot.entry.arrival,
                                                  0)]).to(dev),
                        torch.tensor([sp.temperature], device=dev),
                        torch.tensor([sp.top_k], device=dev),
                        torch.tensor([sp.top_p], device=dev),
                        sp.temperature > 0)[0])
            attempt_s[0] = self._clock() - t0
            attempt_s[1] = t0
            return tok

        try:
            tok = self._guarded_dispatch("prefill", attempt)
        except DispatchFailedError:
            # the failing chunk served one request: it ends "failed"
            self._quarantine_slot(idx)
            return True
        self._ewma_prefill_s = self._ewma_update(self._ewma_prefill_s,
                                                 attempt_s[0])
        self._num_prefill_chunks += 1
        self._num_prefill_tokens += end - start
        if self._obs is not None:
            self._obs.note_prefill_chunk(slot.request.uid, idx, start, end,
                                         attempt_s[1], attempt_s[0])
        slot.prefill_pos = end
        slot.context_len = max(slot.context_len, end)
        self._register_full_blocks(slot)
        if end < L:
            return True
        self._num_prefills += 1
        slot.started = True
        self._invalidate_lanes()
        if slot.entry.generated:
            # resumed after preemption: never resample emitted tokens
            slot.generated = list(slot.entry.generated)
            slot.last_token = slot.generated[-1]
            return True
        self._record_token(idx, tok, t_vis=attempt_s[1] + attempt_s[0])
        return True

    def _preempt_for(self, requester: int) -> bool:
        """Free the lowest-class, youngest lane (:meth:`_yield_key`); its
        request re-queues at the front of its class carrying its
        generated tokens. False when the requester is the only lane. At
        ``B > 1`` only the requester's batch shard is searched: another
        shard's blocks cannot serve its allocation."""
        cand = [i for i, s in enumerate(self.slots) if s is not None
                and (self._batch_shards == 1
                     or self._lane_shard(i) == self._lane_shard(requester))]
        if len(cand) <= 1:
            return False
        return self._preempt_slot(max(cand, key=self._yield_key))

    def _preempt_tenant_lane(self, tenant: str, requester: int) -> bool:
        """A lane growing past its tenant's ``max_resident_blocks``
        preempts the tenant's own lowest-class, youngest other lane whose
        release lowers the tenant's charge (it holds a private block or
        one another tenant shares). False when there is none."""
        alloc = self.allocator

        def reduces(slot: _Slot) -> bool:
            return any(alloc.refcount(b) == 1
                       or alloc.tenant_refcount(b, tenant)
                       < alloc.refcount(b)
                       for b in slot.blocks)

        cand = [i for i, s in enumerate(self.slots)
                if s is not None and i != requester
                and s.request.tenant == tenant and reduces(s)]
        if not cand:
            return False
        idx = max(cand, key=self._yield_key)
        tally = self._tenant_preemptions
        tally[tenant] = tally.get(tenant, 0) + 1
        return self._preempt_slot(idx, reason="quota")

    def _preempt_slot(self, idx: int, reason: str = "pool_pressure") -> bool:
        slot = self.slots[idx]
        gen = self._resume_tokens(slot)
        # deepest first, as _finish
        self.allocator.free(list(reversed(slot.blocks)),
                            tenant=slot.request.tenant)
        requeue_t = self._clock()
        self.waiting.appendleft(_QueueEntry(
            request=slot.request, arrival=slot.entry.arrival,
            generated=gen, enq_t=requeue_t, enq_tick=self._num_ticks,
            drr_charged=True))
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.waiting))
        self.slots[idx] = None
        self._invalidate_lanes()
        self._num_preemptions += 1
        if self._obs is not None:
            self._obs.note_preempt(slot.request.uid, idx, reason=reason,
                                   t=requeue_t)
            self._obs.note_enqueue(slot.request.uid,
                                   tenant=slot.request.tenant,
                                   priority=slot.request.priority,
                                   requeue=True, t=requeue_t)
        return True

    def _build_draft_plan(self, active: List[int]) -> None:
        """Ask the drafter for up to ``min(cap, remaining - 1)`` proposals
        a decoding lane (so the verify never emits past the budget), cut
        at the first token outside the vocabulary. The cap is
        ``spec_tokens``, or ``spec_adapt``'s; at ladder rung 1 and up the
        plan is empty (a zero-proposal verify is one decode step). Each
        proposal runs under :func:`guarded_call` at site ``"draft"``; a
        drafter that raises anything but ``SimulatedCrash``, or runs out
        of retries, is quarantined for good: every later plan is empty."""
        self._draft_plan = {}
        if not self._drafter_ok:
            return
        if self._degradation_level >= 1:
            return
        S = self.config.spec_tokens
        if self.config.spec_adapt:
            S = min(S, self._spec_cap)
            if S == 0:
                # capped out: every _SPEC_PROBE_EVERY-th plan is a probe
                self._spec_probe_countdown -= 1
                if self._spec_probe_countdown > 0:
                    return
                self._spec_probe_countdown = _SPEC_PROBE_EVERY
                S = 1
        vocab = self.model.cfg.vocab_size
        plan: Dict[int, List[int]] = {}

        def count(attempt):
            self._num_draft_retries += 1

        for i in active:
            slot = self.slots[i]
            cap = min(S, slot.request.max_new_tokens
                      - len(slot.generated) - 1)
            if cap < 1:
                continue
            history = list(slot.request.prompt) + slot.generated
            try:
                props, _ = guarded_call(
                    self.drafter.propose, history, cap,
                    plan=self.faults, site="draft",
                    retries=self.config.max_dispatch_retries,
                    backoff_s=self.config.retry_backoff_s,
                    on_retry=count)
            except SimulatedCrash:
                raise
            except Exception:
                # out of retries, or a drafter bug: decode on without it
                self._drafter_ok = False
                self._num_drafter_quarantines += 1
                if self._obs is not None:
                    self._obs.record("drafter_quarantine")
                    self._obs.incident("drafter_quarantine")
                return
            clean: List[int] = []
            for t in list(props)[:cap]:
                t = int(t)
                if not 0 <= t < vocab:
                    break
                clean.append(t)
            if clean:
                plan[i] = clean
        self._draft_plan = plan

    def _ensure_decode_blocks(self) -> None:
        """Every started lane is about to write K/V at ``context_len ..
        context_len + span - 1`` (span: ``decode_steps`` capped by its
        remaining budget, or speculating, the carried token plus its
        proposals): allocate the missing blocks up front (a lane past
        its tenant's block quota first preempts the tenant's own
        youngest other lane; a dry pool preempts the lowest-class,
        youngest lane), and copy any covering block shared with another
        sequence to a private one (copy-on-write)."""
        bs = self.config.block_size
        K = self.config.decode_steps
        order = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                       if s is not None and s.started)
        for _, i in order:
            while self.slots[i] is not None:
                slot = self.slots[i]
                tenant = slot.request.tenant
                if self.config.spec_tokens > 0:
                    span = 1 + len(self._draft_plan.get(i, ()))
                else:
                    span = min(K, slot.request.max_new_tokens
                               - len(slot.generated))
                grow = blocks_needed(slot.context_len + span, bs) \
                    - len(slot.blocks)
                if grow > 0:
                    q = self._tenant_quota(tenant)
                    if (q is not None
                            and q.max_resident_blocks is not None
                            and self.allocator.tenant_charge(tenant)
                            + grow * self._block_weight
                            > q.max_resident_blocks + 1e-9
                            and self._preempt_tenant_lane(tenant, i)):
                        continue    # the freed charge may cover it now
                    try:
                        slot.blocks.extend(self.allocator.alloc(
                            grow, tenant=tenant,
                            shard=self._alloc_shard(i)))
                        self._invalidate_lanes()
                    except CacheOutOfBlocks:
                        if not self._preempt_for(i):
                            if self._obs is not None:
                                self._obs.record(
                                    "alloc_pressure", uid=slot.request.uid,
                                    free=self.allocator.num_free)
                            raise CacheOutOfBlocks(
                                f"request {slot.request.uid!r} cannot grow "
                                f"past {slot.context_len} cached tokens: "
                                f"{self.allocator.num_free} blocks free of "
                                f"{self.allocator.num_blocks} and no other "
                                "lane left to preempt")
                    continue    # re-check: the slot itself may be gone
                first = slot.context_len // bs
                last = (slot.context_len + span - 1) // bs
                j = next((j for j in range(first, last + 1)
                          if self.allocator.refcount(slot.blocks[j]) > 1),
                         None)
                if j is None:
                    break
                try:
                    # the private copy lands on the lane's shard
                    nb = self.allocator.alloc(
                        1, tenant=tenant, shard=self._alloc_shard(i))[0]
                except CacheOutOfBlocks:
                    if not self._preempt_for(i):
                        if self._obs is not None:
                            self._obs.record(
                                "alloc_pressure", uid=slot.request.uid,
                                free=self.allocator.num_free)
                        raise CacheOutOfBlocks(
                            f"request {slot.request.uid!r}: cannot "
                            "copy-on-write a shared block, pool exhausted "
                            "and no lane left to preempt")
                    continue
                b = slot.blocks[j]
                copy_block(self._pools, b, nb)
                self.allocator.free([b], tenant=tenant)
                slot.blocks[j] = nb
                self._invalidate_lanes()
                # the copy diverges from the indexed contents once it is
                # appended to; the registration stays with the original
                if slot.num_registered > j:
                    slot.num_registered = j
                self._num_cow_copies += 1

    # -- the mesh's batch groups ----------------------------------------------

    def _lane_shard(self, lane: int) -> int:
        """The batch shard owning a lane: ``lane // lanes_per_shard``."""
        return lane // self._lanes_per_shard

    def _alloc_shard(self, lane: int) -> Optional[int]:
        """The ``shard=`` of a lane's allocations: its batch shard, None
        (the whole pool) unsharded."""
        return self._lane_shard(lane) if self._batch_shards > 1 else None

    def _admit_lane_order(self):
        """Free lanes in index order unsharded; at ``B > 1`` round robin
        across the batch shards (lane 0 of every shard, then lane 1, ...),
        so residents spread over the shards."""
        if self._batch_shards == 1:
            return range(self.config.max_batch)
        return (s * self._lanes_per_shard + lane
                for lane in range(self._lanes_per_shard)
                for s in range(self._batch_shards))

    def _group_forward(self, program: str, group: int, ids, tables,
                       positions, seq_lens, write_start):
        """One serving forward of batch group ``group`` (its inputs and
        local block tables on its device): :func:`~apex_tpu_torch.models.
        gpt.sharded_serve_forward` over its model shards, each sum counted
        in the collective log under ``program`` (none at model axis 1).
        Logits ``[B, S, V]``."""
        log = self._collectives
        log.begin(program)
        logits = sharded_serve_forward(
            self._model_shards[group], ids, self._pools.shards[group],
            tables, positions, seq_lens, write_start,
            all_reduce=log.all_reduce)
        log.end()
        return logits

    def _decode_tables(self, group: int = 0) -> torch.Tensor:
        """Batch group ``group``'s decode block table on its device, in
        local block ids (still-prefilling lanes unmapped), rebuilt only
        when lane composition or blocks change."""
        if self._dev_tables is None:
            self._dev_tables = [None] * self._batch_shards
        if self._dev_tables[group] is None:
            Lp, base = self._lanes_per_shard, group * self._blocks_per_shard
            t = np.full((Lp, self.max_blocks_per_seq), -1, np.int32)
            for r in range(Lp):
                slot = self.slots[group * Lp + r]
                if slot is not None and slot.started:
                    t[r, : len(slot.blocks)] = (
                        np.asarray(slot.blocks, np.int32) - base)
            self._dev_tables[group] = device_block_table(
                t, self._blocks_per_shard, self._group_device[group])
        return self._dev_tables[group]

    def _lane_inputs(self, active: List[int], u_shape, draw):
        """The per-lane inputs of a dispatch as host arrays, every lane a
        row (zeros, no EOS and greedy where a lane is not ``active``):
        carried tokens, context lengths, remaining budgets, EOS ids (-1:
        none), temperature, top-k, top-p, and uniforms of ``u_shape`` a
        row, drawn by ``draw(slot)`` for the lanes that sample."""
        B = self.config.max_batch
        tokens = np.zeros(B, np.int64)
        ctx = np.zeros(B, np.int64)
        budgets = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int64)
        top_p = np.ones(B, np.float32)
        u = np.zeros((B,) + tuple(u_shape), np.float32)
        for i in active:
            slot = self.slots[i]
            req = slot.request
            tokens[i] = slot.last_token
            ctx[i] = slot.context_len
            budgets[i] = req.max_new_tokens - len(slot.generated)
            if req.eos_token_id is not None:
                eos[i] = req.eos_token_id
            sp = req.sampling
            temp[i], top_k[i], top_p[i] = sp.temperature, sp.top_k, sp.top_p
            if sp.temperature > 0:
                u[i] = draw(slot).numpy()
        return tokens, ctx, budgets, eos, temp, top_k, top_p, u

    def _groups(self, active: List[int]):
        """``(group, rows, device)`` of every batch group with a lane in
        ``active`` (one group, every row, unsharded)."""
        Lp = self._lanes_per_shard
        for g in range(self._batch_shards):
            rows = slice(g * Lp, (g + 1) * Lp)
            if any(rows.start <= i < rows.stop for i in active):
                yield g, rows, self._group_device[g]

    def _lane_tokens(self, outs: Dict[int, torch.Tensor], width: int):
        """The dispatch's ``[max_batch, width]`` tokens on the engine's
        device from each group's rows (``-1`` for a group that ran
        nothing)."""
        if self._batch_shards == 1:
            return outs[0]
        Lp = self._lanes_per_shard
        return torch.cat([
            outs[g].to(self.device) if g in outs
            else torch.full((Lp, width), -1, dtype=torch.long,
                            device=self.device)
            for g in range(self._batch_shards)])

    def _dispatch_decode(self, active: List[int]) -> None:
        """Run the K-step decode (or, speculating, the verify) for
        ``active`` lanes at site ``"decode"`` and leave its ``[B, K]``
        tokens in flight. When its retries run out the batch is poisoned
        and nothing says by which lane: the lowest-class, youngest lane
        (:meth:`_yield_key`) is quarantined and the dispatch runs again
        over the rest, until it launches or no lane is left. A
        ``"corrupt"`` fire marks the dispatch's tokens for its drain."""
        while active:
            try:
                out, drafted = self._guarded_dispatch(
                    "decode", self._decode_program, active)
            except DispatchFailedError:
                self._quarantine_slot(max(active, key=self._yield_key))
                active = self._started_lanes()
                continue
            self._num_decode_dispatches += 1
            self._pending_corrupt = (
                self.faults.corrupt_seed("decode")
                if self.faults is not None else None)
            # counted for the lanes this dispatch verifies
            self._num_draft_tokens += drafted
            self._pending = (out, list(active),
                             {i: self.slots[i].request.uid for i in active})
            if self._obs is not None:
                self._pending_obs = (self._clock(),
                                     self._num_decode_dispatches)
            return

    def _decode_program(self, active: List[int]):
        """The K-step decode over ``active`` lanes (or, speculating,
        :meth:`_verify_program`): ``([B, K] tokens, drafted)``, ``-1``
        where a lane emitted nothing. Each step writes the carried
        token's K/V at the lane's context position, attends, samples
        token ``gen_count + j`` and feeds it back; a lane freezes (its
        ``write_start`` one past its position, so nothing is written)
        once its budget is spent or it samples its EOS id. Each batch
        group with an active lane runs its own K steps."""
        if self.config.spec_tokens > 0:
            return self._verify_program(active)
        K = self.config.decode_steps
        seed = self.config.seed

        def draw(slot):
            g0 = len(slot.generated)
            return uniforms([token_generator(seed, slot.entry.arrival,
                                             g0 + j) for j in range(K)])

        host = self._lane_inputs(active, (K,), draw)
        outs = {}
        for g, rows, dev in self._groups(active):
            tok, ctx_t, budget, eos_t, temp_t, top_k_t, top_p_t, u_t = (
                torch.from_numpy(a[rows]).to(dev) for a in host)
            any_sampled = bool((host[4][rows] > 0).any())
            tables = self._decode_tables(g)
            steps = []
            with torch.no_grad():
                for j in range(K):
                    act = budget > 0
                    logits = self._group_forward(
                        "decode", g, tok[:, None], tables, ctx_t[:, None],
                        ctx_t + 1, torch.where(act, ctx_t, ctx_t + 1))
                    new = sample_with_uniforms(logits[:, 0], u_t[:, j],
                                               temp_t, top_k_t, top_p_t,
                                               any_sampled)
                    emitted = act.long()
                    steps.append(torch.where(act, new,
                                             torch.full_like(new, -1)))
                    budget = budget - emitted
                    stop = (budget <= 0) | ((eos_t >= 0) & (new == eos_t))
                    cont = act & ~stop
                    tok = torch.where(cont, new, tok)
                    ctx_t = ctx_t + emitted
                    budget = torch.where(cont, budget,
                                         torch.zeros_like(budget))
            outs[g] = torch.stack(steps, dim=1)
        return self._lane_tokens(outs, K), 0

    def _verify_program(self, active: List[int]):
        """The draft-and-verify dispatch: ONE ``[lanes, spec_tokens + 1]``
        forward a batch group through the paged cache (the multi-query
        prefill read). Each lane's chunk is its carried token and its
        proposals at positions ``ctx .. ctx + d``; their K/V land in the
        span reserved for them, rejected ones past the new context where
        every read masks them. :func:`spec_verify_tokens` keeps a prefix
        of the drafts, then the stop masks of the K-step decode apply:
        nothing past the emitted window, nothing after an EOS, nothing
        from an inactive lane (its ``write_start`` past the chunk) — ``-1``
        sentinels, so the drain is the K-step one. Returns ``(tokens,
        proposals verified)``."""
        B, S = self.config.max_batch, self.config.spec_tokens
        P = S + 1
        seed = self.config.seed
        drafts = np.zeros((B, S), np.int64)
        dlens = np.zeros(B, np.int64)
        for i in active:
            plan = self._draft_plan.get(i, ())
            drafts[i, : len(plan)] = plan
            dlens[i] = len(plan)
        host = self._lane_inputs(
            active, (P, 3), lambda slot: spec_uniforms(
                seed, slot.entry.arrival, len(slot.generated), P))
        outs = {}
        for g, rows, dev in self._groups(active):
            tok, ctx_t, budget, eos_t, temp_t, top_k_t, top_p_t, u_t = (
                torch.from_numpy(a[rows]).to(dev) for a in host)
            any_sampled = bool((host[4][rows] > 0).any())
            drafts_t = torch.from_numpy(drafts[rows]).to(dev)
            dlens_t = torch.from_numpy(dlens[rows]).to(dev)
            act = budget > 0
            q_ids = torch.cat([tok[:, None], drafts_t], dim=1)
            steps = torch.arange(P, device=dev)[None]
            with torch.no_grad():
                logits = self._group_forward(
                    "verify", g, q_ids, self._decode_tables(g),
                    ctx_t[:, None] + steps, ctx_t + 1 + dlens_t,
                    torch.where(act, ctx_t, ctx_t + P + 1))
                emitted, n_emit = spec_verify_tokens(
                    logits, drafts_t, dlens_t, u_t, temp_t, top_k_t,
                    top_p_t, any_sampled)
                # prefix masks, as the scan's: the emitted window, nothing
                # after the first EOS, nothing from an inactive lane
                within = steps < n_emit[:, None]
                is_eos = within & (eos_t[:, None] >= 0) \
                    & (emitted == eos_t[:, None])
                after_eos = (torch.cumsum(is_eos.long(), dim=1)
                             - is_eos.long()) > 0
                keep = within & ~after_eos & act[:, None]
                outs[g] = torch.where(keep, emitted,
                                      torch.full_like(emitted, -1))
        return self._lane_tokens(outs, P), int(dlens.sum())

    def _drain_decode(self) -> bool:
        """Fetch the in-flight dispatch's tokens and replay them through
        the per-token bookkeeping (cache-token append, block
        registration, EOS/budget finish); a lane aborted (or refilled)
        while the dispatch was in flight is skipped by its uid. The
        decode EWMA times the fetch. Speculating, an emitted token equal
        to the lane's proposal at its index is an accepted draft, the
        span blocks the rejection stranded go back to the pool
        (``trim_to``), and with ``spec_adapt`` the dispatch's acceptance
        moves the draft cap.

        A failed fetch counts against ``max_dispatch_retries`` (running
        out quarantines the youngest lane the dispatch covered), then
        :meth:`_reset_device_state` requeues the residents and resets the
        pool: re-prefill re-derives it, and nothing of the failed
        dispatch is reused. A ``"corrupt"`` dispatch has one of its
        tokens perturbed before any bookkeeping."""
        if self._pending is None:
            return False
        toks_dev, active, uids = self._pending
        self._pending = None
        pending_obs, self._pending_obs = self._pending_obs, None
        corrupt_seed, self._pending_corrupt = self._pending_corrupt, None
        t_fetch = self._clock()
        try:
            toks = toks_dev.cpu().numpy()
        except SimulatedCrash:
            raise
        except TRANSIENT_ERRORS:
            self._fetch_failures += 1
            if self._fetch_failures > self.config.max_dispatch_retries:
                # a lane aborted or refilled in flight was no part of it
                live = [i for i in active
                        if self.slots[i] is not None
                        and self.slots[i].started
                        and self.slots[i].request.uid == uids[i]]
                if live:
                    self._quarantine_slot(max(live, key=self._yield_key))
                self._fetch_failures = 0
            else:
                self._num_dispatch_retries += 1
                if self._obs is not None:
                    self._obs.record("fault_retry", site="decode_drain",
                                     attempt=self._fetch_failures)
                if self.config.retry_backoff_s > 0.0:
                    time.sleep(self.config.retry_backoff_s
                               * (2 ** (self._fetch_failures - 1)))
            self._reset_device_state()
            return True
        self._fetch_failures = 0
        # the tokens are host-visible once the copy returned: t_end is
        # their time (TTFT, inter-token times) and ends the fetch block
        t_end = self._clock()
        self._ewma_decode_s = self._ewma_update(self._ewma_decode_s,
                                                t_end - t_fetch)
        counts = (toks >= 0).sum(axis=1)
        if corrupt_seed is not None:
            toks = perturb_tokens(toks, counts, self.model.cfg.vocab_size,
                                  corrupt_seed)
        if self._obs is not None and pending_obs is not None:
            # the dispatch is traced before its tokens replay, so each
            # timeline reads decode, drain, terminal; aborted or refilled
            # lanes are left out as the replay leaves them out
            self._obs.note_decode_drained(
                pending_obs[1], pending_obs[0], t_end, t_end - t_fetch,
                [(uids[i], i, int(counts[i])) for i in active
                 if self.slots[i] is not None
                 and self.slots[i].request.uid == uids[i]])
        spec = self.config.spec_tokens > 0
        bs = self.config.block_size
        drafted_this = accepted_this = 0
        for i in active:
            slot = self.slots[i]
            if slot is None or slot.request.uid != uids[i]:
                continue
            n = int(counts[i])
            for j in range(n):
                slot.tokens.append(slot.last_token)     # its K/V landed
                slot.context_len += 1
                self._register_full_blocks(slot)
                self._record_token(i, int(toks[i, j]), t_vis=t_end)
                if self.slots[i] is None:
                    break
            self._num_tokens_decoded += n
            if not spec:
                continue
            # a match can only be an acceptance: a sampled correction is
            # drawn with the draft removed, a greedy one is the argmax
            # the draft was not
            prop = self._draft_plan.get(i, ())
            drafted_this += len(prop)
            for j in range(min(n, len(prop))):
                if int(toks[i, j]) != prop[j]:
                    break
                self._num_accepted_tokens += 1
                accepted_this += 1
            slot = self.slots[i]
            if slot is not None:
                keep = blocks_needed(slot.context_len, bs)
                if len(slot.blocks) > keep:
                    self._num_spec_blocks_rolled_back += \
                        len(slot.blocks) - keep
                    # no table rebuild: the trimmed entries sit past the
                    # lane's context, where every read and write is
                    # masked, and a span reaching them allocates first
                    slot.blocks = self.allocator.trim_to(
                        slot.blocks, keep, tenant=slot.request.tenant)
        if spec and self.config.spec_adapt and drafted_this:
            # the dead band [low, high] is the hysteresis: at or above
            # high the cap never moves (static speculation)
            self._spec_accept_ewma = self._ewma_update(
                self._spec_accept_ewma, accepted_this / drafted_this)
            if (self._spec_accept_ewma < self.config.spec_accept_low
                    and self._spec_cap > 0):
                self._spec_cap -= 1
                self._num_spec_cap_shrinks += 1
                if self._obs is not None:
                    self._obs.record("spec_cap", cap=self._spec_cap,
                                     direction="shrink",
                                     ewma=self._spec_accept_ewma)
            elif (self._spec_accept_ewma > self.config.spec_accept_high
                    and self._spec_cap < self.config.spec_tokens):
                self._spec_cap += 1
                self._num_spec_cap_restores += 1
                if self._obs is not None:
                    self._obs.record("spec_cap", cap=self._spec_cap,
                                     direction="restore",
                                     ewma=self._spec_accept_ewma)
        return True

    def _record_token(self, idx: int, token: int,
                      t_vis: Optional[float] = None) -> None:
        """The one funnel of fresh tokens: the lane, the stream, the
        tenant's count and rate, the observer (``t_vis``: when the token
        reached the host, a time the caller already read); finishes on
        EOS or the budget."""
        slot = self.slots[idx]
        slot.generated.append(token)
        slot.last_token = token
        req = slot.request
        self._stream.append((req.uid, int(token), False))
        if self._obs is not None:
            self._obs.note_token(req.uid, t=t_vis)
        self._note_tenant_tokens(req.tenant, 1)
        if ((req.eos_token_id is not None and token == req.eos_token_id)
                or len(slot.generated) >= req.max_new_tokens):
            self._finish(idx)

    def _finish(self, idx: int, status: str = "finished") -> None:
        """Release the lane, deepest block first: with prefix caching the
        registered blocks stay cached, and a chain's tail must age out of
        the LRU before its head for partial chains to stay matchable."""
        slot = self.slots[idx]
        self.allocator.free(list(reversed(slot.blocks)),
                            tenant=slot.request.tenant)
        self.finished[slot.request.uid] = self._resume_tokens(slot)
        # clear the lane first: the idle-tenant pruning must not see it
        self.slots[idx] = None
        self._set_status(slot.request, status, lane=idx)
        self._invalidate_lanes()

    # -- faults and recovery -------------------------------------------------

    def _quarantine_slot(self, idx: int) -> None:
        """End a lane's request ``"failed"`` after its dispatches ran out
        of retries (the tokens it emitted kept); the engine serves on. An
        observer's recorder freezes its tail as an incident."""
        uid = self.slots[idx].request.uid
        self._finish(idx, status="failed")
        self._num_quarantines += 1
        if self._obs is not None:
            self._obs.record("quarantine", uid=uid, lane=idx)
            self._obs.incident("quarantine", uid=uid)

    def _guarded_dispatch(self, site: str, fn, *args):
        """``fn(*args)`` under :func:`guarded_call` at ``site``: the plan
        fires before each attempt, transient failures retry
        ``max_dispatch_retries`` times, and running out raises
        ``DispatchFailedError``. A retry is sound because the fire comes
        before ``fn`` writes the pool."""

        def count(attempt):
            self._num_dispatch_retries += 1
            if self._obs is not None:
                self._obs.record("fault_retry", site=site, attempt=attempt)

        out, _ = guarded_call(
            fn, *args, plan=self.faults, site=site,
            retries=self.config.max_dispatch_retries,
            backoff_s=self.config.retry_backoff_s, on_retry=count)
        return out

    def _reset_device_state(self) -> None:
        """After a failed drain: every resident goes back to the head of
        the queue with its emitted tokens (oldest first), the allocator
        resets and the pools are zeroed in place; re-prefill re-derives
        the cache."""
        live = sorted(((s.admit_seq, i)
                       for i, s in enumerate(self.slots)
                       if s is not None), reverse=True)
        if self._obs is not None:
            self._obs.record("device_reset", residents=len(live),
                             fetch_failures=self._fetch_failures)
            self._obs.incident("device_reset")
        for _, i in live:    # youngest first, so the oldest lands at head
            slot = self.slots[i]
            requeue_t = self._clock()
            self.waiting.appendleft(_QueueEntry(
                request=slot.request, arrival=slot.entry.arrival,
                generated=self._resume_tokens(slot),
                enq_t=requeue_t, enq_tick=self._num_ticks,
                drr_charged=True))
            self.slots[i] = None
            if self._obs is not None:
                self._obs.note_preempt(slot.request.uid, i,
                                       reason="device_reset", t=requeue_t)
                self._obs.note_enqueue(slot.request.uid,
                                       tenant=slot.request.tenant,
                                       priority=slot.request.priority,
                                       requeue=True, t=requeue_t)
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.waiting))
        self.allocator.reset()
        self._pools.zero_()
        self._draft_plan = {}
        self._invalidate_lanes()

    # -- data integrity ------------------------------------------------------

    def _corrupt_payload_hook(self, site: str, payload):
        """The spill store's fault seam: fire the plan at the store's
        site and, on a ``"corrupt"`` hit, return a copy with one byte
        flipped (the rot its checksum exists to catch); the payload as it
        was otherwise."""
        self.faults.fire(site)
        seed = self.faults.corrupt_seed(site)
        if seed is None:
            return payload
        return perturb_payload(payload, seed)

    def _note_corruption(self, site: str, detail: str) -> None:
        """Every detection path ends here: one count in
        ``num_corruptions_detected`` and one recorder event."""
        self._num_corruptions_detected += 1
        if self._obs is not None:
            self._obs.record("corruption_detected", site=site,
                             detail=str(detail))

    def _maybe_scrub(self) -> None:
        """Every ``scrub_interval_ticks``-th tick: re-verify
        ``scrub_spill_blocks`` spill entries round robin (a corrupt one is
        discarded; a later admission recomputes it) and audit the
        allocator, which raises on a broken invariant (a corrupt ledger
        has no safe degradation)."""
        interval = self.config.scrub_interval_ticks
        if interval is None or self._num_ticks % interval:
            return
        self._num_scrubs += 1
        verified = corrupt = 0
        if self.spill is not None:
            verified, corrupt = self.spill.scrub(
                self.config.scrub_spill_blocks)
            self._num_scrub_blocks_verified += verified
        self.check_allocator_integrity()
        if self._obs is not None:
            self._obs.record("scrub", verified=int(verified),
                             corrupt=int(corrupt))

    # -- the host spill tier ---------------------------------------------------

    def _spill_payload(self, block_id: int, record: bool = True):
        """The allocator's spill fetch: one block's contents as CPU
        tensors in the pool's dtype (scales included on a quantized pool),
        its model shards' heads gathered in order, so the payload is the
        unsharded pool's. Each piece is a blocking copy on the pool's
        stream, so the bytes are in host memory, and fresh, when the store
        checksums them. Unlike the JAX engine's fetch, this one catches
        nothing: a CUDA error is sticky, and swallowing it would hide a
        dead device (ROADMAP C8). ``record=False`` (a migration export, not
        an eviction) records no ``spill`` event."""
        payload = self._pools.block_payload(block_id)
        if record and self._obs is not None:
            self._obs.record(
                "spill", block=int(block_id),
                bytes=int(sum(t.nbytes for t in payload.values())))
        return payload

    def _upload_blocks(self, block_ids: List[int], payloads) -> None:
        """Write spilled payloads into blocks ``block_ids`` of the pool,
        in place: one ``index_copy_`` a pool tensor of each shard, of the
        payloads' head slice stacked on the block axis. The copy is of raw
        bytes (a uint8 view), so the uploaded blocks hold exactly the
        spilled bytes in every dtype, fp8 included. The stacked host
        tensors are fresh and the copy to the device returns after
        reading them."""
        self._pools.upload(block_ids, payloads)

    # -- the degradation ladder ----------------------------------------------

    def _ladder_enabled(self) -> bool:
        return (self.config.queue_high_watermark is not None
                or self.config.free_block_low_watermark is not None)

    def _under_pressure(self) -> bool:
        """Queue depth at or over the high mark, or the allocatable
        fraction (free plus cached: what ``alloc`` can draw on) at or
        under the low mark."""
        cfg = self.config
        if (cfg.queue_high_watermark is not None
                and len(self.waiting) >= cfg.queue_high_watermark):
            return True
        if cfg.free_block_low_watermark is not None:
            allocatable = (self.allocator.num_free
                           + self.allocator.num_cached)
            if (allocatable / max(self.allocator.num_blocks, 1)
                    <= cfg.free_block_low_watermark):
                return True
        return False

    def _update_ladder(self) -> bool:
        """One hysteresis tick: ``degrade_patience`` pressure ticks in a
        row step one rung down, as many clear ticks one rung up; at rung
        2 and below the prefix cache's cached blocks are flushed every
        tick. Returns whether a transition happened."""
        if not self._ladder_enabled():
            return False
        transition = False
        if self._under_pressure():
            self._pressure_streak += 1
            self._clear_streak = 0
            if (self._degradation_level < _LADDER_TOP
                    and self._pressure_streak
                    >= self.config.degrade_patience):
                self._degradation_level += 1
                self._pressure_streak = 0
                self._num_degrade_steps_down += 1
                transition = True
                if self._obs is not None:
                    self._obs.record("ladder", direction="down",
                                     level=self._degradation_level)
        else:
            self._clear_streak += 1
            self._pressure_streak = 0
            if (self._degradation_level > 0
                    and self._clear_streak >= self.config.degrade_patience):
                self._degradation_level -= 1
                self._clear_streak = 0
                self._num_degrade_steps_up += 1
                transition = True
                if self._obs is not None:
                    self._obs.record("ladder", direction="up",
                                     level=self._degradation_level)
        if self._degradation_level >= 2:
            self._num_degrade_flushed_blocks += \
                self.allocator.flush_evictable()
        return transition
