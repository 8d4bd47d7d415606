"""Fleet serving: a crash-tolerant router over N engine replicas
(counterpart of :mod:`apex_tpu.serving.fleet`; the same placement,
counters and verdicts on the same traffic).

:class:`FleetRouter` drives N :class:`~apex_tpu_torch.serving.engine.
InferenceEngine` replicas of one model and :class:`EngineConfig` as one
serving surface, through the engine's replica surface (``add_request``,
``step``, ``load``, ``probe_prefix``, ``export_requests``,
``import_requests``, ``pop_results``, ``last_checkpoint``, ...), which is
host-side and JSON-able, so a replica runs in this process or in a child
process (:class:`~apex_tpu_torch.serving.process_replica.ProcessReplica`)
behind the same code path.

**Prefix-affinity placement.** Chain hashes of full prompt blocks are
comparable across engines, so the router asks every replica how many
leading blocks it could serve without recompute (device index and spill
tier) and scores that against load: queue depth plus active lanes,
weighed by each replica's service EWMAs against the fleet's. Ties go to
the emptier, then the lower-indexed replica, so a one-replica fleet is
the bare engine (outputs, statuses and schedule counters).

**Failover with zero lost requests.** Each replica refreshes a
checkpoint every ``snapshot_interval_ticks``. A replica is dead on an
exception escaping its ``step()`` (an injected crash included) or after
``health_patience`` ticks without progress while it holds work.
Failover adopts the terminal results the checkpoint holds, re-imports
its live entries with their tokens and arrival index (later tokens
re-derive bit for bit), and re-injects accepts the checkpoint never saw
from the router's own copies. ``num_lost_requests`` is the invariant as
a gauge. A request that takes down ``max_request_failovers`` replicas is
ended ``"failed"`` instead of cascading.

**Drain and migrate.** :meth:`FleetRouter.migrate` moves live requests
off a replica as sealed records (optionally with their prompts' KV
payloads through the spill tiers), and :meth:`FleetRouter.drain_replica`
empties one, optionally retiring it.

Tenancy aggregates fleet-wide: ``FleetConfig.tenant_quotas`` holds the
sums across replicas at the router's door; each replica's own walk and
quotas run unchanged inside it. **SDC detection**
(``sdc_check_interval_ticks``) replays a sampled completed request on
another replica under its arrival index and compares the tokens; a
divergence is arbitrated by a third replica where one is alive, and the
side the majority contradicts is retired with its host state untrusted.
Checkpoints and migration records are verified before use. The
autoscaler grows and shrinks the fleet on the mean queue depth;
``replica_roles`` splits it into prefill and decode specialists with a
KV handoff; ``shared_prefix_bytes`` adds the router-owned
:class:`~apex_tpu_torch.serving.kv_cache.SharedPrefixStore`, fed by the
replicas' spill evictions and probed at placement.

Delivery: terminal results are exactly once (:meth:`FleetRouter.run`);
stream tokens are exactly once under failover (the router's per-request
watermark suppresses re-derived tokens), a terminal sentinel is best
effort.

The device. Every replica runs on the router's ``device`` (the CUDA card
unless the caller asks for the CPU) over one serving mesh, the caller's
``mesh=`` or the engine's default grid, threaded through every replica
and respawn. In-process replicas share the process's CUDA context: an
injected fault or a Python exception fails one replica over, but a real
CUDA error is sticky and poisons the context of all of them, so the
router does not contain it as one replica's death; it raises out of
:meth:`FleetRouter.step` (ROADMAP C11). Only process mode isolates a
device fault: the child's error comes back as a
:class:`~apex_tpu_torch.serving.process_replica.RemoteEngineError` and
fails that replica over.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.serving.engine import (
    EngineConfig,
    InferenceEngine,
    QueueFullError,
    Request,
    RequestResult,
    TenantQuota,
    TenantThrottledError,
)
from apex_tpu_torch.serving.kv_cache import (
    DEFAULT_TENANT,
    SharedPrefixStore,
    blocks_needed,
    seq_block_hashes,
)
from apex_tpu_torch.serving.mesh import build_mesh
from apex_tpu_torch.serving.process_replica import (
    ProcessReplica,
    ReplicaUnavailableError,
    params_checksum,
)
from apex_tpu_torch.utils.integrity import (
    IntegrityError,
    payload_checksum,
    seal_record,
    verify_payload,
    verify_record,
)


def _device_fault(e: BaseException) -> bool:
    """A real CUDA error: sticky in the process's context, so no
    in-process replica survives it (ROADMAP C11)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


# the internal tenant SDC replays run under on the verifier: real
# tenants' quotas/ledgers must never be charged for verification
# traffic (see _launch_replay)
_SDC_TENANT = "__sdc__"


class FleetFailedError(RuntimeError):
    """No replica is alive to serve (or to receive a failover's
    re-homed requests) and ``FleetConfig.respawn`` is off — the fleet
    itself is down. Carries nothing recoverable: recovery at this
    level is the operator's (restart the fleet; accepted-but-unfinished
    requests are in the router's hands, not lost, but nothing can run
    them)."""


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The router's knobs (docs/fleet.md). Engine-level behavior —
    pool geometry, speculation, overload ladder, per-replica quotas —
    stays on the shared :class:`EngineConfig` every replica is built
    from (equal configs, equal seeds: that equality is what makes
    migration resume bit-identically)."""

    # replicas spawned at construction; each is a full InferenceEngine
    # over the same (model, EngineConfig)
    num_replicas: int = 2
    # placement score = affinity_weight * (cached prompt fraction)
    #                 - load_weight * (relative backlog); see _route
    affinity_weight: float = 1.0
    load_weight: float = 1.0
    # consecutive no-progress ticks (replica holds work, step() keeps
    # returning False) before the health probe declares it dead. An
    # exception escaping step() is death immediately.
    health_patience: int = 2
    # spawn a fresh engine into a dead replica's slot at failover (the
    # fresh replica joins the survivors as a re-homing target). Off by
    # default: a crash loop would respawn forever; on, the fleet
    # tolerates any number of sequential replica deaths.
    respawn: bool = False
    # router-level poison quarantine: a request whose replica dies
    # this many times is terminal-failed ("failed", tokens kept)
    # instead of re-injected — one poison request must not cascade
    # through every replica.
    max_request_failovers: int = 2
    # ship the prompt's KV payloads through the spill tier at
    # migration (export_prefix_payloads -> import_prefix_payloads), so
    # the target re-admits by upload instead of recompute. Needs a
    # spill tier (EngineConfig.spill_max_bytes) on both ends; silently
    # skipped otherwise — transport is an optimization, never a
    # dependency.
    migrate_spill_payloads: bool = True
    # FLEET-WIDE tenant quotas, enforced at the router's door against
    # aggregates across replicas (waiting depth summed, resident
    # charge summed, token rate from the router's own estimator).
    # Independent of EngineConfig.tenant_quotas (per-replica bounds).
    tenant_quotas: Optional[Mapping[str, TenantQuota]] = None
    # time constant of the router's per-tenant token-rate estimator
    # (same math as the engine's: decay exp(-dt/tau), each delivered
    # token adds 1/tau)
    tenant_rate_tau_s: float = 1.0
    # -- fleet SDC detection (docs/fleet.md, docs/robustness.md) -------
    # Every N router ticks, replay one sampled COMPLETED request on a
    # second replica and compare token streams bit-for-bit: equal
    # configs + arrival-keyed sampling make any divergence a defect by
    # construction (a flaky chip, host-RAM rot — the silent failure
    # mode the health probe cannot see), so the diverging request's
    # ORIGINAL owner is marked suspect and retired through the
    # kill/failover path with its host state UNTRUSTED (fresh
    # re-injection — a corrupt replica's checkpoint proves nothing).
    # Replays are eligibility-gated to where bit-identity is certified:
    # greedy requests always, sampled ones only without speculation
    # (speculative span boundaries are schedule-dependent). None = off
    # (the default; the cross-check consumes real verifier capacity).
    sdc_check_interval_ticks: Optional[int] = None
    # -- process replicas (docs/fleet.md, "Process replicas") ----------
    # "in_process" drives InferenceEngine objects in the router's own
    # process (the default, unchanged); "process" runs each replica as
    # a child OS process behind ProcessReplica — same surface, real
    # isolation, real SIGKILL. Process mode requires FleetRouter's
    # ``model_spec`` (the child rebuilds the weights from it and the
    # boot handshake proves they match).
    replica_mode: str = "in_process"
    # per-RPC response deadline for process replicas; an overrun marks
    # the child unresponsive and drives the normal failover path
    # (generous by default: a child's FIRST step compiles the engine
    # programs)
    rpc_timeout_s: float = 300.0
    # resends of one RPC (same id — the worker dedupes) after a torn/
    # rotted response frame, before the replica is declared dead
    rpc_retries: int = 2
    # -- elastic autoscaling (docs/fleet.md, "Autoscaler") -------------
    # the control signal is mean queue depth per alive replica, read
    # each router tick. Above the high watermark for
    # ``autoscale_patience`` CONSECUTIVE ticks -> spawn one replica
    # (prefix-cache warmed from the survivors); below the low
    # watermark as long -> retire one via drain_replica(retire=True).
    # None disables the corresponding direction (both None: no
    # autoscaler at all — certified bit-identical to never setting
    # them). Hysteresis = the patience debounce + the watermark gap
    # (validated: high > low) + min/max bounds.
    autoscale_high_watermark: Optional[float] = None
    autoscale_low_watermark: Optional[float] = None
    autoscale_patience: int = 3
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: Optional[int] = None
    # -- disaggregated prefill/decode roles (docs/fleet.md,
    # "Disaggregated roles") ------------------------------------------
    # None (the default): every replica is colocated ("mixed" — runs
    # prefill AND decode, exactly today's fleet, certified
    # bit-identical). A sequence of "prefill"/"decode", one per
    # replica (at least one of each), splits the fleet into
    # specialists: new prompts place onto prefill replicas by queue
    # depth, a prefill replica's started requests hand off each tick
    # to a decode replica through the checksummed migration transport
    # (KV payloads ride the spill tier — the decode side re-admits as
    # a prefix hit instead of recomputing), and decode placement
    # ranks decode replicas only (affinity + load; prefill
    # specialists are never probed). Roles are PLACEMENT policy, not
    # capability: failover falls back to any survivor when a role
    # group empties, preserving the zero-lost contract. Requires
    # EngineConfig.enable_prefix_caching (the handoff's transport and
    # the decode side's prefix-hit admit are both keyed by the chain
    # hashes); a spill tier (spill_max_bytes) makes the handoff carry
    # KV instead of recomputing, and is strongly recommended.
    replica_roles: Optional[Sequence[str]] = None
    # -- fleet-global shared prefix tier (docs/fleet.md, "Shared
    # prefix tier") ----------------------------------------------------
    # byte budget of the router-owned SharedPrefixStore: ONE shared,
    # deduped, checksummed KV tier across all replicas, fed by replica
    # spill evictions and finished-prefill handoffs and probed at
    # placement — a prefix prefilled on any replica is warm
    # fleet-wide, so an affinity-blind route still lands warm. None
    # (the default): no shared tier, certified bit-identical to the
    # tier-less fleet. Requires EngineConfig.enable_prefix_caching
    # (entries are content-addressed by the chain hashes); replicas
    # need a local spill tier (EngineConfig.spill_max_bytes) to
    # receive seeds — without one a shared hit silently degrades to
    # recompute (the tier is an optimization, never a dependency).
    shared_prefix_bytes: Optional[int] = None
    # scrub coverage: shared-tier entries re-verified against their
    # put-time checksums each router tick, round-robin from where the
    # last pass stopped (the engine spill scrubber's discipline,
    # walked by the router). 0 disables the shared scrub.
    shared_scrub_blocks: int = 8

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {self.num_replicas}")
        for name in ("affinity_weight", "load_weight"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        if self.health_patience < 1:
            raise ValueError(
                f"health_patience must be >= 1, got "
                f"{self.health_patience}")
        if self.max_request_failovers < 1:
            raise ValueError(
                f"max_request_failovers must be >= 1, got "
                f"{self.max_request_failovers}")
        if self.tenant_quotas is not None:
            for t, q in self.tenant_quotas.items():
                if not isinstance(q, TenantQuota):
                    raise ValueError(
                        f"tenant_quotas[{t!r}] must be a TenantQuota, "
                        f"got {type(q).__name__}")
                q.validate(t)
        if self.tenant_rate_tau_s <= 0:
            raise ValueError(
                f"tenant_rate_tau_s must be > 0, got "
                f"{self.tenant_rate_tau_s}")
        if (self.sdc_check_interval_ticks is not None
                and self.sdc_check_interval_ticks < 1):
            raise ValueError(
                f"sdc_check_interval_ticks must be >= 1 (or None for "
                f"no cross-checking), got "
                f"{self.sdc_check_interval_ticks}")
        if self.replica_mode not in ("in_process", "process"):
            raise ValueError(
                f"replica_mode must be 'in_process' or 'process', got "
                f"{self.replica_mode!r}")
        if self.rpc_timeout_s <= 0:
            raise ValueError(
                f"rpc_timeout_s must be > 0, got {self.rpc_timeout_s}")
        if self.rpc_retries < 0:
            raise ValueError(
                f"rpc_retries must be >= 0, got {self.rpc_retries}")
        hi, lo = (self.autoscale_high_watermark,
                  self.autoscale_low_watermark)
        if hi is not None and lo is not None and not hi > lo:
            raise ValueError(
                f"autoscale_high_watermark ({hi}) must be strictly "
                f"above autoscale_low_watermark ({lo}) — the gap is "
                "half the anti-flap hysteresis")
        if self.autoscale_patience < 1:
            raise ValueError(
                f"autoscale_patience must be >= 1, got "
                f"{self.autoscale_patience}")
        if self.autoscale_min_replicas < 1:
            raise ValueError(
                f"autoscale_min_replicas must be >= 1, got "
                f"{self.autoscale_min_replicas}")
        if (self.autoscale_max_replicas is not None
                and self.autoscale_max_replicas
                < self.autoscale_min_replicas):
            raise ValueError(
                f"autoscale_max_replicas "
                f"({self.autoscale_max_replicas}) must be >= "
                f"autoscale_min_replicas "
                f"({self.autoscale_min_replicas})")
        if self.replica_roles is not None:
            roles = tuple(self.replica_roles)
            object.__setattr__(self, "replica_roles", roles)
            if len(roles) != self.num_replicas:
                raise ValueError(
                    f"replica_roles must list one role per replica "
                    f"({self.num_replicas}), got {len(roles)}")
            bad = [r for r in roles if r not in ("prefill", "decode")]
            if bad:
                raise ValueError(
                    f"replica_roles entries must be 'prefill' or "
                    f"'decode', got {bad[0]!r}")
            for need in ("prefill", "decode"):
                if need not in roles:
                    raise ValueError(
                        f"replica_roles needs at least one {need!r} "
                        "replica: a disaggregated fleet without one "
                        "can accept work it can never finish")
        if (self.shared_prefix_bytes is not None
                and self.shared_prefix_bytes < 1):
            raise ValueError(
                f"shared_prefix_bytes must be >= 1 (or None for no "
                f"shared tier), got {self.shared_prefix_bytes}")
        if self.shared_scrub_blocks < 0:
            raise ValueError(
                f"shared_scrub_blocks must be >= 0, got "
                f"{self.shared_scrub_blocks}")


@dataclasses.dataclass
class _Replica:
    """One replica slot: the engine plus the router's health view.
    ``mode`` is recorded at spawn so a dead slot (engine dropped)
    still reports what it was."""

    engine: Optional[InferenceEngine]
    alive: bool = True
    stall_streak: int = 0
    routed: int = 0
    error: Optional[str] = None
    mode: str = "in_process"
    # "mixed" (colocated, the default), or the specialist role from
    # FleetConfig.replica_roles; a respawn into the slot keeps it
    role: str = "mixed"


class FleetRouter:
    """Drive N :class:`InferenceEngine` replicas as one serving
    surface. Usage mirrors the engine::

        fleet = FleetRouter(model, EngineConfig(...),
                            FleetConfig(num_replicas=3))   # on the card
        fleet.add_request(Request("a", prompt))
        results = fleet.run(return_status=True)

    ``device`` is where every replica serves (the CUDA card unless the
    caller asks for another) and ``mesh`` (a :func:`~apex_tpu_torch.
    serving.mesh.build_mesh` grid of ``engine_config.mesh_shape``) the
    one grid every replica runs over; by default the engine's own
    default for ``device``. ``drafters`` / ``faults`` are optional
    per-replica lists (killing replica 1 must not fault replica 0);
    ``clock`` is the shared injectable clock; ``obs`` an optional
    :class:`~apex_tpu_torch.observability.Observability` whose flight
    recorder receives the router's events (``replica_down``,
    ``failover``, ``migrate``, ``sdc_suspect``, ``shared_publish``,
    ``shared_hit``, ``replica_spawn``, ``replica_retire``,
    ``rpc_timeout``, ``shed``, ...; replica engines take observers of
    their own). Process mode (``FleetConfig.replica_mode="process"``)
    needs ``model_spec`` (:func:`~apex_tpu_torch.serving.process_replica.
    gpt_model_spec`, from which each child rebuilds ``model``'s weights)
    and, with a custom ``clock``, ``child_clock``."""

    def __init__(self, model, engine_config: EngineConfig,
                 fleet_config: Optional[FleetConfig] = None, *,
                 device=None, mesh=None,
                 drafters: Optional[Sequence] = None,
                 faults: Optional[Sequence] = None,
                 clock=None, obs=None,
                 model_spec: Optional[Dict] = None,
                 child_clock: Optional[Dict] = None):
        self.model = model
        self.engine_config = engine_config
        self.config = fleet_config if fleet_config is not None \
            else FleetConfig()
        self._clock = time.monotonic if clock is None else clock
        self._obs = obs
        if obs is not None:
            obs.use_clock(self._clock)
        n = self.config.num_replicas
        for name, xs in (("drafters", drafters), ("faults", faults)):
            if xs is not None and len(xs) != n:
                raise ValueError(
                    f"{name} must list one entry per replica "
                    f"({n}), got {len(xs)}")
        self._drafters = (list(drafters) if drafters is not None
                          else [None] * n)
        self._faults = (list(faults) if faults is not None
                        else [None] * n)
        # ONE serving mesh, threaded through every replica and respawn:
        # equal mesh and config keep migration and failover records
        # replayable bit for bit across replicas, and the in-process
        # fleet shares the device set. Everything the router does
        # (placement, checkpoints, migration, cross-checks) is host-side
        # and mesh-agnostic.
        if mesh is not None:
            if tuple(mesh.mesh_shape) != tuple(engine_config.mesh_shape):
                raise ValueError(
                    f"mesh= has shape {tuple(mesh.mesh_shape)}, the "
                    f"engine config's mesh_shape is "
                    f"{tuple(engine_config.mesh_shape)}")
            if device is not None and torch.device(device).type \
                    != mesh.device(0, 0).type:
                raise ValueError(
                    f"device={device!r} does not match the mesh's shard "
                    f"(0, 0) device {mesh.device(0, 0)}")
            device = mesh.device(0, 0)
        self.device = resolve_device(device)
        if mesh is None:
            mesh = build_mesh(
                engine_config.mesh_shape,
                devices=([self.device] if engine_config.mesh_shape
                         == (1, 1) else None))
        self.mesh = mesh
        # -- process mode: how a child rebuilds the model, and the
        # children's clock (a parent lambda cannot cross a process
        # boundary, so a custom router clock must name theirs)
        self._model_spec = model_spec
        self._child_clock = child_clock
        self._params_checksum: Optional[str] = None
        if self.config.replica_mode == "process":
            if model_spec is None:
                raise ValueError(
                    "replica_mode='process' requires model_spec (see "
                    "serving.process_replica.gpt_model_spec): the "
                    "child must be able to rebuild the weights")
            if any(d is not None for d in self._drafters):
                raise ValueError(
                    "custom drafter objects cannot cross the process "
                    "boundary; children build the default NgramDrafter "
                    "from EngineConfig.spec_tokens")
            if clock is not None and child_clock is None:
                raise ValueError(
                    "replica_mode='process' with a custom clock needs "
                    "child_clock (e.g. {'kind': 'constant', 't': 0.0})"
                    " — the children cannot inherit a parent lambda")
            # the representation the replicas serve: under
            # weight_quantization the child quantizes its rebuilt weights
            # the same deterministic way before hashing
            self._params_checksum = params_checksum(
                model,
                weight_quantization=engine_config.weight_quantization)
        else:
            if child_clock is not None:
                raise ValueError(
                    "child_clock is only meaningful with "
                    "replica_mode='process'")
            for plan in self._faults:
                if any(s.site == "wire"
                       for s in getattr(plan, "specs", ()) or ()):
                    raise ValueError(
                        "'wire' fault sites need "
                        "replica_mode='process': an in-process "
                        "replica has no frame path to attack")
        # -- disaggregated roles (docs/fleet.md, "Disaggregated
        # roles"): the per-slot role assignment, parallel to
        # self.replicas (autoscaled slots append; respawns keep the
        # slot's role). Colocated fleets run every slot as "mixed".
        self._roles_enabled = self.config.replica_roles is not None
        if self._roles_enabled and not engine_config.enable_prefix_caching:
            raise ValueError(
                "replica_roles requires "
                "EngineConfig.enable_prefix_caching: the prefill->"
                "decode handoff transports KV through the chain-hash-"
                "keyed prefix index, and the decode side admits the "
                "handoff as a prefix hit")
        self._roles: List[str] = (list(self.config.replica_roles)
                                  if self._roles_enabled
                                  else ["mixed"] * n)
        if (self.config.shared_prefix_bytes is not None
                and not engine_config.enable_prefix_caching):
            raise ValueError(
                "shared_prefix_bytes requires "
                "EngineConfig.enable_prefix_caching: the shared tier "
                "is content-addressed by the prefix chain hashes")
        # process children boot together: every init frame goes out
        # before the first hello is read
        self.replicas: List[_Replica] = []
        try:
            for i in range(n):
                self.replicas.append(self._spawn(i, wait=False))
            for rep in self.replicas:
                if rep.mode == "process":
                    rep.engine.await_hello()
        except BaseException:
            for rep in self.replicas:
                if rep.mode == "process":
                    rep.engine.kill()
            raise
        # fleet-wide request tracking: owner replica per live uid, the
        # router's own Request copy (the failover re-injection source
        # for accepts the checkpoint never saw), terminal results, and
        # the per-uid failover tally backing the poison quarantine
        self._owner: Dict[str, int] = {}
        self._requests: Dict[str, Request] = {}
        self._results: Dict[str, List[int]] = {}
        self._statuses: Dict[str, str] = {}
        self._refails: Dict[str, int] = {}
        self._stream: List[Tuple[str, int, bool]] = []
        # the delivery watermark: per live uid, the tokens the router
        # has already delivered (also the failover re-injection
        # history for accepts no checkpoint saw) and the owning
        # engine's emission cursor — a re-homed request re-deriving
        # tokens the dead replica already streamed resumes BELOW the
        # watermark, and those replays are suppressed (the stream
        # feed stays exactly-once for tokens) and never re-counted by
        # the tenant rate estimator
        self._delivered: Dict[str, List[int]] = {}
        self._emit_pos: Dict[str, int] = {}
        # the fleet-wide tenant rate estimator + the router-door tally
        self._tenant_rate: Dict[str, float] = {}
        self._tenant_rate_t: Dict[str, float] = {}
        self._tenant_status: Dict[str, Dict[str, int]] = {}
        self._num_ticks = 0
        self._num_accepted = 0
        self._num_terminal = 0
        self._num_routed = 0
        self._num_affinity_hits = 0
        self._num_failovers = 0
        self._num_replicas_down = 0
        self._num_respawns = 0
        self._num_migrations = 0
        self._num_migrated_requests = 0
        self._num_reinjected_requests = 0
        self._num_duplicate_results = 0
        self._num_router_failed = 0
        self._num_rejected_queue_full = 0
        self._num_throttled = 0
        # -- data integrity (docs/robustness.md, "Data integrity") -----
        # checkpoints the failover verification refused, migration/
        # failover imports a target refused on a checksum mismatch,
        # and the SDC cross-check's bookkeeping: per-live-uid arrival
        # identity (the replay key), a bounded queue of completed
        # requests awaiting a cross-check, and the in-flight replays
        # keyed by their private "__sdc__N" uids
        self._num_corrupt_checkpoints = 0
        self._num_refused_imports = 0
        self._num_sdc_checks = 0
        self._num_sdc_suspects = 0
        # -- process replicas + autoscaler ------------------------------
        self._num_spawned = 0
        self._num_retired = 0
        self._num_rpc_retries = 0
        self._num_rpc_timeouts = 0
        self._autoscale_hi_streak = 0
        self._autoscale_lo_streak = 0
        # per-role watermark streaks (colocated fleets have the single
        # role "mixed", which mirrors into the scalar streaks above —
        # the signal and behavior reduce exactly to the pre-role
        # autoscaler)
        self._as_hi_streaks: Dict[str, int] = {}
        self._as_lo_streaks: Dict[str, int] = {}
        # -- disaggregation counters (docs/fleet.md) --------------------
        self._num_handoffs = 0
        self._num_handoff_requests = 0
        self._num_handoff_bytes = 0
        self._num_affinity_probes_skipped = 0
        # -- fleet-global shared prefix tier (docs/fleet.md, "Shared
        # prefix tier"): the router-owned store, the per-slot ledger of
        # hashes each replica already published (publish-once per
        # slot: refcounts mean "distinct slots holding these bytes",
        # and the eviction sweep must not re-count a resident entry
        # every tick), and the flow counters. The hash-walk counter is
        # unconditional: it pins the placement hot path's one-walk
        # bound whether or not the tier is on.
        self._shared: Optional[SharedPrefixStore] = None
        self._published: List[set] = [set() for _ in range(n)]
        self._num_shared_publishes = 0
        self._num_shared_hits = 0
        self._num_shared_scrub_blocks_verified = 0
        self._num_hash_walks = 0
        if self.config.shared_prefix_bytes is not None:
            self._shared = SharedPrefixStore(
                self.config.shared_prefix_bytes,
                verify=engine_config.verify_artifacts,
                on_corrupt=self._note_shared_corrupt)
        self._sdc_enabled = \
            self.config.sdc_check_interval_ticks is not None
        self._sdc_arrivals: Dict[str, int] = {}
        self._sdc_queue: deque = deque(maxlen=32)
        self._sdc_pending: Dict[str, Dict] = {}
        self._sdc_seq = 0

    def _spawn(self, idx: int, wait: bool = True) -> _Replica:
        role = self._roles[idx]
        if self.config.replica_mode == "process":
            eng = ProcessReplica(
                self.engine_config, self._model_spec,
                device=self.device,
                mesh_devices=[d for row in self.mesh.devices for d in row],
                faults=self._faults[idx],
                clock_spec=self._child_clock,
                rpc_timeout_s=self.config.rpc_timeout_s,
                rpc_retries=self.config.rpc_retries,
                expect_params_checksum=self._params_checksum,
                on_retry=self._note_rpc_retry,
                on_timeout=lambda i=idx: self._note_rpc_timeout(i),
                wait=wait)
            return _Replica(engine=eng, mode="process", role=role)
        return _Replica(engine=InferenceEngine(
            self.model, self.engine_config,
            drafter=self._drafters[idx], faults=self._faults[idx],
            clock=self._clock, device=self.device, mesh=self.mesh),
            mode="in_process", role=role)

    def _note_rpc_retry(self) -> None:
        self._num_rpc_retries += 1

    def _note_rpc_timeout(self, idx: int) -> None:
        self._num_rpc_timeouts += 1
        if self._obs is not None:
            self._obs.record("rpc_timeout", replica=idx)

    # -- placement ---------------------------------------------------------

    def _alive(self) -> List[Tuple[int, _Replica]]:
        return [(i, r) for i, r in enumerate(self.replicas)
                if r.alive and r.engine is not None]

    def _seq_hashes(self, tokens: Sequence[int]) -> List[str]:
        # counted (stats()["num_hash_walks"]) so the placement hot
        # path's bound — ONE chain-hash walk per placement decision —
        # stays pinned by test instead of regressing silently
        self._num_hash_walks += 1
        return seq_block_hashes(tokens, self.engine_config.block_size)

    def _ranked(self, seq: Sequence[int],
                stage: Optional[str] = None,
                hashes: Optional[List[str]] = None
                ) -> List[Tuple[int, int]]:
        """Alive replicas as ``(index, matched_blocks)``, best placement
        first (docs/fleet.md, placement score)::

            score(r) = affinity_weight * cached_fraction(r)
                     - load_weight    * backlog_norm(r)

        ``cached_fraction`` = tokens the replica's prefix index + spill
        tier could serve without recompute, over the sequence length;
        ``backlog_norm`` = (queue depth + active lanes) scaled by the
        replica's service EWMAs relative to the fleet mean (a slow
        replica's backlog weighs more), over ``max_batch``. Ties break
        toward the smaller backlog, then the lower index —
        deterministic, and exactly "replica 0" for a 1-replica fleet.

        With ``FleetConfig.replica_roles`` set, placement is
        TWO-STAGE (docs/fleet.md, "Disaggregated roles"): stage
        ``"prefill"`` (new prompts, waiting-entry re-homes) ranks the
        prefill specialists by backlog alone — no affinity probes; a
        specialist fleet's prefill side holds no stable prefix set
        worth scoring — and stage ``"decode"`` (handoffs, mid-decode
        re-homes) ranks the decode specialists by the full
        affinity+load score, SKIPPING the probe of every prefill
        specialist (counted in ``stats()["num_affinity_probes_"
        "skipped"]``). A stage whose role group has no alive member
        falls back to ranking every survivor — roles are placement
        policy, not capability, and the zero-lost contract outranks
        specialization. Colocated fleets ignore ``stage`` entirely
        (bit-identical to the single-stage router).

        ``hashes`` is the prompt's precomputed chain (a caller that
        already walked it passes it in; one walk per placement
        decision). With the shared prefix tier on, its coverage folds
        into ``cached_fraction`` — the returned ``matched_blocks``
        stays the replica's LOCAL match (the shared-tier seeding
        starts where the local match ends)."""
        alive = self._alive()
        if not alive:
            raise FleetFailedError(
                "no replica alive to route to (respawn is off)")
        if self._roles_enabled and stage is not None:
            pool = [(i, rep) for i, rep in alive
                    if self.replicas[i].role == stage]
            if pool and stage == "prefill":
                loads = {i: rep.engine.load() for i, rep in pool}
                order = sorted(
                    (ld["queue_depth"] + ld["active_slots"], i)
                    for i, ld in loads.items())
                return [(i, 0) for _, i in order]
            if pool and stage == "decode":
                self._num_affinity_probes_skipped += (len(alive)
                                                      - len(pool))
                alive = pool
            # an empty role group (every specialist of that role is
            # down): degrade to the full-survivor ranking below
        if hashes is None:
            # callers that already walked the chain (migrate's payload
            # export, the shared-tier seeding in add_request) pass it
            # in — one walk per placement decision, never two
            hashes = self._seq_hashes(seq)
        loads = {i: rep.engine.load() for i, rep in alive}
        svc = {i: (ld["ewma_prefill_dispatch_s"]
                   + ld["ewma_decode_dispatch_s"])
               for i, ld in loads.items()}
        seen = [s for s in svc.values() if s > 0]
        mean_svc = (sum(seen) / len(seen)) if seen else 0.0
        bs = self.engine_config.block_size
        scored = []
        for i, rep in alive:
            ld = loads[i]
            matched = rep.engine.probe_prefix(hashes)
            covered = matched
            if self._shared is not None:
                # fold shared-tier coverage into cached_fraction: the
                # tier serves every replica equally, so the affinity
                # term stays honest about what a placement would NOT
                # recompute (an affinity-blind route still lands warm)
                # while load decides among equally-covered replicas
                covered += self._shared.probe(hashes, start=matched)
            affinity = (covered * bs) / max(len(seq), 1)
            backlog = ld["queue_depth"] + ld["active_slots"]
            # a replica with no EWMAs yet (cold, or freshly respawned)
            # weighs its backlog at the neutral 1.0 — NOT 0, which
            # would make its queue invisible to placement and funnel
            # every arrival at it until it jams
            rel = (svc[i] / mean_svc) if (mean_svc > 0
                                          and svc[i] > 0) else 1.0
            load = backlog * rel / max(self.engine_config.max_batch, 1)
            score = (self.config.affinity_weight * affinity
                     - self.config.load_weight * load)
            scored.append((-score, backlog, i, matched))
        scored.sort()
        return [(i, matched) for _, _, i, matched in scored]

    # -- the fleet door ----------------------------------------------------

    def _tenant_rate_now(self, tenant: str) -> float:
        r = self._tenant_rate.get(tenant, 0.0)
        if r == 0.0:
            return 0.0
        dt = max(0.0, self._clock() - self._tenant_rate_t[tenant])
        return r * math.exp(-dt / self.config.tenant_rate_tau_s)

    def _note_tenant_tokens(self, tenant: str, n: int) -> None:
        now = self._clock()
        tau = self.config.tenant_rate_tau_s
        r = self._tenant_rate.get(tenant, 0.0)
        if r:
            dt = max(0.0, now - self._tenant_rate_t[tenant])
            r *= math.exp(-dt / tau)
        self._tenant_rate[tenant] = r + n / tau
        self._tenant_rate_t[tenant] = now

    def _door_throttle_reason(self, request: Request) -> Optional[str]:
        """The FLEET-WIDE tenant-quota door check, against aggregates
        across replicas — the engine-level door (per-replica quotas)
        still runs behind it."""
        quotas = self.config.tenant_quotas
        q = None if quotas is None else quotas.get(request.tenant)
        if q is None:
            return None
        t = request.tenant
        alive = self._alive()
        if q.max_resident_blocks is not None:
            weight = (alive[0][1].engine.block_weight if alive else 1.0)
            worst = weight * blocks_needed(
                len(request.prompt) + request.max_new_tokens,
                self.engine_config.block_size)
            if worst > q.max_resident_blocks + 1e-9:
                return (f"needs up to {worst:g} block-units but is "
                        f"capped at max_resident_blocks="
                        f"{q.max_resident_blocks} fleet-wide")
            # the SUMMED check — the tenant's fractional resident
            # charge across every alive replica plus this request's
            # worst case must fit the fleet cap (the engine-level
            # quota holds an over-charge tenant at admission instead;
            # a fleet door has no queue to hold in, so it sheds)
            charge = sum(rep.engine.tenant_charge(t)
                         for _, rep in alive)
            if charge + worst > q.max_resident_blocks + 1e-9:
                return (f"holds {charge:.2f} resident block-units "
                        f"across the fleet and this request's worst "
                        f"case {worst:g} would break "
                        f"max_resident_blocks={q.max_resident_blocks}")
        if q.max_waiting is not None:
            depth = sum(rep.engine.tenant_depth(t)
                        for _, rep in alive)
            if depth >= q.max_waiting:
                return (f"already holds {depth} waiting entries across "
                        f"the fleet (max_waiting={q.max_waiting})")
        if q.tokens_per_s is not None:
            rate = self._tenant_rate_now(t)
            if rate > q.tokens_per_s:
                return (f"is over its fleet-wide token-rate budget "
                        f"({rate:.1f} > {q.tokens_per_s} tokens/s)")
        return None

    def add_request(self, request: Request) -> None:
        """Route one request to the best replica. Raises
        :class:`TenantThrottledError` when the FLEET-WIDE quota sheds
        it (terminal ``"throttled"``, drained by :meth:`run` — same
        contract as the engine door); a replica-level quota shed
        propagates from the chosen replica likewise. A replica whose
        queue is full is skipped for the next-best one;
        :class:`QueueFullError` raises only when EVERY alive replica
        is full (the fleet's backpressure signal). Duplicate live or
        undrained uids raise ``ValueError`` — uid uniqueness is
        fleet-wide."""
        uid = request.uid
        if uid in self._owner:
            raise ValueError(
                f"request uid {uid!r} is already live in the fleet; "
                "pick a distinct uid or wait for its terminal result")
        if uid in self._statuses:
            raise ValueError(
                f"request uid {uid!r} has a terminal result "
                f"({self._statuses[uid]!r}) awaiting drain; run() "
                "before reusing the uid")
        reason = self._door_throttle_reason(request)
        if reason is not None:
            object.__setattr__(request, "status", "throttled")
            self._record_result(uid, [], "throttled",
                                tenant=request.tenant)
            self._num_throttled += 1
            if self._obs is not None:
                self._obs.record("shed", uid=uid, reason="throttled")
            raise TenantThrottledError(
                f"request {uid!r} throttled: tenant "
                f"{request.tenant!r} {reason}")
        placed = None
        prompt = list(request.prompt)
        hashes: Optional[List[str]] = None
        if self._shared is not None:
            # ONE walk serves both the placement ranking and the
            # post-placement shared-tier seeding
            hashes = self._seq_hashes(prompt)
        for idx, matched in self._ranked(prompt, stage="prefill",
                                         hashes=hashes):
            try:
                arrival = self.replicas[idx].engine.add_request(request)
            except QueueFullError:
                continue
            placed = (idx, matched)
            break
        if placed is None:
            self._num_rejected_queue_full += 1
            raise QueueFullError(
                f"request {uid!r} rejected: every alive replica's "
                "waiting queue is at max_waiting")
        idx, matched = placed
        self._num_routed += 1
        if matched > 0:
            self._num_affinity_hits += 1
        if self._sdc_enabled:
            # the request's PRNG identity: what a completed token
            # stream replays from, bit-for-bit, on any equal-config
            # replica (the cross-check's soundness anchor)
            self._sdc_arrivals[uid] = int(arrival)
        self._owner[uid] = idx
        self._requests[uid] = request
        self.replicas[idx].routed += 1
        self._num_accepted += 1
        if hashes:
            # fleet-wide prefix hit: seed the chosen replica's local
            # spill tier with the shared-tier run extending its own
            # match, so its _admit re-admits by the one-scatter upload
            self._seed_from_shared(idx, hashes, matched)

    def try_add(self, request: Request) -> bool:
        """Non-raising variant, mirroring the engine's: False on a
        fleet/replica quota shed or a fleet-wide queue-full;
        validation errors still raise."""
        try:
            self.add_request(request)
        except (QueueFullError, TenantThrottledError):
            return False
        return True

    def abort(self, uid: str) -> bool:
        """Cancel a live request on its owning replica (terminal
        ``"cancelled"``, drained like any result). False for a uid the
        fleet does not currently own."""
        idx = self._owner.get(uid)
        if idx is None:
            return False
        rep = self.replicas[idx]
        if not rep.alive or rep.engine is None:
            return False
        return rep.engine.abort(uid)

    def owners(self) -> Dict[str, int]:
        """Live uid -> owning replica index (a copy) — a chaos test's
        victim bookkeeping, and an operator's 'where is my request'
        lookup."""
        return dict(self._owner)

    # -- the drive loop ----------------------------------------------------

    @property
    def has_work(self) -> bool:
        for rep in self.replicas:
            if not (rep.alive and rep.engine is not None):
                continue
            try:
                if rep.engine.has_work:
                    return True
            except ReplicaUnavailableError:
                # a dead process child IS work: the next step() runs
                # its failover (re-homing everything it owned)
                return True
        return False

    def step(self) -> bool:
        """One fleet tick: step every alive replica that holds work
        (catching replica death — exception escape or a
        ``health_patience`` no-progress streak — with failover), then
        drain every replica's stream events and terminal results into
        the router's fleet-wide maps. Returns whether anything
        progressed (a failover counts: it moved requests). With
        disaggregated roles the tick OPENS with the handoff sweep —
        started requests leave the prefill specialists before this
        tick's stepping, operating on last tick's fully-drained
        state."""
        self._num_ticks += 1
        self._handoff_tick()
        progressed = False
        for i in range(len(self.replicas)):
            rep = self.replicas[i]
            if not rep.alive or rep.engine is None:
                continue
            try:
                # has_work is inside the containment on purpose: for a
                # process replica it is an RPC, and a SIGKILLed child
                # surfaces ReplicaUnavailableError right here
                if not rep.engine.has_work:
                    rep.stall_streak = 0
                    continue
                p = rep.engine.step()
            except Exception as e:  # replica crash containment: any
                # escape (SimulatedCrash, CacheOutOfBlocks, a Python
                # error, a child's death) is THIS replica dying; a real
                # CUDA error in this process is every in-process
                # replica's (ROADMAP C11) and is not contained
                if rep.mode == "in_process" and _device_fault(e):
                    raise
                self._fail_replica(i, f"{type(e).__name__}: {e}")
                progressed = True
                continue
            if p:
                rep.stall_streak = 0
                progressed = True
            else:
                rep.stall_streak += 1
                if rep.stall_streak >= self.config.health_patience:
                    self._fail_replica(i, "no-progress stall")
                    progressed = True
        self._drain_outputs()
        self._shared_tick()
        self._autoscale_tick()
        self._maybe_sdc_check()
        return progressed

    def run(self, return_status: bool = False):
        """Drive the fleet until every accepted request is terminal.
        Same result contract as :meth:`InferenceEngine.run` — ``{uid:
        tokens}``, or ``{uid: RequestResult}`` with
        ``return_status=True`` — except fleet-wide. No stall guard is
        needed here: a stalled replica is a health event (patience,
        then failover), and a request that stalls every replica hits
        the ``max_request_failovers`` quarantine, so the loop always
        terminates (possibly in :class:`FleetFailedError` when the
        last replica dies with respawn off)."""
        while self.has_work:
            self.step()
        self._drain_outputs()
        out, self._results = self._results, {}
        statuses, self._statuses = self._statuses, {}
        self._stream = []
        if return_status:
            return {uid: RequestResult(tokens=toks,
                                       status=statuses.get(uid,
                                                           "finished"))
                    for uid, toks in out.items()}
        return out

    def pop_stream_events(self) -> List[Tuple[str, int, bool]]:
        """The fleet-wide streaming feed, concatenated across replicas
        in drain order. Token events are EXACTLY-ONCE even under
        failover: a re-homed request re-deriving tokens the dead
        replica already streamed resumes below the router's delivery
        watermark, and those replays are suppressed. Terminal
        ``(uid, -1, True)`` sentinels are best-effort — one can be
        lost with a crashing replica whose verdict the checkpoint
        adoption recovers — so terminal truth belongs to :meth:`run`
        (always exactly-once)."""
        out, self._stream = self._stream, []
        return out

    def _drain_outputs(self) -> None:
        for i, rep in self._alive():
            # re-check at use time: draining one replica can RETIRE
            # another mid-loop (an SDC verdict intercepted in its
            # results fails the diverging owner, whose engine may
            # already sit later in this snapshot of the alive list)
            if rep.alive and rep.engine is not None:
                try:
                    self._drain_replica_outputs(rep.engine)
                except ReplicaUnavailableError as e:
                    # a process child died between step and drain —
                    # same containment as a step()-time crash
                    self._fail_replica(i, f"{type(e).__name__}: {e}")

    def _drain_replica_outputs(self, eng: InferenceEngine) -> None:
        for uid, tok, last in eng.pop_stream_events():
            if uid in self._sdc_pending:
                # cross-check replay traffic: verification-internal,
                # never delivered (the client already received the
                # original stream)
                continue
            req = self._requests.get(uid)
            if tok >= 0 and req is not None:
                pos = self._emit_pos.get(uid, 0)
                self._emit_pos[uid] = pos + 1
                hist = self._delivered.setdefault(uid, [])
                if pos < len(hist):
                    # a failover re-derivation replaying a token the
                    # dead replica already streamed: below the
                    # delivery watermark — suppressed, so the stream
                    # feed stays exactly-once for tokens and the
                    # tenant rate estimator never double-counts
                    continue
                hist.append(int(tok))
                self._note_tenant_tokens(req.tenant, 1)
            self._stream.append((uid, tok, last))
        for uid, res in eng.pop_results().items():
            cand = self._sdc_pending.pop(uid, None)
            if cand is not None:
                self._finish_sdc_check(cand, res)
                continue
            self._maybe_capture_sdc(uid, res)
            self._record_result(uid, res.tokens, res.status)

    def _record_result(self, uid: str, tokens: Sequence[int],
                       status: str,
                       tenant: Optional[str] = None) -> None:
        """First terminal verdict wins, fleet-wide: failover
        re-derivation can produce a second (bit-identical) result for
        a uid the router already delivered — counted, dropped."""
        if uid in self._statuses:
            self._num_duplicate_results += 1
            return
        if tenant is None:
            req = self._requests.get(uid)
            tenant = req.tenant if req is not None else DEFAULT_TENANT
        self._results[uid] = [int(t) for t in tokens]
        self._statuses[uid] = status
        tally = self._tenant_status.setdefault(tenant, {})
        tally[status] = tally.get(status, 0) + 1
        if uid in self._owner:
            self._num_terminal += 1
        self._owner.pop(uid, None)
        self._requests.pop(uid, None)
        self._refails.pop(uid, None)
        self._delivered.pop(uid, None)
        self._emit_pos.pop(uid, None)
        self._sdc_arrivals.pop(uid, None)

    # -- fleet SDC detection (docs/fleet.md, docs/robustness.md) -----------

    def _maybe_capture_sdc(self, uid: str, res: RequestResult) -> None:
        """Queue a just-completed request as a cross-check candidate.
        Eligibility is where bit-identical replay is CERTIFIED: a
        ``"finished"`` verdict with tokens, a known arrival identity
        (failover re-injections drew a fresh arrival the router never
        saw — their streams mix two identities and are not replayable
        from scratch), and greedy sampling whenever speculation is on
        (speculative span boundaries are schedule-dependent, so only
        greedy streams are replica-invariant under speculation)."""
        if not self._sdc_enabled:
            return
        if res.status != "finished" or not res.tokens:
            return
        arrival = self._sdc_arrivals.get(uid)
        req = self._requests.get(uid)
        owner = self._owner.get(uid)
        if arrival is None or req is None or owner is None:
            return
        if (req.sampling.temperature > 0
                and self.engine_config.spec_tokens > 0):
            return
        self._sdc_queue.append({
            "uid": uid, "owner": int(owner), "arrival": int(arrival),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": (None if req.eos_token_id is None
                             else int(req.eos_token_id)),
            "sampling": {"temperature": float(req.sampling.temperature),
                         "top_k": int(req.sampling.top_k),
                         "top_p": float(req.sampling.top_p)},
            "priority": int(req.priority), "tenant": str(req.tenant),
            "tokens": [int(t) for t in res.tokens],
        })

    def _maybe_sdc_check(self) -> None:
        """Every ``sdc_check_interval_ticks`` router ticks, replay ONE
        queued candidate on a replica other than its owner. The replay
        record carries the ORIGINAL arrival (the PRNG identity), an
        empty history, and a private ``__sdc__N`` uid; it runs through
        the verifier's ordinary scheduling and its result is
        intercepted at the drain — never delivered, never counted as
        accepted. Equal configs make the verifier's stream a
        bit-for-bit oracle for the original."""
        interval = self.config.sdc_check_interval_ticks
        if interval is None or self._num_ticks % interval:
            return
        alive = self._alive()
        if len(alive) < 2:
            return
        while self._sdc_queue:
            cand = self._sdc_queue.popleft()
            owner = cand["owner"]
            rep = self.replicas[owner]
            if not rep.alive or rep.engine is None:
                continue    # the owner is already gone; nothing to vet
            verifiers = [i for i, _ in alive if i != owner]
            if not verifiers:
                return
            if self._launch_replay(cand, verifiers[0]):
                return      # one replay per interval — the budget

    def _launch_replay(self, cand: Dict, vidx: int) -> bool:
        """Import one replay record onto replica ``vidx`` and register
        the pending check. False when the replay record itself was
        refused in transit (its own "import" corruption) — the check
        is simply dropped."""
        ruid = f"__sdc__{self._sdc_seq}"
        self._sdc_seq += 1
        rec = seal_record({
            "uid": ruid, "prompt": list(cand["prompt"]),
            "max_new_tokens": cand["max_new_tokens"],
            "eos_token_id": cand["eos_token_id"],
            "sampling": dict(cand["sampling"]),
            "arrival": cand["arrival"],
            "priority": cand["priority"],
            # a dedicated INTERNAL tenant, not the original: the
            # replay must not charge the real tenant's resident-block
            # quota or delivered-token ledger on the verifier
            # (verification traffic the client never receives would
            # hold/throttle the tenant's own requests and inflate its
            # fleet-wide usage row). Unlisted and transient, so the
            # engine's idle-tenant pruning drops the row afterwards.
            # Tenant is never a sampling input, so replay identity is
            # unaffected.
            "tenant": _SDC_TENANT,
            "generated": [],
            # out-of-band of the verifier's DRR walk, like a
            # requeue: verification traffic must not contend for
            # (or distort) tenant fairness
            "drr_charged": True,
        })
        try:
            self.replicas[vidx].engine.import_requests([rec])
        except IntegrityError:
            return False
        cand["verifier"] = vidx
        self._sdc_pending[ruid] = cand
        self._num_sdc_checks += 1
        return True

    def _finish_sdc_check(self, cand: Dict, res: RequestResult) -> None:
        """Compare a drained replay against the original verdict. A
        non-"finished" replay (the verifier shed or timed it out) is
        inconclusive — no verdict, no retirement; a VOIDED check (the
        owner died of something else while the replay was in flight —
        or a respawn took its slot, which must not inherit the
        suspicion) is swallowed verdict-free. A token mismatch is
        PROOF of a defect (equal configs, equal PRNG identity) but
        does not say on WHICH side, so divergence ARBITRATES when a
        third replica exists: one confirmation replay on a replica
        independent of both owner and first verifier, and the side the
        majority contradicts retires —

        - confirmation == original  ⇒ the first VERIFIER diverged
          alone: it is the corrupt one;
        - confirmation != original  ⇒ two independent replicas
          contradict the owner's stream: the OWNER is the corrupt one.

        With only two replicas alive there is no arbiter and the owner
        retires (the documented asymmetry: a corrupt verifier then
        costs one healthy replica, and its own results keep failing
        later rounds). Retirement goes through the failover path with
        host state UNTRUSTED — checkpoints and buffered outputs of a
        silently-corrupting replica prove nothing, so its live
        requests re-inject fresh from the router's own copies (zero
        lost accepted requests)."""
        if cand.get("void") or res.status != "finished":
            return
        replay = [int(t) for t in res.tokens]
        if replay == cand["tokens"]:
            if cand.get("confirm") \
                    and cand.get("first_verifier") is not None:
                # the arbiter sides with the original: the FIRST
                # verifier is the one that computed a wrong stream
                self._retire_suspect(cand["first_verifier"],
                                     cand["uid"])
            return
        if not cand.get("confirm"):
            arbiters = [i for i, _ in self._alive()
                        if i != cand["owner"]
                        and i != cand.get("verifier")]
            # a failed confirm launch (the replay record itself rotted
            # in transit) must NOT drop the proven divergence: fall
            # through to the no-arbiter verdict instead
            if arbiters and self._launch_replay(
                    dict(cand, confirm=True,
                         first_verifier=cand.get("verifier")),
                    arbiters[0]):
                return
        self._retire_suspect(cand["owner"], cand["uid"])

    def _retire_suspect(self, idx: int, uid: str) -> None:
        rep = self.replicas[idx]
        if not rep.alive or rep.engine is None:
            return  # a verdict against a corpse is stale evidence
        self._num_sdc_suspects += 1
        if self._obs is not None:
            self._obs.record("sdc_suspect", replica=idx, uid=uid)
        self._fail_replica(idx, "sdc divergence",
                           read_host_state=False,
                           trust_state=False)

    def _note_refused_import(self, uid, detail: str) -> None:
        """The one funnel for refused-import bookkeeping (counter +
        recorder), shared by the migrate, failover-placement, and
        source-requeue refusal paths."""
        self._num_refused_imports += 1
        if self._obs is not None:
            self._obs.record("corruption_detected", site="import",
                             uid=uid, detail=str(detail))

    def _drop_sdc_for_replica(self, idx: int) -> None:
        """Forget cross-check state touching a dead replica: queued
        candidates whose owner it was (nothing left to vet — and a
        respawn into the slot must not inherit their suspicion) and
        in-flight replays it was verifying (their results died with
        it). Replays whose OWNER died stay in the pending map but are
        VOIDED: the replay request itself is still live on its
        verifier, so its eventual result must still be intercepted
        (swallowed verdict-free) — dropping the map entry would let a
        ``__sdc__`` uid fall through to the client-facing result maps."""
        if not self._sdc_enabled:
            return
        self._sdc_queue = deque(
            (c for c in self._sdc_queue if c["owner"] != idx),
            maxlen=self._sdc_queue.maxlen)
        self._sdc_pending = {
            r: c for r, c in self._sdc_pending.items()
            if c.get("verifier") != idx}
        for c in self._sdc_pending.values():
            if c["owner"] == idx:
                c["void"] = True
            elif c.get("confirm") and c.get("first_verifier") == idx:
                # the accused first verifier died of something else
                # mid-arbitration: its half of the verdict is moot (a
                # respawn into the slot must not inherit the blame);
                # the owner half still stands
                c["first_verifier"] = None

    # -- elastic autoscaling (docs/fleet.md, "Autoscaler") -----------------

    def _autoscale_tick(self) -> None:
        """One control-loop tick, run every router tick after the
        drain: read the signal (mean queue depth per alive replica —
        pure ``load()`` reads, so a disabled or never-firing
        autoscaler perturbs nothing, which is the identity cert),
        debounce it through the consecutive-tick patience counters,
        and act at most once — spawn on a sustained high-watermark
        breach, retire on a sustained low one. Both streaks reset
        after any action (a fresh replica deserves a fresh
        measurement), and the min/max bounds gate the STREAKS, not
        just the action, so a fleet pinned at a bound does not hold a
        primed trigger."""
        hi = self.config.autoscale_high_watermark
        lo = self.config.autoscale_low_watermark
        if hi is None and lo is None:
            return
        alive = self._alive()
        if not alive:
            return
        # the signal is PER-ROLE (docs/fleet.md, "Disaggregated
        # roles"): mean queue depth over the alive replicas of each
        # role, so a prefill backlog is never masked by idle decode
        # replicas (or vice versa). A colocated fleet has the single
        # role "mixed" — one group, the exact pre-role signal.
        groups: Dict[str, List] = {}
        for i, rep in alive:
            groups.setdefault(rep.role, []).append((i, rep))
        maxr = self.config.autoscale_max_replicas
        can_grow = maxr is None or len(alive) < maxr
        acted = False
        for role in sorted(groups):
            members = groups[role]
            try:
                depth = sum(rep.engine.load()["queue_depth"]
                            for _, rep in members) / len(members)
            except ReplicaUnavailableError:
                continue    # a child died mid-read; step() contains it
            if acted:
                continue    # one action per tick; later roles' streaks
                # simply hold (neither advanced nor disarmed)
            # shrink bounds: the fleet-wide floor, plus never the last
            # replica of a specialist role (a roleless fleet's single
            # "mixed" group is bounded by the floor alone)
            can_shrink = (len(alive)
                          > self.config.autoscale_min_replicas
                          and (not self._roles_enabled
                               or len(members) > 1))
            hi_s = self._as_hi_streaks.get(role, 0)
            lo_s = self._as_lo_streaks.get(role, 0)
            hi_s = (hi_s + 1 if (hi is not None and depth > hi
                                 and can_grow) else 0)
            lo_s = (lo_s + 1 if (lo is not None and depth < lo
                                 and can_shrink) else 0)
            if hi_s >= self.config.autoscale_patience:
                hi_s = lo_s = 0
                self._scale_up(role)
                acted = True    # at most one action per tick
            elif lo_s >= self.config.autoscale_patience:
                hi_s = lo_s = 0
                self._scale_down(role)
                acted = True
            self._as_hi_streaks[role] = hi_s
            self._as_lo_streaks[role] = lo_s
        # the pre-role scalar views (tests and dashboards read them;
        # exact for colocated fleets, the max across roles otherwise)
        self._autoscale_hi_streak = max(self._as_hi_streaks.values(),
                                        default=0)
        self._autoscale_lo_streak = max(self._as_lo_streaks.values(),
                                        default=0)

    def _scale_up(self, role: str = "mixed") -> None:
        """Append one fresh replica slot (same spawn path respawn
        uses) of the breaching role and warm its prefix cache from
        the survivors — an autoscaled newcomer should serve affinity
        traffic, not start from a cold index."""
        idx = len(self.replicas)
        self._drafters.append(None)
        self._faults.append(None)
        self._roles.append(role)
        self._published.append(set())
        self.replicas.append(self._spawn(idx))
        self._num_spawned += 1
        if self._obs is not None:
            self._obs.record("replica_spawn", replica=idx,
                             reason="autoscale", role=role)
        try:
            self._warm_replica(idx)
        except Exception:
            pass    # warm-up is an optimization, never a dependency

    def _warm_replica(self, idx: int) -> None:
        """Seed a newcomer's prefix cache with the KV payloads of live
        prompts (``export_prefix_payloads`` on each owner ->
        ``import_prefix_payloads`` on the newcomer) — the migration
        transport, reused as a warm-up. Needs a spill tier on both
        ends; silently a no-op otherwise."""
        if not self.config.migrate_spill_payloads:
            return
        target = self.replicas[idx].engine
        for uid, owner in sorted(self._owner.items()):
            rep = self.replicas[owner]
            req = self._requests.get(uid)
            if req is None or not rep.alive or rep.engine is None:
                continue
            payloads = rep.engine.export_prefix_payloads(
                self._seq_hashes(list(req.prompt)))
            if payloads:
                target.import_prefix_payloads(payloads)

    def _scale_down(self, role: str = "mixed") -> None:
        """Retire one replica of the under-loaded role through the
        clean drain-and-migrate path. The victim is deterministic:
        fewest owned live requests (cheapest drain), ties to the
        HIGHEST index (autoscaled slots retire before the original
        fleet)."""
        alive = [(i, rep) for i, rep in self._alive()
                 if rep.role == role]
        if not alive:
            return
        owned: Dict[int, int] = {i: 0 for i, _ in alive}
        for o in self._owner.values():
            if o in owned:
                owned[o] += 1
        victim = min((i for i, _ in alive),
                     key=lambda i: (owned[i], -i))
        try:
            self.drain_replica(victim, retire=True)
        except ValueError:
            return      # last-replica-with-work refusal: not this tick
        self._num_retired += 1
        if self._obs is not None:
            self._obs.record("replica_retire", replica=victim,
                             reason="autoscale", role=role)

    # -- fleet-global shared prefix tier (docs/fleet.md, "Shared
    # prefix tier") --------------------------------------------------------

    def _note_shared_corrupt(self, site: str, block_hash: str) -> None:
        """The shared store's ``on_corrupt`` hook (and the publish
        verifier's): surface every shared-tier detection to the flight
        recorder under a ``shared_``-prefixed site, mirroring the
        engine's one-funnel discipline. The discard count itself lives
        on the store (``num_shared_corrupt_discards``)."""
        if self._obs is not None:
            self._obs.record("corruption_detected",
                             site=f"shared_{site}",
                             detail=str(block_hash))

    def _publish_payload(self, block_hash: str, payload: Dict,
                         tenant: str) -> bool:
        """Verify one transported payload end-to-end (against the
        detached checksum the export attached), then publish it into
        the shared tier. A mismatch is transport rot: reported and
        skipped — the shared tier must never launder corrupt bytes
        fleet-wide, and a skip just means the block stays a miss."""
        payload = dict(payload)
        checksum = payload.pop("checksum", None)
        if (self.engine_config.verify_artifacts
                and checksum is not None):
            try:
                verify_payload(payload, checksum, "shared_publish")
            except IntegrityError:
                self._note_shared_corrupt("publish", block_hash)
                return False
        if self._shared.publish(block_hash, payload, tenant=tenant):
            self._num_shared_publishes += 1
            return True
        return False

    def _shared_tick(self) -> None:
        """The per-tick shared-tier sweep (a no-op with the tier off —
        certified bit-identical to the tier-less fleet). PUBLISH: every
        local-spill entry a replica holds that its slot has not
        published yet enters the tier — payloads ride
        ``export_prefix_payloads`` (the framed-RPC spill surface
        process replicas already speak), entries the tier already holds
        publish as dedupe references (no bytes moved). Then SCRUB
        ``shared_scrub_blocks`` entries round-robin (the engine spill
        scrubber's budgeted-cursor discipline, walked by the router)
        and audit the refcount/ownership/byte ledger."""
        if self._shared is None:
            return
        for i, rep in self._alive():
            try:
                spilled = rep.engine.spilled_hashes()
            except ReplicaUnavailableError:
                continue
            fresh = [h for h in spilled
                     if h not in self._published[i]]
            if not fresh:
                continue
            need = [h for h in fresh if h not in self._shared]
            payloads: Dict[str, Dict] = {}
            if need:
                try:
                    payloads = rep.engine.export_prefix_payloads(need)
                except ReplicaUnavailableError:
                    continue
            stored = 0
            nbytes = 0
            for h in fresh:
                if h in self._shared:
                    # content-addressed dedupe: the same hash from a
                    # second slot adds a reference and an ownership
                    # share, never a second copy
                    self._shared.publish(h, None, tenant=spilled[h])
                    self._published[i].add(h)
                    continue
                payload = payloads.get(h)
                if payload is None:
                    # rotted (and discarded) mid-export, or past an
                    # export gap: not published, retried next tick
                    continue
                if self._publish_payload(h, payload, spilled[h]):
                    stored += 1
                    nbytes += self._payload_nbytes({h: payload})
                self._published[i].add(h)
            if stored and self._obs is not None:
                self._obs.record("shared_publish", replica=i,
                                 blocks=stored, bytes=nbytes)
        n = self.config.shared_scrub_blocks
        if n > 0:
            verified, _ = self._shared.scrub(n)
            self._num_shared_scrub_blocks_verified += verified
        # the dedupe/byte ledger audit every tick — cheap, host-side,
        # and a violated shared ledger has no safe degradation
        self._shared.check_integrity()

    def _seed_from_shared(self, idx: int, hashes: Sequence[str],
                          matched: int) -> int:
        """The fleet-wide prefix HIT path: fetch the contiguous
        shared-tier run extending what replica ``idx`` already serves
        (device index, then local spill — ``matched``) and seed it
        into the replica's local spill tier through
        ``import_prefix_payloads`` (the framed-RPC spill transport in
        process mode). The replica's next ``_admit`` finds a
        contiguous spilled run and re-admits it via the existing
        one-scatter upload path — token-identical to recompute, by the
        spill-tier equivalence cert. Returns blocks accepted (0
        without a local spill tier on the replica: the tier is an
        optimization, never a dependency)."""
        if self._shared is None:
            return 0
        payloads: Dict[str, Dict] = {}
        n = int(matched)
        while n < len(hashes) and hashes[n] in self._shared:
            payload = self._shared.fetch(hashes[n])
            if payload is None:
                break   # rot: discarded with its references — a miss
            if self.engine_config.verify_artifacts:
                # the detached transport checksum, same as the
                # replica-to-replica export path — the importing
                # engine verifies the bytes end to end
                payload["checksum"] = payload_checksum(payload)
            payloads[hashes[n]] = payload
            n += 1
        if not payloads:
            return 0
        try:
            accepted = self.replicas[idx].engine.import_prefix_payloads(
                payloads)
        except ReplicaUnavailableError:
            return 0
        if accepted:
            self._num_shared_hits += accepted
            if self._obs is not None:
                self._obs.record("shared_hit", replica=idx,
                                 blocks=accepted,
                                 bytes=self._payload_nbytes(payloads))
        return accepted

    # -- disaggregated handoff (docs/fleet.md, "Disaggregated roles") ------

    def _handoff_tick(self) -> None:
        """The per-tick prefill->decode handoff sweep: every started
        request (prefill complete, first token known) on a
        prefill-specialist replica migrates to a decode specialist
        through the checksummed drain-and-migrate transport — records
        carry the emitted tokens and arrival identity (resume is
        bit-identical), KV payloads ride the spill
        tier so the decode side re-admits as a prefix hit instead of
        recomputing, and a refused (corrupt) import leaves the request
        on its source exactly like any migration refusal. A no-op for
        colocated fleets."""
        if not self._roles_enabled:
            return
        for i, rep in self._alive():
            if rep.role != "prefill" or not rep.alive \
                    or rep.engine is None:
                continue
            try:
                uids = [u for u in rep.engine.decoding_uids()
                        if u not in self._sdc_pending]
            except ReplicaUnavailableError as e:
                self._fail_replica(i, f"{type(e).__name__}: {e}")
                continue
            if uids:
                try:
                    self.migrate(uids, i, _handoff=True)
                except ReplicaUnavailableError as e:
                    self._fail_replica(i, f"{type(e).__name__}: {e}")

    @staticmethod
    def _payload_nbytes(payloads: Mapping[str, Dict]) -> int:
        """Approximate wire size of a handoff's KV payloads — array
        leaves by their buffer size, strings/bytes by length (the
        ``num_handoff_bytes`` gauge; observability, not billing)."""
        n = 0
        for payload in payloads.values():
            for v in payload.values():
                if hasattr(v, "nbytes"):
                    n += int(v.nbytes)
                elif isinstance(v, (bytes, bytearray, str)):
                    n += len(v)
                elif isinstance(v, (list, tuple)):
                    n += 8 * len(v)
        return n

    # -- health, failover, migration ---------------------------------------

    def _fail_replica(self, idx: int, reason: str,
                      read_host_state: bool = True,
                      trust_state: bool = True) -> None:
        """Declare a replica dead and fail over. ``read_host_state``
        distinguishes the two death modes: an in-process exception
        escape leaves the engine OBJECT's host bookkeeping intact —
        :meth:`InferenceEngine.checkpoint` is pure host reads, so a
        fresh checkpoint beats a stale one — while a simulated hard
        kill (:meth:`kill_replica`) forbids touching the corpse and
        recovery runs from ``last_checkpoint`` alone.
        ``trust_state=False`` is the SDC-suspect mode: nothing the
        replica wrote is believed — no drain, no checkpoint (its
        records carry tokens a corrupt chip computed) — and every
        live request it owned re-injects FRESH from the router's own
        copies. Whatever checkpoint IS used must verify its content
        checksum first (``verify_artifacts``): a corrupt checkpoint
        reads as no checkpoint, the same fresh re-injection path."""
        rep = self.replicas[idx]
        rep.alive = False
        rep.error = reason
        # the slot's publish ledger dies with its spill tier: a
        # respawn into the slot starts cold and may legitimately
        # re-publish (a fresh reference from a fresh holder)
        self._published[idx] = set()
        self._num_replicas_down += 1
        if self._obs is not None:
            self._obs.record("replica_down", replica=idx,
                             reason=reason, role=rep.role)
        snap = None
        if rep.engine is not None and trust_state:
            snap = rep.engine.last_checkpoint
            if read_host_state:
                # the engine OBJECT survived (in-process death): its
                # buffered stream events and terminal results are
                # intact host state — collect them BEFORE the fresh
                # checkpoint, or the checkpoint's records would carry
                # tokens the router never delivered and the delivery
                # watermark would anchor past them (a silent token
                # gap in the exactly-once stream feed)
                try:
                    self._drain_replica_outputs(rep.engine)
                except Exception:
                    pass
                try:
                    snap = rep.engine.checkpoint()
                except Exception:
                    pass  # keep the periodic checkpoint (or None)
        if not read_host_state:
            rep.engine = None   # the process is gone; so is the object
        elif rep.mode == "process" and rep.engine is not None:
            # a process replica's corpse is a real child process:
            # whatever could be read was read above — now reap it (a
            # dead handle cannot serve stats either, so the slot
            # drops the object like the hard-kill path does)
            try:
                rep.engine.kill()
            except Exception:
                pass
            rep.engine = None
        # integrity gate (docs/robustness.md): the failover picture is
        # believed only if its content checksum verifies — a corrupt
        # checkpoint is refused and recovery falls back to the fresh
        # re-injection path the zero-lost cert already covers
        snap = self._checked_checkpoint(snap)
        # purge cross-check state touching the corpse AFTER its
        # buffered outputs were drained (a completed replay verdict in
        # that buffer was still intercepted above), so nothing of a
        # replay uid can ever leak into the client-facing result maps
        self._drop_sdc_for_replica(idx)
        if self.config.respawn:
            # the fresh engine takes the slot and joins the survivors
            # as a re-homing target; the dead _Replica (and its error)
            # is dropped — its story lives in the counters/recorder
            self.replicas[idx] = self._spawn(idx)
            self._num_respawns += 1
        self._failover(idx, snap, reason)

    def _checked_checkpoint(self, snap: Optional[Dict]
                            ) -> Optional[Dict]:
        """Verify a failover checkpoint's embedded checksum before ANY
        of it is believed (adoption, re-imports). Returns None — "no
        checkpoint", the certified fresh-re-inject path — on a
        mismatch; checksum-less legacy checkpoints pass through (the
        detection guarantee covers sealed artifacts only)."""
        if snap is None or not self.engine_config.verify_artifacts:
            return snap
        try:
            verify_record(snap, "checkpoint")
        except IntegrityError as e:
            self._num_corrupt_checkpoints += 1
            if self._obs is not None:
                self._obs.record("corruption_detected",
                                 site="checkpoint", detail=e.detail)
            return None
        return snap

    def _failover(self, idx: int, snap: Optional[Dict],
                  reason: str) -> None:
        """Re-home everything the dead replica owned (docs/fleet.md,
        the zero-lost-request contract): adopt checkpointed terminal
        results, re-import checkpointed live entries (emitted tokens +
        arrival identity preserved; post-checkpoint tokens re-derive),
        re-inject post-checkpoint accepts fresh from the router's own
        Request copies, and terminal-fail any request past its
        ``max_request_failovers`` budget."""
        self._num_failovers += 1
        owned = [uid for uid, o in self._owner.items() if o == idx]
        owned_set = set(owned)
        recs = {r["uid"]: r
                for r in (snap or {}).get("requests", ())}
        fin = (snap or {}).get("finished") or {}
        statuses = (snap or {}).get("statuses") or {}
        # results that went terminal between the router's last drain
        # and the checkpoint: adopt, never recompute. ONLY for uids
        # the dead replica still OWNS — a stale checkpoint (e.g. one
        # predating a full run() cycle) can list finished uids from
        # finished-and-delivered lifetimes, and adopting those would
        # resurrect already-delivered results (the dedupe map was
        # cleared by run()) or even disown a REUSED uid now live on a
        # survivor, handing the caller the old lifetime's tokens.
        adopted = 0
        for uid, toks in fin.items():
            if uid in owned_set:
                self._record_result(uid, toks,
                                    statuses.get(uid, "finished"))
                adopted += 1
        rehomed = 0
        for uid in owned:
            if uid in self._statuses:
                continue    # adopted just above
            self._refails[uid] = self._refails.get(uid, 0) + 1
            rec = recs.get(uid)
            if self._refails[uid] > self.config.max_request_failovers:
                # the router-level quarantine: this request has now
                # taken down more replicas than it is worth. Keep the
                # LONGER of the delivered watermark and the checkpoint
                # record (delivered is never behind a drained stream,
                # but belt-and-braces beats a result shorter than what
                # the consumer already received)
                gen = [int(t) for t in self._delivered.get(uid, ())]
                if rec and len(rec.get("generated", ())) > len(gen):
                    gen = [int(t) for t in rec["generated"]]
                self._num_router_failed += 1
                self._record_result(uid, gen, "failed")
                continue
            if rec is None:
                # accepted after the checkpoint: the checkpoint never
                # saw it, but the router holds the Request — re-inject
                # fresh, CARRYING the tokens the router already
                # delivered (the watermark history): a fresh arrival
                # identity redraws only FUTURE tokens, so the stream a
                # consumer received stays a prefix of the terminal
                # result instead of being contradicted by re-derived
                # draws under the new key
                rec = _request_record(self._requests[uid])
                rec["generated"] = [int(t) for t in
                                    self._delivered.get(uid, ())]
                self._num_reinjected_requests += 1
            self._place_record(rec)
            rehomed += 1
        if self._obs is not None:
            self._obs.record("failover", replica=idx, reason=reason,
                             rehomed=rehomed,
                             adopted=adopted,
                             checkpointed=len(recs))

    def _place_record(self, rec: Dict, retried: bool = False) -> None:
        """Route one entry record to the best surviving replica and
        import it there. One at a time so each placement sees the
        queue depth the previous one created. The record is SEALED for
        this hop (checkpoint-internal records were verified as part of
        the checkpoint, but travel unsealed); a target that refuses it
        on a checksum mismatch (in-transit rot) triggers ONE retry
        from the router's own clean ``Request`` copy — the same fresh
        re-injection the rec-is-None failover path certifies, losing
        checkpoint history beyond the delivered watermark but losing
        no request — and only a second refusal (or a record the router
        holds no copy of) terminal-fails with what the router already
        delivered: the poison-quarantine verdict, still zero-lost (a
        verdict is not a loss)."""
        uid = rec["uid"]
        seq = list(rec["prompt"]) + list(rec.get("generated", ()))[:-1]
        # role-aware failover: a record with generated history is
        # mid-decode and re-homes onto the decode specialists; a
        # waiting entry (or a fresh re-injection) still needs prefill.
        # _ranked degrades to any survivor when the role group is
        # empty — zero-lost outranks specialization.
        stage = "decode" if rec.get("generated") else "prefill"
        idx = self._ranked(seq, stage)[0][0]
        try:
            self.replicas[idx].engine.import_requests([seal_record(rec)])
        except IntegrityError as e:
            self._note_refused_import(uid, e.detail)
            req = self._requests.get(uid)
            if not retried and req is not None:
                fresh = _request_record(req)
                fresh["generated"] = [int(t) for t in
                                      self._delivered.get(uid, ())]
                self._num_reinjected_requests += 1
                self._place_record(fresh, retried=True)
                return
            gen = [int(t) for t in self._delivered.get(uid, ())]
            if len(rec.get("generated") or ()) > len(gen):
                gen = [int(t) for t in rec["generated"]]
            self._num_router_failed += 1
            self._record_result(uid, gen, "failed")
            return
        self._owner[uid] = idx
        if self._sdc_enabled:
            # cross-check eligibility survives a re-homing only when
            # the verdict would still be ATTRIBUTABLE: the arrival
            # identity must be known (a fresh re-injection draws one
            # the router never learns) AND the record must carry no
            # generated history — tokens computed by the PREVIOUS
            # owner ride the record, so the final stream mixes two
            # replicas' compute and a divergence could blame a healthy
            # replica for a dead one's corruption
            if (rec.get("arrival") is not None
                    and not rec.get("generated")):
                self._sdc_arrivals[uid] = int(rec["arrival"])
            else:
                self._sdc_arrivals.pop(uid, None)
        # the new owner resumes emission after the record's history:
        # anchor the delivery watermark's cursor there, so any
        # re-derivation of already-streamed tokens is suppressed
        self._emit_pos[uid] = len(rec.get("generated") or ())
        self.replicas[idx].routed += 1

    def kill_replica(self, idx: int) -> None:
        """Chaos hook: simulate ABRUPT replica death (SIGKILL
        semantics) — the engine object is discarded unread, and
        failover recovers from ``last_checkpoint`` plus the router's
        own routing record alone. The honest test of the
        bounded-staleness checkpoint contract; an exception escaping
        ``step()`` exercises the softer in-process path instead."""
        rep = self.replicas[idx]
        if not rep.alive or rep.engine is None:
            raise ValueError(f"replica {idx} is not alive")
        if rep.mode == "process":
            # a REAL SIGKILL, not a simulation: the child OS process
            # dies mid-whatever-it-was-doing; recovery still runs from
            # the parent-cached last_checkpoint alone, same contract
            rep.engine.kill()
        self._fail_replica(idx, "killed", read_host_state=False)

    def migrate(self, uids: Optional[Sequence[str]], src: int,
                dst: Optional[int] = None, *,
                _handoff: bool = False) -> int:
        """Drain-and-migrate: move the given live requests (all of the
        source's, when ``uids`` is None) off replica ``src`` — onto
        ``dst``, or onto whatever the placement score picks per
        request. The source exports drained entry records (its
        in-flight decode synced, blocks released, deadlines serialized
        as remaining budget); the target imports and re-prefills
        through its prefix cache, optionally seeded with the prompt's
        KV payloads through the spill tier
        (``migrate_spill_payloads``). Equal seeds across the fleet
        make the migrated request's token stream bit-identical to the
        unmigrated one (certified). Returns how many requests moved."""
        rep = self.replicas[src]
        if not rep.alive or rep.engine is None:
            raise ValueError(f"replica {src} is not alive")
        if dst is not None:
            drep = self.replicas[dst]
            if dst == src or not drep.alive or drep.engine is None:
                raise ValueError(
                    f"migration target {dst} is not a distinct alive "
                    "replica")
        records = rep.engine.export_requests(uids)
        moved = 0
        nbytes = 0
        for rec in records:
            uid = rec["uid"]
            seq = (list(rec["prompt"])
                   + list(rec.get("generated", ()))[:-1])
            # ONE chain-hash walk per placement decision: the payload
            # export, the handoff publish, and the placement ranking
            # below all read the same chain
            hashes = self._seq_hashes(seq)
            payloads = None
            if self.config.migrate_spill_payloads:
                payloads = rep.engine.export_prefix_payloads(hashes)
                if payloads:
                    nbytes += self._payload_nbytes(payloads)
            if payloads and _handoff and self._shared is not None:
                # publish-then-import: the prefill specialist's work
                # becomes visible FLEET-WIDE before (not instead of)
                # the decode target's point-to-point import below
                self._publish_handoff(src, rec, payloads)
            if dst is not None:
                idx = dst
            else:
                # two-stage under roles: a record with generated
                # history is mid-decode (rank the decode specialists),
                # a plain waiting entry still needs its prefill
                stage = "decode" if rec.get("generated") else "prefill"
                ranked = [i for i, _
                          in self._ranked(seq, stage, hashes=hashes)
                          if i != src]
                idx = ranked[0] if ranked else src
            target = self.replicas[idx].engine
            if payloads:
                target.import_prefix_payloads(payloads)
            try:
                target.import_requests([rec])
            except IntegrityError as e:
                # the record rotted between the source's seal and the
                # target's verify: REFUSED — corrupt state never
                # re-enters the fleet, and the request stays the
                # source's (re-injected there fresh from the router's
                # own clean copy, carrying the delivered watermark)
                self._note_refused_import(uid, e.detail)
                self._requeue_refused(rec, src)
                continue
            if uid in self._sdc_pending:
                # a cross-check replay swept up by the drain: result
                # interception is by uid, so just re-point its
                # verifier — replays are never owner-tracked
                self._sdc_pending[uid]["verifier"] = idx
            else:
                self._owner[uid] = idx
                self._emit_pos[uid] = len(rec.get("generated") or ())
                if rec.get("generated"):
                    # migrated WITH history: the final stream mixes
                    # the source's compute with the target's, so an
                    # eventual divergence could not be attributed to
                    # either — it leaves the cross-check pool
                    self._sdc_arrivals.pop(uid, None)
            self.replicas[idx].routed += 1
            moved += 1
        if records:
            self._num_migrations += 1
            self._num_migrated_requests += moved
            if self._obs is not None:
                self._obs.record("migrate", src=src,
                                 dst=(dst if dst is not None else -1),
                                 requests=moved)
            if _handoff:
                self._num_handoffs += 1
                self._num_handoff_requests += moved
                self._num_handoff_bytes += nbytes
                if self._obs is not None:
                    self._obs.record(
                        "prefill_handoff", src=src, requests=moved,
                        bytes=nbytes,
                        prefill_queue=self._role_backlog("prefill"),
                        decode_queue=self._role_backlog("decode"))
        return moved

    def _publish_handoff(self, src: int, rec: Dict,
                         payloads: Mapping[str, Dict]) -> None:
        """Publish one handoff's exported KV payloads into the shared
        tier, attributed to the request's tenant — the
        publish-then-import half of ``_handoff_tick``. Hashes the
        source slot already published become dedupe references; the
        publish-once-per-slot ledger keeps repeated handoffs of the
        same hot prefix from inflating refcounts."""
        tenant = str(rec.get("tenant", DEFAULT_TENANT))
        stored = 0
        nbytes = 0
        for h, payload in payloads.items():
            if h in self._published[src]:
                continue
            if h in self._shared:
                self._shared.publish(h, None, tenant=tenant)
            elif self._publish_payload(h, payload, tenant):
                stored += 1
                nbytes += self._payload_nbytes({h: payload})
            self._published[src].add(h)
        if stored and self._obs is not None:
            self._obs.record("shared_publish", replica=src,
                             blocks=stored, bytes=nbytes)

    def _role_backlog(self, role: str) -> int:
        """Summed backlog (waiting + active lanes) over the alive
        replicas of one role — the handoff event's per-role queue
        snapshot and the trace summary's disaggregation line."""
        total = 0
        for i, rep in self._alive():
            if rep.role != role:
                continue
            try:
                ld = rep.engine.load()
            except ReplicaUnavailableError:
                continue
            total += int(ld["queue_depth"] + ld["active_slots"])
        return total

    def _requeue_refused(self, rec: Dict, src: int) -> None:
        """A migration import was refused on a checksum mismatch: the
        exported record is untrustworthy, so the SOURCE keeps the
        request — re-injected fresh from the router's own Request copy
        (the same record the failover path certifies), carrying the
        delivered-token watermark so the client's stream stays a
        prefix of the terminal result. If even that hop is refused
        (corruption on the source's own import path), the request
        terminal-fails with its delivered tokens — the quarantine
        verdict, never a loss."""
        uid = rec.get("uid")
        req = self._requests.get(uid)
        rep = self.replicas[src]
        if req is None or not rep.alive or rep.engine is None:
            # a replay record (no router copy): the check is dropped
            self._sdc_pending.pop(uid, None)
            return
        fresh = _request_record(req)
        fresh["generated"] = [int(t) for t in
                              self._delivered.get(uid, ())]
        # the source's undrained stream events for this uid cover
        # exactly the tokens past the delivered watermark — the
        # recompute below re-derives (and re-emits) them
        # bit-identically, so the stale copies must go first or each
        # token would be delivered twice, shifting every later
        # position in the ledger
        rep.engine.drop_stream_events(uid)
        # the recompute must re-draw the SAME sampled tokens past the
        # delivered watermark: sampling is arrival-keyed, and the
        # rotted record's own arrival field is exactly what cannot be
        # trusted — the source engine kept a clean copy at export
        arrival = rep.engine.exported_arrival(uid)
        if arrival is not None:
            fresh["arrival"] = arrival
        try:
            rep.engine.import_requests([seal_record(fresh)])
        except IntegrityError as e:
            self._note_refused_import(uid, e.detail)
            self._num_router_failed += 1
            self._record_result(uid, list(fresh["generated"]), "failed")
            return
        self._owner[uid] = src
        self._emit_pos[uid] = len(fresh["generated"])
        self._num_reinjected_requests += 1
        self._sdc_arrivals.pop(uid, None)
        rep.routed += 1

    def drain_replica(self, src: int, dst: Optional[int] = None,
                      retire: bool = False) -> int:
        """Move EVERYTHING off replica ``src`` (one :meth:`migrate`
        call), optionally retiring it afterwards — the clean shutdown
        path: no failover, no checkpoint, nothing lost, the replica
        simply stops receiving placements. Refuses — before touching
        anything — to retire the LAST alive replica while it holds
        live requests: with nowhere to migrate them, retirement would
        strand them alive-but-unservable forever (the one hole the
        zero-lost gauge cannot see, since the requests stay live).
        Returns requests moved."""
        if retire:
            others = [i for i, _ in self._alive() if i != src]
            rep = self.replicas[src]
            if not others and rep.engine is not None \
                    and rep.engine.has_work:
                raise ValueError(
                    f"cannot retire replica {src}: it is the last "
                    "alive replica and still holds live requests — "
                    "nothing could ever serve them")
        moved = self.migrate(None, src, dst)
        if retire:
            rep = self.replicas[src]
            # the export's drain may have FINISHED lanes (EOS/budget
            # hit inside the synced dispatch): collect those verdicts
            # now — a retired replica leaves the per-tick drain loop,
            # and a result stranded on it would never be delivered
            self._drain_replica_outputs(rep.engine)
            rep.alive = False
            rep.error = "retired"
            self._published[src] = set()
            if rep.mode == "process":
                # clean shutdown of the child; a closed handle cannot
                # serve stats, so the slot drops the object
                try:
                    rep.engine.close()
                except Exception:
                    pass
                rep.engine = None
            if self._obs is not None:
                self._obs.record("replica_down", replica=src,
                                 reason="retired",
                                 role=self.replicas[src].role)
        return moved

    def close(self) -> None:
        """Dispose every process-replica child (graceful shutdown RPC,
        then reap). A no-op for in-process replicas and already-dead
        slots; the router object itself stays usable for ``stats()``
        reads afterwards but serves nothing."""
        for rep in self.replicas:
            if rep.mode == "process" and rep.engine is not None:
                try:
                    rep.engine.close()
                except Exception:
                    pass

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The fleet counters (docs/fleet.md): routing, health,
        failover, migration, and the zero-lost invariant as a gauge —
        ``num_lost_requests`` is accepted minus live minus terminal
        and must read 0 always (``chip_smoke.py`` phase 16 asserts
        it). Nested:
        ``replicas`` (per-slot health + load view) and ``tenants``
        (the fleet-wide ledger: per-replica rows summed, the router's
        door tallies and rate estimator merged in)."""
        alive = self._alive()
        reps: Dict[str, Dict[str, object]] = {}
        tenant_rows: List[Dict[str, Dict[str, object]]] = []
        for i, rep in enumerate(self.replicas):
            row: Dict[str, object] = {
                "alive": bool(rep.alive and rep.engine is not None),
                "mode": rep.mode,
                "role": rep.role,
                "routed": rep.routed,
                "stall_streak": rep.stall_streak,
                "error": rep.error,
            }
            if rep.engine is not None:
                es = rep.engine.stats()
                row.update(rep.engine.load())
                for k in ("num_checkpoints", "num_migrated_in",
                          "num_migrated_out", "num_preemptions",
                          "num_quarantines"):
                    row[k] = es[k]
                if rep.alive:
                    tenant_rows.append(es["tenants"])
            reps[str(i)] = row
        return {
            "num_replicas": len(self.replicas),
            "replicas_alive": len(alive),
            "num_ticks": self._num_ticks,
            "num_accepted": self._num_accepted,
            "num_routed": self._num_routed,
            "num_affinity_hits": self._num_affinity_hits,
            "num_failovers": self._num_failovers,
            "num_replicas_down": self._num_replicas_down,
            "num_respawns": self._num_respawns,
            "num_migrations": self._num_migrations,
            "num_migrated_requests": self._num_migrated_requests,
            "num_reinjected_requests": self._num_reinjected_requests,
            "num_duplicate_results": self._num_duplicate_results,
            "num_router_failed": self._num_router_failed,
            "num_rejected_queue_full": self._num_rejected_queue_full,
            "num_throttled": self._num_throttled,
            # data integrity (docs/robustness.md "Data integrity"):
            # refused failover checkpoints, refused migration/failover
            # imports, and the SDC cross-check's replay/verdict tally
            "num_corrupt_checkpoints": self._num_corrupt_checkpoints,
            "num_refused_imports": self._num_refused_imports,
            "num_sdc_checks": self._num_sdc_checks,
            "num_sdc_suspects": self._num_sdc_suspects,
            # process replicas + autoscaler (docs/fleet.md, "Process
            # replicas"): autoscaled spawns/retires and the RPC
            # frame-retry/timeout tally (always 0 in-process)
            "num_spawned": self._num_spawned,
            "num_retired": self._num_retired,
            "num_rpc_retries": self._num_rpc_retries,
            "num_rpc_timeouts": self._num_rpc_timeouts,
            # disaggregated prefill/decode roles (docs/fleet.md,
            # "Disaggregated roles"): handoff sweeps, requests moved
            # and payload bytes shipped prefill->decode, and the
            # affinity probes the two-stage router short-circuited
            # (always 0 colocated)
            "num_handoffs": self._num_handoffs,
            "num_handoff_requests": self._num_handoff_requests,
            "num_handoff_bytes": self._num_handoff_bytes,
            "num_affinity_probes_skipped":
                self._num_affinity_probes_skipped,
            # fleet-global shared prefix tier (docs/fleet.md, "Shared
            # prefix tier"): resident gauges, the publish/dedupe/hit
            # flow, eviction/refusal/corruption tallies and the scrub
            # coverage (all 0 with the tier off), plus the placement
            # hash-walk counter whose one-walk-per-decision bound the
            # regression test pins
            "shared_tier_blocks": (0 if self._shared is None
                                   else len(self._shared)),
            "shared_tier_bytes": (0 if self._shared is None
                                  else int(self._shared.total_bytes)),
            "shared_tier_hits": self._num_shared_hits,
            "num_shared_publishes": self._num_shared_publishes,
            "num_shared_dedupe": (0 if self._shared is None
                                  else int(self._shared.dedupe_hits)),
            "num_shared_evictions": (0 if self._shared is None
                                     else int(self._shared.evictions)),
            "num_shared_refused": (0 if self._shared is None
                                   else int(self._shared.refused)),
            "num_shared_corrupt_discards":
                (0 if self._shared is None
                 else int(self._shared.corrupt_discards)),
            "num_shared_scrub_blocks_verified":
                self._num_shared_scrub_blocks_verified,
            "num_hash_walks": self._num_hash_walks,
            "num_lost_requests": (self._num_accepted - len(self._owner)
                                  - self._num_terminal),
            "queue_depth": sum(rep.engine.queue_depth
                               for _, rep in alive),
            "active_slots": sum(rep.engine.active_slot_count
                                for _, rep in alive),
            "results_pending": len(self._results),
            "stream_backlog": len(self._stream),
            "replicas": reps,
            "tenants": self._tenant_section(tenant_rows),
        }

    def _tenant_section(self, tenant_rows) -> Dict[str, Dict[str, object]]:
        """One fleet-wide row per tenant: the per-replica ledger rows
        summed (tokens, waiting, residency, fractional charge, engine
        statuses), the router's own door tallies merged in, and the
        FLEET rate estimate (the number ``FleetConfig.tenant_quotas``'
        ``tokens_per_s`` is enforced against). With the shared prefix
        tier on, each tenant's ``shared_tier_bytes`` carries its
        fractional ownership charge (bytes split by publisher share —
        the shared-tier leg of the fractional block ledger) and a
        ``__shared__`` row carries the tier's resident total, so the
        per-tenant charges visibly sum to the tier."""
        agg: Dict[str, Dict[str, object]] = {}

        def row(t: str) -> Dict[str, object]:
            return agg.setdefault(t, {
                "tokens": 0, "waiting": 0, "resident_slots": 0,
                "resident_block_charge": 0.0,
                "shared_tier_bytes": 0.0,
                "rate_tokens_per_s": round(self._tenant_rate_now(t), 6),
                "statuses": {},
            })

        for rows in tenant_rows:
            for t, er in rows.items():
                r = row(t)
                r["tokens"] += er.get("tokens", 0)
                r["waiting"] += er.get("waiting", 0)
                r["resident_slots"] += er.get("resident_slots", 0)
                r["resident_block_charge"] = round(
                    r["resident_block_charge"]
                    + er.get("resident_block_charge", 0.0), 6)
                for s, c in (er.get("statuses") or {}).items():
                    r["statuses"][s] = r["statuses"].get(s, 0) + c
        if self._shared is not None:
            for t, b in self._shared.tenant_bytes().items():
                row(t)["shared_tier_bytes"] = b
            row("__shared__")["shared_tier_bytes"] = round(
                float(self._shared.total_bytes), 6)
        for t, tally in self._tenant_status.items():
            r = row(t)
            for s, c in tally.items():
                # the router's verdicts (fleet-door throttles, failover
                # quarantines, adopted checkpoints) — kept SEPARATE
                # from the engine tallies, which never saw them
                key = f"router_{s}"
                r["statuses"][key] = r["statuses"].get(key, 0) + c
        return agg


def _request_record(req: Request) -> Dict:
    """A fresh entry record from the router's own Request copy — the
    failover path for accepts the dead replica's checkpoint never saw.
    No ``arrival`` (the target assigns one), no generated tokens
    (nothing of it was delivered), deadline as its ORIGINAL budget
    (the router cannot know how much the dead replica burned; erring
    long keeps the request alive, and the target's gate/expiry still
    bound it)."""
    rec = {
        "uid": req.uid,
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        "sampling": {"temperature": float(req.sampling.temperature),
                     "top_k": int(req.sampling.top_k),
                     "top_p": float(req.sampling.top_p)},
        "priority": int(req.priority),
        "tenant": str(req.tenant),
        "generated": [],
        "drr_charged": False,
    }
    if req.deadline_s is not None:
        rec["deadline_remaining_s"] = float(req.deadline_s)
    return rec
