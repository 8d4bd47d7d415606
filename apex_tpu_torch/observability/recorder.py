"""Flight recorder: a bounded ring of structured engine and train-loop
events (counterpart of :mod:`apex_tpu.observability.recorder`: the same
event kinds and dump layout).

When a dispatch chain wedges, the last N decisions (tick summaries,
ladder transitions, quarantines, retries, spills, scrubs) say more than a
``stats()`` dict of where the counters ended. Recording is one dict
append into a ``deque(maxlen=...)``, and nothing of the recorder is ever
an input to a decision. ``incident()`` freezes the current tail into a
small side buffer when something notable happens (a quarantine, a device
reset, a stall), so the post-mortem survives the ring rolling past it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional


# The closed vocabulary of recorder event kinds, the JAX package's (the
# kinds of its mesh and fleet are listed though this package emits none
# of them yet, so one dump reader serves both); record() rejects strays,
# so a mistyped kind fails where it is recorded.
RECORDER_EVENT_KINDS = (
    "tick",                 # per-scheduler-tick summary (engine)
    "ladder",               # degradation-ladder transition
    "quarantine",           # a request terminally failed by retry exhaustion
    "drafter_quarantine",   # the speculative drafter flipped off for good
    "fault_retry",          # one transient-failure retry at a dispatch site
    "spec_cap",             # spec_adapt moved the dynamic draft cap
    "alloc_pressure",       # CacheOutOfBlocks with no lane left to preempt
    "preempt",              # a lane preempted for pool pressure or quota
    "shed",                 # a request shed (queue_full/throttled/rejected)
    "spill",                # an evicted prefix block copied to the host tier
    "spill_upload",         # spilled blocks re-admitted by device upload
    "dequant_gemm",         # quantized weight storage committed at boot
    "corruption_detected",  # a checksummed artifact failed verification
    "scrub",                # one background integrity pass completed
    "sdc_suspect",          # the fleet cross-check caught a diverging replica
    "snapshot",             # snapshot() taken (lightweight=True: checkpoint())
    "restore",              # restore() applied
    "replica_down",         # a fleet replica declared dead (or retired)
    "failover",             # the dead replica's requests re-homed
    "migrate",              # drain-and-migrate moved requests off a replica
    "prefill_handoff",      # disaggregated prefill->decode handoff sweep
    "shared_publish",       # blocks published into the fleet shared tier
    "shared_hit",           # shared-tier blocks seeded into a replica
    "replica_spawn",        # the autoscaler grew the fleet by one replica
    "replica_retire",       # the autoscaler drained a replica away
    "rpc_timeout",          # a process-replica RPC exceeded its deadline
    "device_reset",         # drain-failure crash-restore (_reset_device_state)
    "stall",                # EngineStalledError about to raise
    "watchdog",             # TrainLoop non-finite-loss watchdog action
    "checkpoint",           # TrainLoop checkpoint saved
    "train_step",           # per-train-step summary (TrainLoop)
)

_KIND_SET = frozenset(RECORDER_EVENT_KINDS)


class FlightRecorder:
    """Bounded ring of ``{"kind", "seq", "t", ...fields}`` event dicts.

    ``seq`` is the lifetime event number (monotonic even after the ring
    wraps — ``dropped`` = ``seq_head - len(ring)`` tells the reader how
    much history rolled off). ``t`` comes from the injected clock (the
    engine passes its own ``_clock``, so recorder timelines are
    deterministic under fake clocks)."""

    def __init__(self, capacity: int = 256, clock=None,
                 max_incidents: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = time.monotonic if clock is None else clock
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self.incidents: deque = deque(maxlen=max_incidents)

    def use_clock(self, clock) -> None:
        self._clock = clock

    @property
    def dropped(self) -> int:
        return self._seq - len(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, kind: str, **fields) -> None:
        if kind not in _KIND_SET:
            raise ValueError(
                f"unknown recorder event kind {kind!r} (known: "
                f"{RECORDER_EVENT_KINDS})")
        # an explicit t= reuses a timestamp the caller already read
        # (no extra clock call); otherwise stamp here
        t = fields.pop("t", None)
        ev = {"kind": kind, "seq": self._seq,
              "t": float(self._clock() if t is None else t)}
        ev.update(fields)
        self._seq += 1
        self._ring.append(ev)

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        """The most recent ``n`` events (all, when ``n`` is None),
        oldest first — copied dicts, safe to serialize or mutate."""
        evs = list(self._ring)
        if n is not None:
            evs = evs[-n:]
        return [dict(e) for e in evs]

    def incident(self, label: str, **fields) -> Dict:
        """Freeze the current tail as a named incident (kept in a
        bounded side buffer so it survives ring wrap). Returns the
        incident record."""
        inc = {"label": label, "t": float(self._clock()),
               "events": self.tail()}
        inc.update(fields)
        self.incidents.append(inc)
        return inc

    def dump(self) -> Dict[str, object]:
        """JSON-able picture: the ring, the incidents, and the drop
        accounting — the recorder half of ``Observability.dump()``."""
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "events": self.tail(),
            "incidents": [dict(i) for i in self.incidents],
        }
