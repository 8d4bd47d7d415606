"""Request-lifecycle tracing with Chrome-trace (Perfetto) export
(counterpart of :mod:`apex_tpu.observability.trace`: the same event types
and export).

Every request gets a span timeline: enqueue, admit or shed (with the
reason), each prefill chunk, each decode or verify dispatch it rode,
preemption, requeue, drain and its terminal status. Two read surfaces
over one event store:

- :meth:`RequestTracer.request_timeline` / :meth:`timelines`: plain
  per-request dicts;
- :meth:`RequestTracer.chrome_trace`: Chrome-trace JSON
  (``chrome://tracing`` or https://ui.perfetto.dev): ``B``/``E``
  lane-residency spans, ``X`` complete events for prefill chunks and
  decode dispatches, ``i`` instants for queue transitions; ``pid`` is
  the engine, ``tid 0`` the waiting queue, ``tid i+1`` lane ``i``.

Timestamps come from the injected clock (the engine's own), so traces are
deterministic under fake clocks, and the tracer is never an input to a
scheduling decision.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


# The closed vocabulary of trace event types; event() rejects strays.
TRACE_EVENT_TYPES = (
    "enqueue",        # request entered the waiting queue
    "requeue",        # re-entered after preemption / device reset
    "admit",          # moved into a lane (begins the lane-residency span)
    "shed",           # refused: reason queue_full | throttled | rejected
    "prefill_chunk",  # one [1, prefill_chunk] piece ran (span, dur_s)
    "decode",         # one decode/verify dispatch the request rode (span)
    "drain",          # its tokens from that dispatch became host-visible
    "preempt",        # evicted from its lane (ends the residency span)
    "terminal",       # reached a terminal status (finished/timeout/...)
)

_TYPE_SET = frozenset(TRACE_EVENT_TYPES)

# events that END the lane-residency span a matching "admit" began
_LANE_END = ("preempt", "terminal")
_QUEUE_TID = 0


class RequestTracer:
    """Append-only event store with per-request indexing.

    Each record is ``{"type", "uid", "t", "lane", "dur_s", ...args}``
    (``lane`` None for queue-side events). The store is bounded by
    ``max_events``: past it, NEW events are counted in ``dropped``
    instead of stored — a trace is a forensic artifact, and silently
    losing its beginning is worse than truncating its end (the flight
    recorder owns the rolling-tail role)."""

    def __init__(self, clock=None, max_events: int = 100_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self._clock = time.monotonic if clock is None else clock
        self._max_events = max_events
        self._events: List[Dict] = []
        self._by_uid: Dict[str, List[Dict]] = {}
        self.dropped = 0

    def use_clock(self, clock) -> None:
        self._clock = clock

    def __len__(self) -> int:
        return len(self._events)

    def event(self, etype: str, uid: str, *, lane: Optional[int] = None,
              t: Optional[float] = None, dur_s: Optional[float] = None,
              **args) -> None:
        if etype not in _TYPE_SET:
            raise ValueError(
                f"unknown trace event type {etype!r} (known: "
                f"{TRACE_EVENT_TYPES})")
        if len(self._events) >= self._max_events:
            self.dropped += 1
            return
        rec = {"type": etype, "uid": uid,
               "t": float(self._clock() if t is None else t),
               "lane": lane}
        if dur_s is not None:
            rec["dur_s"] = float(dur_s)
        rec.update(args)
        self._events.append(rec)
        self._by_uid.setdefault(uid, []).append(rec)

    # -- the plain dict API ------------------------------------------------

    def request_timeline(self, uid: str) -> List[Dict]:
        """The request's events in emission order (copies)."""
        return [dict(e) for e in self._by_uid.get(uid, ())]

    def timelines(self) -> Dict[str, List[Dict]]:
        return {uid: [dict(e) for e in evs]
                for uid, evs in self._by_uid.items()}

    # -- Chrome-trace / Perfetto export ------------------------------------

    @staticmethod
    def _tid(rec: Dict) -> int:
        lane = rec.get("lane")
        return _QUEUE_TID if lane is None else int(lane) + 1

    def chrome_trace(self) -> Dict[str, object]:
        """The trace as a Chrome-trace-format dict (``json.dumps`` it
        into a ``.json`` Perfetto opens directly). Timestamps are
        microseconds relative to the first event; events are emitted
        sorted by timestamp (stable, so same-timestamp events keep
        emission order and ``B`` precedes its ``E``)."""
        evs = self._events
        epoch = evs[0]["t"] if evs else 0.0
        out: List[Dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 1, "tid": _QUEUE_TID,
             "name": "thread_name", "args": {"name": "queue"}},
        ]
        lanes_seen = set()
        body: List[Dict] = []
        for rec in evs:
            tid = self._tid(rec)
            if tid != _QUEUE_TID:
                lanes_seen.add(tid)
            ts = (rec["t"] - epoch) * 1e6
            uid = rec["uid"]
            etype = rec["type"]
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "uid", "t", "lane", "dur_s")}
            args["uid"] = uid
            base = {"pid": 1, "tid": tid, "ts": ts, "cat": etype,
                    "args": args}
            if etype in ("prefill_chunk", "decode"):
                base.update(ph="X", name=f"{etype} {uid}",
                            dur=rec.get("dur_s", 0.0) * 1e6)
            elif etype == "admit":
                base.update(ph="B", name=f"req {uid}")
            elif etype in _LANE_END and tid != _QUEUE_TID:
                base.update(ph="E", name=f"req {uid}")
            else:
                # queue-side instants: enqueue/requeue/shed/drain and
                # off-lane terminals (timeout/abort/shed while waiting)
                base.update(ph="i", name=f"{etype} {uid}", s="t")
            body.append(base)
        for tid in sorted(lanes_seen):
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name",
                        "args": {"name": f"lane {tid - 1}"}})
        body.sort(key=lambda e: e["ts"])     # stable: ties keep order
        out.extend(body)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump(self, include_chrome: bool = False) -> Dict[str, object]:
        """JSON-able dump. The timelines ARE the full event store;
        the Chrome rendering is a pure function of them, so it is
        omitted by default (a crash dump need not carry every event
        twice) — regenerate via :meth:`chrome_trace`, or pass
        ``include_chrome=True`` to embed it."""
        out = {
            "dropped": self.dropped,
            "num_events": len(self._events),
            "timelines": self.timelines(),
        }
        if include_chrome:
            out["chrome_trace"] = self.chrome_trace()
        return out
