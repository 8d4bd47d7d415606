"""apex_tpu_torch.observability: the serving engine's and the train
loop's observability layer (counterpart of :mod:`apex_tpu.observability`,
a copy of its own: the same metric, event and dump names, so
``tools/trace_summary.py`` summarizes a dump of either package).

Three pieces behind one coordinator (:class:`Observability`), threaded
through :class:`~apex_tpu_torch.serving.InferenceEngine` and
:class:`~apex_tpu_torch.train.TrainLoop` by their ``obs=`` argument:

- request-lifecycle tracing (:mod:`~apex_tpu_torch.observability.trace`):
  per-request span timelines and a Perfetto-loadable Chrome trace;
- the flight recorder (:mod:`~apex_tpu_torch.observability.recorder`): a
  bounded ring of structured events, frozen into incidents at
  quarantines, device resets and stalls, and dumped to a file when an
  exception escapes ``run()``;
- the metrics registry (:mod:`~apex_tpu_torch.observability.metrics`):
  counters, gauges and log-bucket histograms with a Prometheus text
  exposition, merged into ``stats(deep=True)``.

Observers consume events and never produce decisions: with an observer
attached the engine's tokens, ``stats()`` and kernel launches are those
of the engine without one. A hook reads no device tensor, adds no
synchronisation and draws from no generator. Observer state stays out of
the snapshot's config fingerprint; the recorder tail rides ``snapshot()``
as an audit section that ``restore()`` never reads.

Usage::

    obs = Observability(crash_dump_path="engine_crash.json")
    engine = InferenceEngine(model, config, obs=obs)
    ...
    obs.metrics.exposition()       # Prometheus text
    obs.tracer.chrome_trace()      # load in Perfetto
    obs.dump_to("run_dump.json")   # tools/trace_summary.py input
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.observability.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
    percentile,
)
from apex_tpu_torch.observability.recorder import (  # noqa: F401
    RECORDER_EVENT_KINDS,
    FlightRecorder,
)
from apex_tpu_torch.observability.trace import (  # noqa: F401
    TRACE_EVENT_TYPES,
    RequestTracer,
)

# the JAX package's dump format name: tools/trace_summary.py reads either
# package's dump
DUMP_FORMAT = "apex_tpu-obs-dump-v1"


def flatten_stats(stats: Dict[str, object], sep: str = ".",
                  exclude: Tuple[str, ...] = ()) -> Dict[str, object]:
    """The flattener for nested ``stats()`` dicts: nested keys join with
    ``sep`` (``tenants.acme.tokens``), scalar leaves pass through, and
    ``exclude`` drops top-level keys."""
    out: Dict[str, object] = {}

    def walk(prefix: str, d: Dict[str, object]) -> None:
        for k, v in d.items():
            if not prefix and k in exclude:
                continue
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = v

    walk("", stats)
    return out


# -- the metric surfaces (the JAX package's names) ----------------------------

# numeric encoding of the storage quantization modes for the labeled
# ``serving_quantization_mode`` gauges (a Prometheus gauge is a float;
# the mode strings ride the restore fingerprint, the codes ride the
# dashboard): 0 = full precision, 1 = int8, 2 = fp8
QUANT_MODE_CODES = {None: 0.0, "int8": 1.0, "fp8": 2.0}


def register_engine_metrics(registry: MetricsRegistry) -> Dict[str, object]:
    """Register the serving engine's metric set (idempotent) and return
    the handles. The histograms are the observable latency surface; the
    engine's EWMAs keep feeding its admission gate unchanged."""
    return {
        "ttft": registry.histogram(
            "serving_ttft_s",
            "submit to first host-visible token, seconds"),
        "itl": registry.histogram(
            "serving_itl_s",
            "gap between successive host-visible tokens of one "
            "request, seconds"),
        "prefill": registry.histogram(
            "serving_prefill_dispatch_s",
            "one prefill-chunk dispatch+fetch, seconds"),
        "decode": registry.histogram(
            "serving_decode_dispatch_s",
            "one decode/verify drain fetch block, seconds"),
        "queue_wait": registry.histogram(
            "serving_queue_wait_s",
            "enqueue to admission, seconds"),
        "requests": registry.counter(
            "serving_requests_total", "requests accepted into the queue"),
        "tokens": registry.counter(
            "serving_tokens_total", "fresh tokens delivered"),
        "sheds": registry.counter(
            "serving_sheds_total",
            "requests shed (queue_full + throttled + rejected)"),
        "preemptions": registry.counter(
            "serving_preemptions_total", "lane preemptions"),
        # one labeled family, one sample per storage surface: the
        # engine sets both at construction from its config
        # (QUANT_MODE_CODES)
        "kv_quant_mode": registry.gauge(
            "serving_quantization_mode",
            "storage quantization mode code (0=off, 1=int8, 2=fp8)",
            labels={"kind": "kv"}),
        "weight_quant_mode": registry.gauge(
            "serving_quantization_mode",
            "storage quantization mode code (0=off, 1=int8, 2=fp8)",
            labels={"kind": "weight"}),
    }


def register_train_metrics(registry: MetricsRegistry) -> Dict[str, object]:
    """Register :class:`~apex_tpu_torch.train.TrainLoop`'s metric set
    (idempotent) and return the handles."""
    return {
        "step": registry.histogram(
            "train_step_s",
            "one TrainLoop.step() host span (dispatch + deferred "
            "fetch), seconds"),
        "steps": registry.counter(
            "train_steps_total", "train steps dispatched"),
        "retries": registry.counter(
            "train_retries_total", "transient train-step retries"),
        "nonfinite": registry.counter(
            "train_nonfinite_total", "non-finite losses observed"),
        "checkpoints": registry.counter(
            "train_checkpoints_total", "checkpoints saved"),
    }


_SHED_REASONS = ("queue_full", "throttled", "rejected")


class Observability:
    """The coordinator the engine and train loop thread events through.

    All three members are optional and independently disableable
    (``trace=False``, ``recorder_capacity=0``, ``metrics=False``); a
    disabled member costs nothing, an enabled one O(1) per event. The
    ``note_*`` methods are the engine-facing vocabulary; they fan each
    logical event out to whichever members exist. One Observability
    may serve one engine OR one train loop (its per-request state is
    engine-scoped); share a single :class:`MetricsRegistry` across
    several via the ``metrics=`` argument when aggregating."""

    def __init__(self, *, trace: bool = True,
                 recorder_capacity: int = 256,
                 metrics: object = True,
                 trace_max_events: int = 100_000,
                 crash_dump_path: Optional[str] = None,
                 clock=None):
        self._clock = time.monotonic if clock is None else clock
        self.tracer = (RequestTracer(clock=self._clock,
                                     max_events=trace_max_events)
                       if trace else None)
        self.recorder = (FlightRecorder(recorder_capacity,
                                        clock=self._clock)
                         if recorder_capacity else None)
        if metrics is True:
            self.metrics: Optional[MetricsRegistry] = MetricsRegistry()
        elif metrics:
            self.metrics = metrics          # a shared registry
        else:
            self.metrics = None
        self.crash_dump_path = crash_dump_path
        self._m: Dict[str, object] = {}
        # per-request metric state: uid -> [submit_t, last_token_t]
        self._req: Dict[str, List[Optional[float]]] = {}

    # -- binding -----------------------------------------------------------

    def use_clock(self, clock) -> None:
        """Rebind every member onto ``clock``: the engine passes its own
        injectable clock, so traces are deterministic under fake clocks.
        The clock must be a pure read (not advanced by calling, like
        ``time.monotonic``): metric-bearing hooks reuse timestamps the
        engine already read, but trace and recorder instants make reads
        of their own."""
        self._clock = clock
        if self.tracer is not None:
            self.tracer.use_clock(clock)
        if self.recorder is not None:
            self.recorder.use_clock(clock)

    def now(self) -> float:
        return float(self._clock())

    def bind_engine(self, clock) -> None:
        self.use_clock(clock)
        if self.metrics is not None:
            self._m.update(register_engine_metrics(self.metrics))

    def bind_train(self, clock=None) -> None:
        if clock is not None:
            self.use_clock(clock)
        if self.metrics is not None:
            self._m.update(register_train_metrics(self.metrics))

    # -- pass-throughs -----------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.record(kind, **fields)

    def incident(self, label: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.incident(label, **fields)

    def trace_event(self, etype: str, uid: str, **kw) -> None:
        if self.tracer is not None:
            self.tracer.event(etype, uid, **kw)

    def observe(self, handle: str, v: float) -> None:
        """Observe into a bound metric handle (no-op when metrics are
        off or the handle is unbound)."""
        m = self._m.get(handle)
        if m is not None:
            m.observe(v)

    def inc(self, handle: str, n: float = 1) -> None:
        m = self._m.get(handle)
        if m is not None:
            m.inc(n)

    def gauge(self, handle: str, v: float) -> None:
        """Set a bound gauge handle (no-op when metrics are off or the
        handle is unbound)."""
        m = self._m.get(handle)
        if m is not None:
            m.set(v)

    # -- the engine-facing event vocabulary --------------------------------

    def note_enqueue(self, uid: str, *, tenant: str = "", priority: int = 0,
                     prompt_len: int = 0, requeue: bool = False,
                     t: Optional[float] = None) -> None:
        if t is None:
            t = self.now()
        if not requeue:
            self._req.setdefault(uid, [t, None])
            self.inc("requests")
        self.trace_event("requeue" if requeue else "enqueue", uid, t=t,
                         tenant=tenant, priority=priority,
                         prompt_len=prompt_len)

    def note_shed(self, uid: str, reason: str, *, queued: bool) -> None:
        assert reason in _SHED_REASONS, reason
        self.inc("sheds")
        self.trace_event("shed", uid, reason=reason, queued=queued)
        self.record("shed", uid=uid, reason=reason)

    def note_admit(self, uid: str, lane: int, wait_s: float,
                   cached_blocks: int = 0,
                   t: Optional[float] = None) -> None:
        self.observe("queue_wait", wait_s)
        self.trace_event("admit", uid, lane=lane, t=t, wait_s=wait_s,
                         cached_blocks=cached_blocks)

    def note_prefill_chunk(self, uid: str, lane: int, start: int, end: int,
                           t_start: float, dur_s: float) -> None:
        self.observe("prefill", dur_s)
        self.trace_event("prefill_chunk", uid, lane=lane, t=t_start,
                         dur_s=dur_s, start=start, end=end)

    def note_decode_drained(self, dispatch: int, t_start: float,
                            t_end: float, fetch_s: float,
                            lanes) -> None:
        """One drained decode/verify dispatch: ``lanes`` is
        ``[(uid, lane, tokens)]`` for the lanes whose results were
        kept. The histogram observes the fetch block (the same measure
        the gate's EWMA uses); the trace span covers dispatch→drain
        (what a timeline viewer wants to see)."""
        self.observe("decode", fetch_s)
        dur = max(0.0, t_end - t_start)
        for uid, lane, tokens in lanes:
            self.trace_event("decode", uid, lane=lane, t=t_start,
                             dur_s=dur, dispatch=dispatch, tokens=tokens)
            self.trace_event("drain", uid, t=t_end, tokens=tokens,
                             dispatch=dispatch)

    def note_token(self, uid: str, t: Optional[float] = None) -> None:
        """One fresh host-visible token: feeds the TTFT histogram on a
        request's first, the inter-token-latency histogram after.
        ``t`` is the host-visibility timestamp the ENGINE already read
        (the prefill fetch or the drain) — reused so observation adds
        no clock call of its own on the token path."""
        self.inc("tokens")
        st = self._req.get(uid)
        if st is None:
            return
        if t is None:
            t = self.now()
        if st[1] is None:
            self.observe("ttft", t - st[0])
        else:
            self.observe("itl", t - st[1])
        st[1] = t

    def note_preempt(self, uid: str, lane: int,
                     reason: str = "pool_pressure",
                     t: Optional[float] = None) -> None:
        self.inc("preemptions")
        self.trace_event("preempt", uid, lane=lane, t=t, reason=reason)
        self.record("preempt", uid=uid, lane=lane, t=t, reason=reason)

    def note_terminal(self, uid: str, status: str,
                      lane: Optional[int] = None) -> None:
        self._req.pop(uid, None)
        self.trace_event("terminal", uid, lane=lane, status=status)

    # -- dumps -------------------------------------------------------------

    def deep_stats(self) -> Dict[str, object]:
        """The ``stats(deep=True)`` merge section."""
        out: Dict[str, object] = {}
        if self.metrics is not None:
            out["metrics"] = self.metrics.as_dict()
        if self.recorder is not None:
            out["recorder_events"] = len(self.recorder)
            out["recorder_dropped"] = self.recorder.dropped
            out["recorder_incidents"] = len(self.recorder.incidents)
        if self.tracer is not None:
            out["trace_events"] = len(self.tracer)
            out["trace_dropped"] = self.tracer.dropped
        return out

    def dump(self, include_chrome: bool = False) -> Dict[str, object]:
        """The full JSON-able picture — the input contract of
        tools/trace_summary.py. ``include_chrome`` embeds the
        Perfetto rendering too (off by default: the timelines already
        carry every event once; ``tracer.chrome_trace()`` regenerates
        it on demand)."""
        out: Dict[str, object] = {"format": DUMP_FORMAT}
        if self.tracer is not None:
            out["trace"] = self.tracer.dump(include_chrome)
        if self.recorder is not None:
            out["recorder"] = self.recorder.dump()
        if self.metrics is not None:
            out["metrics"] = {"values": self.metrics.as_dict(),
                              "exposition": self.metrics.exposition()}
        return out

    def dump_to(self, path: str, include_chrome: bool = False) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.dump(include_chrome), f, indent=1,
                      default=str)
        return path

    def crash_dump(self, error: BaseException) -> Optional[str]:
        """Write the post-mortem (recorder incident + full dump) to
        ``crash_dump_path``; a dump failure is swallowed — the
        original exception must keep propagating."""
        try:
            self.incident("crash", error=f"{type(error).__name__}: {error}")
            if self.crash_dump_path is None:
                return None
            payload = self.dump()
            payload["error"] = f"{type(error).__name__}: {error}"
            with open(self.crash_dump_path, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, default=str)
            return self.crash_dump_path
        except Exception:
            return None
