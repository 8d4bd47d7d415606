"""Metrics registry: counters, gauges and fixed-bucket histograms with a
Prometheus text exposition (counterpart of
:mod:`apex_tpu.observability.metrics`: the same names, bucket geometry and
exposition text).

Histograms use fixed log-spaced buckets (:func:`log_buckets`):
``observe()`` is one bisect, and the bounds never depend on the data, so
two runs' histograms merge by adding counts. The engine's service-time
EWMAs keep feeding its feasibility gate; the registry is an observable
surface beside them and never an input to a decision.

:func:`percentile` is the one percentile helper: linear interpolation
between closest ranks (numpy's default rule), the rule the histogram's
quantile estimate follows between bucket bounds.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of ``xs`` under linear
    interpolation between closest ranks — numpy's default rule: the
    rank is ``q/100 * (n - 1)``, fractional ranks blend the two
    neighbors. ``xs`` need not be sorted. Raises on an empty sequence
    (a percentile of nothing is a caller bug, not 0.0 — callers with a
    legitimate empty case guard it themselves)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    n = len(xs)
    if n == 0:
        raise ValueError("percentile of an empty sequence")
    ts = sorted(xs)
    rank = (q / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    hi = int(math.ceil(rank))
    if lo == hi:
        return float(ts[lo])
    frac = rank - lo
    return float(ts[lo] * (1.0 - frac) + ts[hi] * frac)


def log_buckets(lo: float, hi: float, count: int) -> Tuple[float, ...]:
    """``count`` log-spaced upper bounds from ``lo`` to ``hi``
    inclusive — the fixed histogram geometry (data-independent, so
    histograms from different replicas/runs merge by adding counts).
    The implicit ``+Inf`` bucket is NOT included (the histogram adds
    it)."""
    if not 0.0 < lo < hi:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if count < 2:
        raise ValueError(f"need >= 2 buckets, got {count}")
    ratio = (hi / lo) ** (1.0 / (count - 1))
    return tuple(lo * ratio ** i for i in range(count))


# default latency geometry: 100us .. 100s, 25 log-spaced bounds —
# ~1.78x per bucket, wide enough for a CPU prefill and a card
# microsecond decode alike
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 100.0, 25)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without the trailing .0
    (matches client_golang), everything else via repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def labeled_name(name: str, labels) -> str:
    """The Prometheus sample name for (family, labels):
    ``family{k="v",...}`` with label keys sorted (so one logical
    metric always produces one registry key), or the bare family name
    when there are no labels."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. ``inc()`` only goes up."""

    kind = "counter"
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n

    def as_value(self):
        return self.value

    def expose(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """Point-in-time value. ``set()`` overwrites.

    Optionally labeled: ``labels={"kind": "kv"}`` makes this one
    sample of the family ``family`` — its registry key and exposed
    sample name become ``family{kind="kv"}``, and the exposition
    groups every sample of the family under ONE ``# HELP``/``# TYPE``
    header (the Prometheus family convention). Unlabeled gauges are
    byte-identical to the pre-label registry."""

    kind = "gauge"
    __slots__ = ("name", "help", "value", "family", "labels")

    def __init__(self, name: str, help: str, labels=None):
        self.family = name
        self.labels = dict(labels) if labels else {}
        self.name = labeled_name(name, self.labels)
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def as_value(self):
        return self.value

    def expose(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Fixed-bound histogram: ``observe()`` is one bisect into the
    precomputed bounds (O(1)-ish, allocation-free), plus sum and count.
    Exposition follows the Prometheus convention: CUMULATIVE
    ``_bucket{le="..."}`` lines ending at ``+Inf``, then ``_sum`` and
    ``_count``.

    :meth:`quantile` estimates a percentile from the bucket counts by
    the same linear-interpolation rule as :func:`percentile` — here
    between bucket BOUNDS (assuming uniform mass within a bucket),
    since the raw observations are gone. Exact for the count/sum
    moments, approximate (one bucket wide) for quantiles — the price
    of O(1) memory."""

    kind = "histogram"
    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        bounds = tuple(buckets if buckets is not None
                       else DEFAULT_LATENCY_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name}: bucket bounds must be strictly "
                f"increasing, got {bounds}")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # + the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated percentile estimate (0 when empty — a
        dashboard reading, not a math error)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"quantile q must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        rank = (q / 100.0) * (self.count - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c > rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                frac = (rank - seen + 1) / c
                return float(lo + (hi - lo) * min(1.0, frac))
            seen += c
        return float(self.bounds[-1])

    def as_value(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.quantile(50),
            "p90": self.quantile(90),
            "p99": self.quantile(99),
        }

    def expose(self) -> List[str]:
        lines = []
        cum = 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines


class MetricsRegistry:
    """Name-keyed collection of metrics with get-or-create semantics
    (re-registering the same (name, kind) returns the existing metric —
    the engine and a bench harness may both ask for the same handle;
    a kind clash raises)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        """Get-or-create keyed by the full sample name, so each label
        combination of a family is its own gauge (``names()``/
        ``as_dict()`` list the labeled sample names literally)."""
        key = labeled_name(name, labels)
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, Gauge):
                raise ValueError(
                    f"metric {key!r} already registered as {m.kind}, "
                    f"requested gauge")
            return m
        m = Gauge(name, help, labels=labels)
        self._metrics[key] = m
        return m

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def as_dict(self) -> Dict[str, object]:
        """Plain-dict dump for ``stats(deep=True)`` and JSON records:
        counters/gauges as scalars, histograms as their summary
        dicts."""
        return {name: self._metrics[name].as_value()
                for name in sorted(self._metrics)}

    def exposition(self) -> str:
        """Prometheus text format (version 0.0.4): ``# HELP`` /
        ``# TYPE`` headers then the samples, one metric family per
        block, newline-terminated."""
        names = sorted(self._metrics)
        blocks = []
        done = set()
        for name in names:
            m = self._metrics[name]
            family = getattr(m, "family", m.name)
            if family in done:
                continue
            done.add(family)
            # every sample of the family (labeled gauges share one),
            # in sample-name order, under one HELP/TYPE header —
            # identical to the pre-label output for unlabeled metrics
            members = [self._metrics[n] for n in names
                       if getattr(self._metrics[n], "family",
                                  self._metrics[n].name) == family]
            lines = []
            help_text = next((x.help for x in members if x.help), "")
            if help_text:
                lines.append(f"# HELP {family} {help_text}")
            lines.append(f"# TYPE {family} {m.kind}")
            for x in members:
                lines.extend(x.expose())
            blocks.append("\n".join(lines))
        return "\n".join(blocks) + ("\n" if blocks else "")
