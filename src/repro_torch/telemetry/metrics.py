"""Metrics registry — counters, gauges, and histograms with label sets.

The registry is the numeric half of the telemetry layer: the span tracer
answers "where did the time go", the registry answers "how much of what".
It absorbs and re-exposes the accounting the subsystems already keep —
``StoreStats`` byte/FLOP counters, the service's fault-recovery counters,
and ``ServiceReport`` latency percentiles — and adds the per-client p99
unlearning-latency breakdown (aggregate p99 hides hot-client
starvation; FedShard, arXiv 2508.09866).

Conventions:

* ``counter(name, **labels)`` — monotone, ``.inc()`` at the instrumentation
  site (fault events, served requests).
* ``gauge(name, **labels)`` — last-write-wins, used by the ``absorb_*``
  helpers so re-absorbing a snapshot is idempotent (reports can call
  ``to_dict`` twice without double counting).
* ``histogram(name, **labels)`` — raw observations with exact percentiles
  (``observe`` per served request; per-client p99 comes from the
  ``client=<id>`` label set).

Every metric family is keyed on ``(name, sorted labels)``; ``snapshot()``
renders ``name{k=v,...}`` keys, the form embedded in report JSON.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_key(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    __slots__ = ("values", "_lock")

    def __init__(self, lock: threading.Lock):
        self.values: List[float] = []
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = list(self.values)
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals, np.float64), q))

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Thread-safe, label-keyed metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}

    def _get(self, table: dict, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        with self._lock:
            m = table.get(key)
            if m is None:
                m = table[key] = cls(self._lock)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {_render_key(n, k): c.value
                         for (n, k), c in sorted(counters.items())},
            "gauges": {_render_key(n, k): g.value
                       for (n, k), g in sorted(gauges.items())},
            "histograms": {_render_key(n, k): h.summary()
                           for (n, k), h in sorted(hists.items())},
        }

    # ------------------------------------------------------ absorb existing
    def absorb_store_stats(self, stats, **labels) -> None:
        """Re-expose a ``StoreStats`` snapshot as ``store.<field>`` gauges
        (idempotent — absorbing the same snapshot twice is a no-op).  The
        per-tier dict fields of a tiered store fan out into one gauge per
        tier label: ``store.tier_bytes{tier=warm}`` etc."""
        for field, value in stats.to_dict().items():
            if isinstance(value, dict):
                for tier, v in value.items():
                    self.gauge(f"store.{field}", tier=tier, **labels).set(v)
            else:
                self.gauge(f"store.{field}", **labels).set(value)

    def absorb_faults(self, faults: dict, **labels) -> None:
        """Re-expose a serve's fault/recovery counters (the ``faults`` dict
        of ``ServiceReport``) as ``faults.<name>`` gauges."""
        for k, v in faults.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(f"faults.{k}", **labels).set(v)

    def absorb_service_report(self, report, **labels) -> None:
        """Re-expose a ``ServiceReport``'s aggregates — latency p50/p95/p99,
        throughput, SLA hit rate — plus the per-client p99 breakdown."""
        self.gauge("service.latency_p50_s", **labels).set(report.p50)
        self.gauge("service.latency_p95_s", **labels).set(report.p95)
        self.gauge("service.latency_p99_s", **labels).set(report.p99)
        self.gauge("service.throughput_rps", **labels).set(report.throughput)
        sla = report.sla_hit_rate
        if sla is not None:
            self.gauge("service.sla_hit_rate", **labels).set(sla)
        self.gauge("service.num_requests", **labels).set(len(report.entries))
        self.absorb_faults(report.faults, **labels)
        for client, p99 in report.per_client_p99().items():
            self.gauge("service.client_latency_p99_s", client=client,
                       **labels).set(p99)

    def per_client_p99(self, name: str = "service.client_latency_s") -> dict:
        """{client: p99} from the per-client latency histograms the serving
        engine observes into ``name{client=<id>}``."""
        with self._lock:
            hists = dict(self._histograms)
        out = {}
        for (n, key), h in hists.items():
            if n != name:
                continue
            labels = dict(key)
            if "client" in labels:
                out[int(labels["client"])] = h.percentile(99)
        return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# No-op twins (the NullTracer's .metrics)
# ---------------------------------------------------------------------------

class _NullInstrument:
    __slots__ = ()
    value = 0.0
    values: List[float] = []
    count = 0
    sum = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return float("nan")

    def summary(self) -> dict:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    """No-op registry: every accessor returns the shared null instrument."""

    __slots__ = ()

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}

    def absorb_store_stats(self, stats, **labels) -> None:
        pass

    def absorb_faults(self, faults: dict, **labels) -> None:
        pass

    def absorb_service_report(self, report, **labels) -> None:
        pass

    def per_client_p99(self, name: str = "service.client_latency_s") -> dict:
        return {}
