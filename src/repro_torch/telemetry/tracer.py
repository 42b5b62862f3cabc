"""Structured span tracing — nested, thread-safe, dual-clocked.

One ``Tracer`` records a forest of ``Span``s: every instrumented layer
(``FederatedSession``, ``UnlearningService``, ``CodedStore``, fault
injection, snapshot/journal I/O) opens spans through the single
``get_tracer()`` entry point::

    with get_tracer().span("stage.train", engine="stage", shards=2):
        ...

Design points, in the order they matter:

* **No-op by default.**  ``get_tracer()`` returns the ``NULL_TRACER``
  singleton until ``configure(enabled=True)`` installs a recording tracer,
  and the null tracer's ``span``/``event`` return one preallocated null
  context manager — the instrumented hot paths pay a dict build and two
  no-op calls, nothing else (bounded against a stage's wall in
  ``tests/test_torch_telemetry.py`` and in ``chip_smoke.py``'s ``service``
  phase).
* **Thread-safe nesting.**  Each thread keeps its own span stack
  (``threading.local``): a span closed on the thread that opened it
  attaches to that thread's enclosing span, or — for the service's
  ``unlearn-serve`` worker threads, whose stacks start empty — becomes a
  new root under the tracer lock.  Parent/child order within a thread is
  therefore deterministic; only the root list is completion-ordered, and
  every tree/signature/export consumer re-sorts roots canonically.
* **Dual clocks.**  Every span records wall offsets from the tracer epoch
  (``time.perf_counter``) and, when a ``VirtualClock`` is attached
  (``attach_clock`` — the service engine attaches its discrete-event clock
  while planning), the deterministic virtual time at entry and exit.  The
  canonical ``signature()`` hashes names, labels, virtual times, and
  nesting — never wall times or thread names — so two seeded service runs
  produce bit-identical span trees (asserted in tests).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import List, Optional

from repro_torch.telemetry.metrics import MetricsRegistry, NullMetrics


class Span:
    """One traced operation.  Context manager: entering pushes it on the
    current thread's stack, exiting records end times and attaches it to
    the enclosing span (or the tracer's root list)."""

    __slots__ = ("name", "labels", "kind", "t0", "t1", "v0", "v1", "lane",
                 "children", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, labels: dict,
                 kind: str = "span"):
        self._tracer = tracer
        self.name = name
        self.labels = labels
        self.kind = kind                  # "span" | "event" (zero-duration)
        self.t0 = self.t1 = 0.0           # wall offsets from tracer epoch
        self.v0 = self.v1 = None          # virtual times (clock attached)
        self.lane = ""
        self.children: List["Span"] = []

    # ---------------------------------------------------------------- enter
    def __enter__(self) -> "Span":
        tr = self._tracer
        self.lane = threading.current_thread().name
        self.t0 = time.perf_counter() - tr.epoch
        clock = tr.clock
        if clock is not None:
            self.v0 = float(clock.now)
        tr._stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        self.t1 = time.perf_counter() - tr.epoch
        clock = tr.clock
        if clock is not None:
            self.v1 = float(clock.now)
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1].children.append(self)
        else:
            with tr._lock:
                tr.roots.append(self)
        return False

    def annotate(self, **labels) -> "Span":
        """Attach labels after creation (e.g. recovery counts discovered
        mid-span, FLOP/byte estimates of the dispatched program)."""
        self.labels.update(labels)
        return self

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "labels": dict(self.labels), "lane": self.lane,
                "t0_s": self.t0, "t1_s": self.t1,
                "v0_s": self.v0, "v1_s": self.v1,
                "children": [c.to_dict() for c in self.children]}


class _NullSpan:
    """The preallocated no-op span: entering/exiting/annotating costs two
    attribute lookups and nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def annotate(self, **labels):
        return self


_NULL_SPAN = _NullSpan()


def _canon_value(v):
    """Canonicalize a label value for the deterministic signature."""
    if isinstance(v, (list, tuple)):
        return [_canon_value(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def _canon_node(span: Span) -> dict:
    """The deterministic form of one span: name, labels, virtual times,
    children — wall times and thread lanes deliberately excluded."""
    return {"name": span.name, "kind": span.kind,
            "labels": {k: _canon_value(v)
                       for k, v in sorted(span.labels.items())},
            "v0": span.v0, "v1": span.v1,
            "children": [_canon_node(c) for c in span.children]}


class Tracer:
    """A recording tracer: span forest + metrics registry + exporter state."""

    enabled = True

    def __init__(self, clock=None, annotate_costs: bool = False):
        self.epoch = time.perf_counter()
        self.clock = clock                 # optional VirtualClock
        self.annotate_costs = bool(annotate_costs)
        self.metrics = MetricsRegistry()
        self.roots: List[Span] = []
        self.trace_path: Optional[str] = None
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # ------------------------------------------------------------------ api
    def span(self, name: str, **labels) -> Span:
        return Span(self, name, labels)

    def event(self, name: str, **labels) -> None:
        """Record an instant (zero-duration) event at the current nesting."""
        with Span(self, name, labels, kind="event"):
            pass

    def attach_clock(self, clock) -> None:
        """Attach a ``VirtualClock``: subsequent spans carry deterministic
        virtual times alongside their measured wall offsets."""
        self.clock = clock

    def detach_clock(self) -> None:
        self.clock = None

    # ------------------------------------------------------------ inspection
    def sorted_roots(self) -> List[Span]:
        """Roots in canonical order — completion order is thread-racy, so
        every consumer (tree, signature, export) sorts by the deterministic
        node form first, wall start second (same-thread ties)."""
        with self._lock:
            roots = list(self.roots)
        return sorted(roots, key=lambda s: (json.dumps(
            _canon_node(s), sort_keys=True), s.t0))

    def all_spans(self) -> List[Span]:
        out: List[Span] = []

        def walk(span: Span):
            out.append(span)
            for c in span.children:
                walk(c)

        for root in self.sorted_roots():
            walk(root)
        return out

    def span_names(self) -> List[str]:
        return sorted({s.name for s in self.all_spans()})

    def tree(self) -> List[dict]:
        """The canonical (deterministic) span forest."""
        return [_canon_node(r) for r in self.sorted_roots()]

    def signature(self) -> str:
        """sha256 over the canonical span forest — two seeded runs of the
        same workload must produce equal signatures (wall times excluded)."""
        blob = json.dumps(self.tree(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def describe(self) -> dict:
        """The report-embeddable summary (``telemetry`` section of
        ``SessionReport``/``ServiceReport`` JSON)."""
        return {"enabled": True,
                "num_spans": len(self.all_spans()),
                "span_signature": self.signature(),
                "trace_path": self.trace_path,
                "metrics": self.metrics.snapshot()}


class NullTracer:
    """The disabled tracer: every operation is a no-op and ``span``/``event``
    allocate nothing beyond the caller's kwargs dict."""

    enabled = False
    clock = None
    annotate_costs = False
    trace_path = None
    metrics = NullMetrics()
    roots: List[Span] = []

    def span(self, name: str, **labels) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **labels) -> None:
        pass

    def attach_clock(self, clock) -> None:
        pass

    def detach_clock(self) -> None:
        pass

    def sorted_roots(self) -> list:
        return []

    def all_spans(self) -> list:
        return []

    def span_names(self) -> list:
        return []

    def tree(self) -> list:
        return []

    def signature(self) -> str:
        return ""

    def describe(self) -> dict:
        return {"enabled": False}


NULL_TRACER = NullTracer()
_CURRENT: object = NULL_TRACER


def get_tracer():
    """The process-wide tracer — ``NULL_TRACER`` until ``configure`` installs
    a recording one.  The single entry point every instrumented layer uses."""
    return _CURRENT


def set_tracer(tracer) -> None:
    global _CURRENT
    _CURRENT = tracer if tracer is not None else NULL_TRACER


def configure(enabled: bool = True, clock=None,
              annotate_costs: bool = False):
    """Install (and return) a fresh recording tracer, or restore the no-op
    default with ``enabled=False``.

    ``annotate_costs=True`` additionally annotates the stage engine's
    ``device.stage_program`` span with the analytic FLOP and byte counts of
    its training steps (``export.stage_cost``: ``train_flops``,
    ``train_bytes``) and, where the program encodes, of its encode
    (``export.encode_cost``: ``encode_flops``, ``encode_bytes``).
    """
    if not enabled:
        set_tracer(None)
        return NULL_TRACER
    tracer = Tracer(clock=clock, annotate_costs=annotate_costs)
    set_tracer(tracer)
    return tracer
