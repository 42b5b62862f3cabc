"""Fault events, typed fault errors, and the deterministic fault ledger.

Every injected fault and every recovery decision taken downstream (retry,
re-dispatch, degraded-mode fallback, abort) is recorded as a structured
event in a ``FaultLedger``.  Because injection decisions are pure functions
of ``(plan seed, site key)`` (see ``repro_torch.faults.plan``), replaying the same
fault plan against the same workload reproduces the *identical* ledger —
``FaultLedger.signature()`` is the canonical, thread-order-independent form
two runs are compared by.
"""
from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


# ---------------------------------------------------------------------------
# Typed fault errors (raised at injection sites, handled by recovery paths)
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base class for injected faults the recovery paths know how to handle.
    Anything *not* derived from this propagates — a chaos run must never
    swallow a genuine bug."""


class DeviceFault(FaultError):
    """A device failed: every job routed to it errors until it is marked
    unhealthy and traffic re-dispatches elsewhere."""

    def __init__(self, device: int):
        self.device = int(device)
        super().__init__(f"device {device} failed")


class JobHang(FaultError):
    """A job hung on its device.  The engine sleeps the (budget-capped)
    simulated hang, then treats the attempt as timed out.  A real stuck
    kernel cannot be preempted from a worker thread — a genuine hang needs
    process-level isolation; this models the *scheduling* consequence."""

    def __init__(self, device: int, hang_s: float):
        self.device = int(device)
        self.hang_s = float(hang_s)
        super().__init__(f"job hung on device {device} ({hang_s:.3f}s)")


class TransientJobError(FaultError):
    """A transient job exception (e.g. a flaky collective): retrying the
    same job — on the same or another device — is expected to succeed."""

    def __init__(self, key):
        self.key = key
        super().__init__(f"transient failure in job {key!r}")


class InjectedCrash(FaultError):
    """An injected process crash (the ``process_kill`` injector's in-process
    ``mode="raise"`` form): the session dies at a named crash site, leaving
    only its snapshots + journal behind.  Recovery is a *restart* —
    ``FederatedSession.run(resume_from=...)`` — not a retry."""

    def __init__(self, site):
        self.site = tuple(site)
        super().__init__(f"injected process crash at {self.site!r}")


# ---------------------------------------------------------------------------
# Structured events
# ---------------------------------------------------------------------------

def _canon(value):
    """Canonicalize event payloads so ``signature`` sorts deterministically."""
    if isinstance(value, dict):
        return tuple(sorted((k, _canon(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple, set, frozenset)):
        return tuple(_canon(v) for v in (sorted(value)
                                         if isinstance(value, (set, frozenset))
                                         else value))
    if isinstance(value, float):
        return round(value, 9)
    return value


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault: which injector fired, where, and with what."""
    kind: str                       # injector name, e.g. "slice_corruption"
    site: Tuple                     # deterministic site key it was drawn at
    detail: Tuple = ()              # canonicalized injector payload

    def to_dict(self) -> dict:
        return {"kind": self.kind, "site": list(map(str, self.site)),
                "detail": str(self.detail)}


@dataclass(frozen=True)
class DegradedModeEvent:
    """A subsystem degraded instead of failing: e.g. mid-stage client
    dropout made the stage ragged, so the stage-program engine fell back to
    the per-shard fused path rather than raising."""
    kind: str = field(default="degraded_mode", init=False)
    stage: int = 0
    reason: str = ""
    fallback: str = ""
    dropped_clients: Tuple[int, ...] = ()

    @property
    def site(self) -> Tuple:
        return ("stage", self.stage)

    @property
    def detail(self) -> Tuple:
        return (self.reason, self.fallback, self.dropped_clients)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "stage": self.stage, "reason": self.reason,
                "fallback": self.fallback,
                "dropped_clients": list(self.dropped_clients)}


@dataclass(frozen=True)
class RecoveryEvent:
    """One recovery decision taken downstream of a fault: a retry, a
    re-dispatch to a healthy device, a quorum-read decode, or an abort."""
    kind: str                       # "retry" | "redispatch" | "abort" | ...
    site: Tuple
    detail: Tuple = ()

    def to_dict(self) -> dict:
        return {"kind": self.kind, "site": list(map(str, self.site)),
                "detail": str(self.detail)}


class FaultLedger:
    """Thread-safe, append-only record of fault/recovery events.

    Worker threads record concurrently, so the in-memory order is not
    deterministic — ``signature()`` (sorted canonical tuples) is, and it is
    what replay tests compare.
    """

    def __init__(self):
        self._events: List = []
        self._lock = threading.Lock()

    def record(self, event) -> None:
        with self._lock:
            self._events.append(event)
        # single telemetry hook: every injection/recovery/degradation flows
        # through here, so the tracer sees them all as instant events
        from repro_torch.telemetry import get_tracer
        tr = get_tracer()
        if tr.enabled:
            family = ("fault.recovery" if isinstance(event, RecoveryEvent)
                      else "fault.degraded"
                      if isinstance(event, DegradedModeEvent)
                      else "fault.inject")
            tr.event(family, kind=event.kind, site=str(event.site))
            tr.metrics.counter(family, kind=event.kind).inc()

    @property
    def events(self) -> List:
        with self._lock:
            return list(self._events)

    def count(self, kind: str = None) -> int:
        evs = self.events
        if kind is None:
            return len(evs)
        return sum(1 for e in evs if e.kind == kind)

    def kinds(self) -> Dict[str, int]:
        return dict(Counter(e.kind for e in self.events))

    def signature(self) -> List[Tuple]:
        """Canonical, thread-order-independent form: the multiset of
        ``(kind, site, detail)`` tuples, sorted.  Two runs of the same plan
        on the same workload must produce equal signatures."""
        return sorted((e.kind, _canon(e.site), _canon(e.detail))
                      for e in self.events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_dict(self) -> dict:
        return {"num_events": self.count(), "by_kind": self.kinds(),
                "events": [e.to_dict() for e in self.events]}
