"""Scheduling policies for the online unlearning service.

A policy decides *when* queued requests dispatch and *which* dispatch
together (requests batched together are merged per impacted shard by the
engine, so each shard retrains once per batch).  Policies are pure functions
of the queue and the virtual clock — deterministic, wall-clock-free — and
live in a registry (``POLICIES`` / ``@register_policy``) like the store and
framework registries, so a third-party policy is one class away.

Built-ins:

* ``fifo``   — serve every request immediately on arrival, one dispatch per
  request in arrival order (the sequential baseline).
* ``window`` — fixed batch-window coalescing: arrivals inside one
  ``[k·w, (k+1)·w)`` window dispatch together when the window closes
  (generalizes the session's ``batch_requests=True``, which is one
  infinite window per stage boundary).
* ``sla``    — deadline-aware admission: each request must dispatch by
  ``arrival + deadline - est_serve`` (its latest safe start); until then it
  may be held to coalesce.  When a request comes due, every queued request
  sharing an impacted shard with the due set joins the batch (due requests
  merged per impacted shard — they retrain that shard anyway).

The engine drives the protocol:

* ``next_event(queue, now)`` — earliest virtual time the policy wants
  control back (window close, deadline), or ``None`` if it only reacts to
  arrivals / end-of-trace.
* ``release(queue, now, final)`` — batches ready to dispatch at ``now``
  (each a list of ``Pending``), removing them from ``queue``; ``final``
  means no more arrivals will come, so everything still queued must drain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple, Type

from repro_torch.service.workload import ServiceRequest


@dataclass
class Pending:
    """A queued request plus what the scheduler knows about it: its impacted
    (stage, shard) set, reported by the unlearning framework at admission."""
    req: ServiceRequest
    impacted: FrozenSet[Tuple[int, int]] = frozenset()

    @property
    def t(self) -> float:
        return self.req.t


class SchedulingPolicy:
    """Base policy.  Subclass, implement ``release`` (and ``next_event`` if
    the policy keeps its own timers), then ``@register_policy("name")``."""

    name: str = ""

    def next_event(self, queue: List[Pending],
                   now: float) -> Optional[float]:
        return None

    def release(self, queue: List[Pending], now: float,
                final: bool = False) -> List[List[Pending]]:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"policy": self.name}


POLICIES: Dict[str, Type[SchedulingPolicy]] = {}


def register_policy(*names: str):
    """Class decorator registering a ``SchedulingPolicy`` under ``names``."""
    if not names:
        raise ValueError("register_policy needs at least one name")

    def deco(cls: Type[SchedulingPolicy]) -> Type[SchedulingPolicy]:
        cls.name = names[0]
        for n in names:
            POLICIES[n] = cls
        return cls
    return deco


def make_policy(name: str, **options) -> SchedulingPolicy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r}; registered: "
                         f"{sorted(POLICIES)}") from None
    return cls(**options)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

@register_policy("fifo")
class FIFOPolicy(SchedulingPolicy):
    """Serve each request as soon as it arrives, in arrival order — one
    single-request dispatch per request (the sequential baseline every
    other policy is measured against)."""

    def release(self, queue: List[Pending], now: float,
                final: bool = False) -> List[List[Pending]]:
        ready = [p for p in queue if p.t <= now]
        ready.sort(key=lambda p: (p.t, p.req.rid))
        for p in ready:
            queue.remove(p)
        return [[p] for p in ready]


@register_policy("window")
class BatchWindowPolicy(SchedulingPolicy):
    """Fixed batch-window coalescing: requests arriving inside the same
    ``width``-second window dispatch as ONE batch when the window closes.
    ``width=inf`` (or anything non-positive… rejected) batches per drain."""

    def __init__(self, width: float = 1.0):
        if width <= 0:
            raise ValueError("window width must be positive")
        self.width = float(width)

    def _window_end(self, p: Pending) -> float:
        return (int(p.t / self.width) + 1) * self.width

    def next_event(self, queue: List[Pending],
                   now: float) -> Optional[float]:
        ends = [self._window_end(p) for p in queue]
        return min(ends) if ends else None

    def release(self, queue: List[Pending], now: float,
                final: bool = False) -> List[List[Pending]]:
        by_window: Dict[int, List[Pending]] = {}
        for p in list(queue):
            if final or self._window_end(p) <= now:
                by_window.setdefault(int(p.t / self.width), []).append(p)
                queue.remove(p)
        batches = []
        for k in sorted(by_window):
            batch = by_window[k]
            batch.sort(key=lambda p: (p.t, p.req.rid))
            batches.append(batch)
        return batches

    def describe(self) -> dict:
        return {"policy": self.name, "width": self.width}


@register_policy("sla")
class SLAPolicy(SchedulingPolicy):
    """Deadline/SLA-aware admission.

    A request's *latest safe start* is ``arrival + deadline - est_serve``
    (``default_deadline`` covers requests without one; ``est_serve`` is the
    configured — deterministic — serving-time estimate).  Requests are held
    to coalesce until some request comes due, at which point the due set
    dispatches together with every queued request that shares an impacted
    shard with it (those shards retrain anyway, so merging is free work).
    Overlap closure is computed transitively, so one batch covers a
    connected component of shard overlap.

    ``max_hold`` caps the hold independently of the deadline; it defaults
    to half of ``default_deadline`` so that, even with the default
    ``est_serve=0`` (no serving-time estimate), a request is never held
    right up to its own deadline — which would make every verdict a miss
    by construction.  Pass ``max_hold=float("inf")`` for purely
    deadline-driven holds.
    """

    def __init__(self, default_deadline: float = 10.0,
                 est_serve: float = 0.0, max_hold: Optional[float] = None):
        self.default_deadline = float(default_deadline)
        self.est_serve = float(est_serve)
        self.max_hold = (0.5 * self.default_deadline if max_hold is None
                         else float(max_hold))

    def _due_time(self, p: Pending) -> float:
        deadline = (p.req.deadline if p.req.deadline is not None
                    else self.default_deadline)
        due = p.t + max(deadline - self.est_serve, 0.0)
        return min(due, p.t + self.max_hold)

    def next_event(self, queue: List[Pending],
                   now: float) -> Optional[float]:
        dues = [self._due_time(p) for p in queue]
        return min(dues) if dues else None

    def release(self, queue: List[Pending], now: float,
                final: bool = False) -> List[List[Pending]]:
        if final:
            seed = list(queue)
        else:
            seed = [p for p in queue if self._due_time(p) <= now]
        if not seed:
            return []
        # transitive closure over shard overlap: a held request sharing any
        # impacted (stage, shard) with the due set rides along for free
        batch = list(seed)
        covered = set().union(*(p.impacted for p in batch)) if batch else set()
        grew = True
        while grew:
            grew = False
            for p in queue:
                if p in batch:
                    continue
                if p.impacted & covered:
                    batch.append(p)
                    covered |= p.impacted
                    grew = True
        batch.sort(key=lambda p: (p.t, p.req.rid))
        for p in batch:
            queue.remove(p)
        return [batch]

    def describe(self) -> dict:
        return {"policy": self.name,
                "default_deadline": self.default_deadline,
                "est_serve": self.est_serve, "max_hold": self.max_hold}
