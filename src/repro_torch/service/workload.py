"""Workload generation for the online unlearning service — seeded,
wall-clock-free.

The service consumes a *trace*: a time-ordered list of ``ServiceRequest``
arrivals on a virtual clock (seconds since serve start).  Traces come from
seeded generators (Poisson and bursty arrival processes, optionally with
hot-client skew over the victim pool) or from a JSON trace file
(``save_trace``/``load_trace``), so every scheduling decision downstream is
reproducible run-to-run: nothing in the workload or scheduling logic reads
the wall clock — real time enters only in the serving ledger, where retrain
walls are *measured*.

``VirtualClock`` is the discrete-event clock the engine advances: it only
moves forward, and only to explicit event times (arrivals, policy timers).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ServiceRequest:
    """One online unlearning request.

    ``t`` — virtual arrival time (seconds since serve start).
    ``clients`` — concrete victim ids (service traces are fully resolved;
    the session-level callable form does not appear in traces).
    ``deadline`` — optional SLA budget in seconds *relative to arrival*;
    the ledger marks the request late when measured latency exceeds it.
    ``apply`` — serving semantics: fold the unlearned shard models back
    into the session's stage records.
    ``request_id`` — stable idempotency key threaded through the service
    ledger and journal replay; "" means "derive from rid" (``svc-<rid>``,
    see ``service_request_id``), so legacy traces keep working.
    """
    t: float
    clients: Tuple[int, ...]
    framework: str = "SE"
    rounds: Optional[int] = None
    deadline: Optional[float] = None
    apply: bool = False
    rid: int = -1
    request_id: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


def service_request_id(req: "ServiceRequest") -> str:
    """The request's stable idempotency key: its explicit ``request_id`` or
    the rid-derived ``svc-<rid>`` fallback.  Journal replay and the ledger
    key on this — never on list positions."""
    return req.request_id or f"svc-{req.rid}"


class VirtualClock:
    """Monotone discrete-event clock.  ``advance_to`` clamps backwards moves
    (an event in the past fires "now") so event loops cannot travel back."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, float(t))
        return self.now

    def advance(self, dt: float) -> float:
        return self.advance_to(self.now + max(float(dt), 0.0))


# ---------------------------------------------------------------------------
# Victim sampling — hot-client skew
# ---------------------------------------------------------------------------

def client_sampler(pool: Sequence[int], seed: int, skew: float = 0.0,
                   replace: bool = True):
    """Seeded victim sampler over ``pool``.

    ``skew`` > 0 gives a Zipf-like popularity profile: the pool is shuffled
    once (seeded), then client at popularity rank r is drawn with
    probability proportional to ``1 / (r+1)**skew`` — a few "hot" clients
    receive most of the erasure requests (the realistic serving regime).
    ``skew=0`` is uniform.  ``replace=False`` samples without replacement
    (raises once the pool is exhausted).
    """
    rng = np.random.default_rng(seed)
    order = list(rng.permutation(np.asarray(list(pool))))
    probs = np.array([1.0 / (r + 1) ** skew for r in range(len(order))])
    probs /= probs.sum()

    def sample(k: int = 1) -> List[int]:
        nonlocal order, probs
        if not replace and k > len(order):
            raise ValueError(f"pool exhausted: {k} requested, "
                             f"{len(order)} left")
        idx = rng.choice(len(order), size=k, replace=replace, p=probs)
        out = [int(order[i]) for i in idx]
        if not replace:
            drawn = set(idx.tolist())      # hoisted: O(n), not O(n*k)
            keep = [i for i in range(len(order)) if i not in drawn]
            order = [order[i] for i in keep]
            probs = probs[keep]
            if probs.sum() > 0:
                probs = probs / probs.sum()
        return out

    return sample


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

@dataclass
class TraceConfig:
    """Shared knobs for the arrival generators."""
    framework: str = "SE"
    rounds: Optional[int] = None
    deadline: Optional[float] = None
    apply: bool = False
    victims_per_request: int = 1
    skew: float = 0.0
    replace: bool = True
    pool: Sequence[int] = field(default_factory=list)   # victim pool


def iter_poisson_trace(pool: Sequence[int], n: int, rate: float,
                       seed: int = 0, **cfg_kw):
    """Generator twin of ``poisson_trace``: yields the ``n`` requests one at
    a time without materializing the trace list, so a 10⁵–10⁶-request
    Zipf-skewed replay holds one request in memory at a time.  Identical RNG
    consumption order to the list form — ``list(iter_poisson_trace(...))``
    is element-for-element equal to ``poisson_trace(...)`` for the same
    seed (asserted in ``tests/test_torch_service.py``)."""
    cfg = TraceConfig(pool=pool, **cfg_kw)
    rng = np.random.default_rng(seed)
    sample = client_sampler(cfg.pool, seed + 1, cfg.skew, cfg.replace)
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        yield ServiceRequest(
            t=t, clients=tuple(sample(cfg.victims_per_request)),
            framework=cfg.framework, rounds=cfg.rounds,
            deadline=cfg.deadline, apply=cfg.apply, rid=i)


def poisson_trace(pool: Sequence[int], n: int, rate: float, seed: int = 0,
                  **cfg_kw) -> List[ServiceRequest]:
    """``n`` requests with Exponential(1/rate) inter-arrival times —
    memoryless arrivals at ``rate`` requests per virtual second."""
    return list(iter_poisson_trace(pool, n, rate, seed=seed, **cfg_kw))


def bursty_trace(pool: Sequence[int], n: int, burst_rate: float,
                 mean_burst: float = 3.0, seed: int = 0,
                 **cfg_kw) -> List[ServiceRequest]:
    """Bursty arrivals: burst epochs are Poisson(``burst_rate``), burst sizes
    are Geometric with mean ``mean_burst``, and every request in a burst
    arrives at the same virtual instant (e.g. a data-breach disclosure
    triggering a wave of erasure requests)."""
    cfg = TraceConfig(pool=pool, **cfg_kw)
    rng = np.random.default_rng(seed)
    sample = client_sampler(cfg.pool, seed + 1, cfg.skew, cfg.replace)
    t, out = 0.0, []
    while len(out) < n:
        t += float(rng.exponential(1.0 / burst_rate))
        size = min(int(rng.geometric(1.0 / max(mean_burst, 1.0))), n - len(out))
        for _ in range(size):
            out.append(ServiceRequest(
                t=t, clients=tuple(sample(cfg.victims_per_request)),
                framework=cfg.framework, rounds=cfg.rounds,
                deadline=cfg.deadline, apply=cfg.apply, rid=len(out)))
    return out


def sequenced_trace(victims: Sequence[Sequence[int]], spacing: float = 0.0,
                    **cfg_kw) -> List[ServiceRequest]:
    """Deterministic trace from an explicit victim sequence — one request per
    entry, ``spacing`` seconds apart (0 = all arrive at t=0).  ``victims``
    entries may be a single client id or a sequence of ids."""
    cfg = TraceConfig(**cfg_kw)
    out = []
    for i, v in enumerate(victims):
        clients = (int(v),) if np.isscalar(v) else tuple(int(c) for c in v)
        out.append(ServiceRequest(
            t=i * spacing, clients=clients, framework=cfg.framework,
            rounds=cfg.rounds, deadline=cfg.deadline, apply=cfg.apply, rid=i))
    return out


# ---------------------------------------------------------------------------
# Trace files
# ---------------------------------------------------------------------------

def save_trace(path: str, trace: Sequence[ServiceRequest]) -> None:
    with open(path, "w") as f:
        json.dump({"requests": [r.to_dict() for r in trace]}, f, indent=2)


def save_trace_jsonl(path: str, trace) -> int:
    """Streaming trace writer: one JSON object per line, consuming ``trace``
    (any iterable, including the ``iter_*`` generators) one request at a
    time.  Returns the number of requests written."""
    n = 0
    with open(path, "w") as f:
        for r in trace:
            f.write(json.dumps(r.to_dict()) + "\n")
            n += 1
    return n


def _request_from_dict(r: dict, i: int) -> ServiceRequest:
    return ServiceRequest(t=float(r["t"]),
                          clients=tuple(int(c) for c in r["clients"]),
                          framework=r.get("framework", "SE"),
                          rounds=r.get("rounds"),
                          deadline=r.get("deadline"),
                          apply=bool(r.get("apply", False)),
                          rid=int(r.get("rid", i)),
                          request_id=str(r.get("request_id", "")))


def iter_trace(path: str):
    """Streaming trace reader: yields requests line-by-line from a JSONL
    trace (``save_trace_jsonl``) without materializing the list.  A legacy
    ``save_trace`` JSON file (first line is not a complete request object —
    either the root object spans lines or it carries the ``requests`` key)
    transparently falls back to ``load_trace`` — still a generator, but
    materialized underneath (the legacy format cannot be streamed)."""
    with open(path) as f:
        first = f.readline().strip()
        legacy = False
        if first:
            try:
                legacy = "requests" in json.loads(first)
            except json.JSONDecodeError:
                legacy = True              # root object spans multiple lines
        if legacy:
            yield from load_trace(path)
            return
        f.seek(0)
        for i, line in enumerate(f):
            line = line.strip()
            if line:
                yield _request_from_dict(json.loads(line), i)


def load_trace(path: str) -> List[ServiceRequest]:
    """Trace-file replay: the JSON twin of ``save_trace`` (requests are
    re-sorted by arrival time; ties keep file order)."""
    with open(path) as f:
        payload = json.load(f)
    reqs = [_request_from_dict(r, i)
            for i, r in enumerate(payload["requests"])]
    return sorted(reqs, key=lambda r: (r.t, r.rid))
