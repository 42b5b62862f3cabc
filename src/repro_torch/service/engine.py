"""The online unlearning service engine: event loop, async dispatch, SLA
ledger (``repro.service.engine`` on torch).

``UnlearningService`` turns a trained ``FederatedSession`` into a server for
a *stream* of unlearning requests:

1. **Schedule** (deterministic, virtual time): arrivals from the workload
   trace are admitted to a queue as the discrete-event clock advances; the
   scheduling policy (``repro_torch.service.policy``) decides when queued
   requests dispatch and which coalesce into one batch.  Nothing here reads
   the wall clock, so the dispatch plan is a pure function of (trace,
   policy, session) — and equal to the reference's for the same trace.
2. **Dispatch** (asynchronous, measured): each batch's requests merge per
   compatible serving options (the session's union-of-clients semantics);
   every impacted (stage, shard) becomes an independent shard-retraining
   job placed on a slot by ``DevicePlacement`` and dispatched without
   blocking.  On CUDA a job runs on its slot's own stream, ordered after
   the dispatching thread's stream, and its worker waits for that stream
   before the ledger reads the result (``DevicePlacement.run``).
3. **Ledger**: per request — queue wait (virtual), batch wait (measured
   executor delay), retrain wall (measured), end-to-end latency, SLA
   verdict — aggregated into a ``ServiceReport`` with p50/p95/p99 latency
   and throughput.

Serving runs in **throughput mode**: batches are dispatched back-to-back
as fast as the placement accepts them, not paced to the virtual timeline
(virtual seconds are not wall seconds).  On a multi-batch trace a later
batch's measured ``batch_wait`` can therefore include capacity contention
from earlier batches that, on the virtual timeline, would already have
drained during its (separately charged) ``queue_wait`` — latencies and SLA
verdicts are *conservative upper bounds*.

The sequential baseline (``policy="fifo"`` + ``single_device_placement()``)
takes the same code path as ``FederatedSession.run`` serving the same
trace — single-victim serves are bit-identical.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.faults.events import (DeviceFault, FaultError, JobHang,
                                 RecoveryEvent)
from repro_torch.fl.experiment.frameworks import (FRAMEWORKS, UnlearnContext,
                                            get_framework, run_prepared_job)
from repro_torch.fl.experiment.session import UnlearnRequest
from repro_torch.fl.simulator import UnlearnResult
from repro_torch.service.placement import DevicePlacement
from repro_torch.service.policy import Pending, SchedulingPolicy, make_policy
from repro_torch.service.workload import (ServiceRequest, VirtualClock,
                                    service_request_id)
from repro_torch.telemetry import AuditLog, get_tracer


@dataclass(frozen=True)
class RetryPolicy:
    """How the service reacts to a failed job attempt.

    ``max_retries`` bounds re-dispatches per job (after which the job aborts
    cleanly into the ledger); ``backoff``/``backoff_factor``/``max_backoff``
    shape the bounded exponential sleep between attempts.  ``timeout`` caps
    the *simulated* hang of an injected ``JobHang`` — it deliberately does
    NOT arm a wall-clock watchdog on real jobs, because elapsed-time-based
    fault events would vary run-to-run and break ledger replay (and a stuck
    kernel cannot be preempted from a worker thread anyway; genuine hang
    isolation needs a process boundary).
    """
    max_retries: int = 2
    timeout: Optional[float] = None
    backoff: float = 0.02
    backoff_factor: float = 2.0
    max_backoff: float = 0.25

    def backoff_for(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        return min(self.backoff * self.backoff_factor ** (attempt - 1),
                   self.max_backoff)

    def describe(self) -> dict:
        return {"max_retries": self.max_retries, "timeout": self.timeout,
                "backoff": self.backoff,
                "backoff_factor": self.backoff_factor,
                "max_backoff": self.max_backoff}


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------

@dataclass
class LedgerEntry:
    """One served request's latency decomposition.

    ``queue_wait`` is virtual (arrival -> policy release, deterministic);
    ``batch_wait`` and ``retrain_wall`` are measured — dispatch -> first job
    start (waiting for a free device/worker), and first job start -> last
    job blocked (the retraining itself).  ``latency`` =
    ``queue_wait + batch_wait + retrain_wall`` — the end-to-end figure the
    SLA verdict uses.
    """
    rid: int
    arrival: float
    clients: Tuple[int, ...]
    framework: str
    batch_id: int
    queue_wait: float = 0.0
    batch_wait: float = 0.0
    retrain_wall: float = 0.0
    latency: float = 0.0
    n_jobs: int = 0
    devices: List[int] = field(default_factory=list)
    impacted: List[Tuple[int, int]] = field(default_factory=list)
    cost_units: float = 0.0
    deadline: Optional[float] = None
    sla_met: Optional[bool] = None
    job_attempts: int = 0             # total attempts across this serve's jobs
    job_retries: int = 0              # attempts beyond the first
    aborted: bool = False             # some job exhausted its retry budget
    request_id: str = ""              # stable idempotency key (svc-<rid> fallback)

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id or f"svc-{self.rid}",
            "rid": self.rid, "arrival_s": self.arrival,
            "clients": list(self.clients), "framework": self.framework,
            "batch_id": self.batch_id, "queue_wait_s": self.queue_wait,
            "batch_wait_s": self.batch_wait,
            "retrain_wall_s": self.retrain_wall, "latency_s": self.latency,
            "n_jobs": self.n_jobs, "devices": list(self.devices),
            "impacted": [list(p) for p in self.impacted],
            "cost_units": self.cost_units, "deadline_s": self.deadline,
            "sla_met": self.sla_met, "job_attempts": self.job_attempts,
            "job_retries": self.job_retries, "aborted": self.aborted,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LedgerEntry":
        """Inverse of ``to_dict`` — journal replay rebuilds committed
        entries bit-identically from their ``svc_commit`` payloads."""
        return cls(
            rid=int(d["rid"]), arrival=float(d["arrival_s"]),
            clients=tuple(int(c) for c in d["clients"]),
            framework=d["framework"], batch_id=int(d["batch_id"]),
            queue_wait=float(d["queue_wait_s"]),
            batch_wait=float(d["batch_wait_s"]),
            retrain_wall=float(d["retrain_wall_s"]),
            latency=float(d["latency_s"]), n_jobs=int(d["n_jobs"]),
            devices=[int(x) for x in d["devices"]],
            impacted=[tuple(p) for p in d["impacted"]],
            cost_units=float(d["cost_units"]),
            deadline=d["deadline_s"], sla_met=d["sla_met"],
            job_attempts=int(d["job_attempts"]),
            job_retries=int(d["job_retries"]),
            aborted=bool(d["aborted"]),
            request_id=str(d.get("request_id", "")))


@dataclass
class ServiceReport:
    """Per-request ledger plus the serving aggregates the paper's SLA story
    needs: latency percentiles, throughput, batching/placement effect."""
    entries: List[LedgerEntry] = field(default_factory=list)
    policy: dict = field(default_factory=dict)
    placement: dict = field(default_factory=dict)
    serve_wall: float = 0.0
    num_batches: int = 0
    faults: dict = field(default_factory=dict)   # attempts/retries/recoveries

    # ------------------------------------------------------------ aggregates
    @property
    def completed(self) -> List[LedgerEntry]:
        """Entries whose jobs all finished (aborted serves excluded — their
        latencies describe the failure, not the service)."""
        return [e for e in self.entries if not e.aborted]

    @property
    def latencies(self) -> np.ndarray:
        return np.asarray([e.latency for e in self.completed], np.float64)

    def percentile(self, q: float) -> float:
        """Latency percentile over completed requests; ``nan`` when the
        ledger is empty or every request aborted (never raises)."""
        lat = self.latencies
        return float(np.percentile(lat, q)) if lat.size else float("nan")

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def throughput(self) -> float:
        """Completed requests per measured serving second; ``nan`` for an
        empty/all-aborted ledger or an unmeasured serve (never raises)."""
        done = len(self.completed)
        if not done or self.serve_wall <= 0.0:
            return float("nan")
        return done / self.serve_wall

    @property
    def sla_hit_rate(self) -> Optional[float]:
        """Fraction of deadline-carrying completed requests that met their
        deadline; ``None`` when no completed request had a deadline."""
        verdicts = [e.sla_met for e in self.completed
                    if e.sla_met is not None]
        if not verdicts:
            return None
        return sum(verdicts) / len(verdicts)

    @property
    def num_aborted(self) -> int:
        return sum(1 for e in self.entries if e.aborted)

    @property
    def total_retrain_wall(self) -> float:
        return sum(e.retrain_wall for e in self.entries)

    def per_client_p99(self) -> Dict[int, float]:
        """{client: p99 latency} over completed requests naming the client —
        the per-client breakdown aggregate percentiles hide (a hot client can
        starve behind a healthy aggregate p99)."""
        by_client: Dict[int, List[float]] = {}
        for e in self.completed:
            for c in e.clients:
                by_client.setdefault(int(c), []).append(e.latency)
        return {c: float(np.percentile(np.asarray(v, np.float64), 99))
                for c, v in sorted(by_client.items())}

    def to_dict(self) -> dict:
        d = {
            "policy": self.policy,
            "placement": self.placement,
            "num_requests": len(self.entries),
            "num_batches": self.num_batches,
            "num_aborted": self.num_aborted,
            "serve_wall_s": self.serve_wall,
            "throughput_rps": self.throughput,
            "latency_p50_s": self.p50,
            "latency_p95_s": self.p95,
            "latency_p99_s": self.p99,
            "sla_hit_rate": self.sla_hit_rate,
            "faults": self.faults,
            # keyed on the stable request_id, not list position, so journal
            # replay / resumed serves merge into an identical report
            "requests": {(e.request_id or f"svc-{e.rid}"): e.to_dict()
                         for e in self.entries},
            "client_latency_p99_s": {str(c): v for c, v
                                     in self.per_client_p99().items()},
        }
        tr = get_tracer()
        if tr.enabled:
            d["telemetry"] = tr.describe()
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)


# ---------------------------------------------------------------------------
# Internal dispatch records
# ---------------------------------------------------------------------------

@dataclass
class _Batch:
    bid: int
    time: float                       # virtual release time
    pendings: List[Pending]


@dataclass
class _Serve:
    """One merged request-group in flight: its per-stage job futures plus
    everything the gather pass needs to assemble ``UnlearnResult``s and
    ledger entries."""
    batch: _Batch
    requests: List[Pending]
    framework: str
    rounds: Optional[int]
    apply: bool
    clients: List[int]
    stage_ctxs: Dict[int, UnlearnContext] = field(default_factory=dict)
    stage_jobs: Dict[int, list] = field(default_factory=dict)  # futures
    dispatch_off: float = 0.0          # wall offset at dispatch


class UnlearningService:
    """Event-driven serving of unlearning requests against a trained
    ``FederatedSession``.

    >>> service = UnlearningService(session, policy="window",
    ...                             policy_opts={"width": 0.5})
    >>> report = service.serve(poisson_trace(plan.clients, n=16, rate=8.0))
    >>> print(report.p95, report.throughput)
    """

    def __init__(self, session, policy="fifo",
                 policy_opts: Optional[dict] = None,
                 placement: Optional[DevicePlacement] = None,
                 faults=None, retry: Optional[RetryPolicy] = None,
                 journal=None):
        self.session = session
        self.policy: SchedulingPolicy = (
            make_policy(policy, **(policy_opts or {}))
            if isinstance(policy, str) else policy)
        # default: every CUDA device, one slot each; a session the caller
        # put on the CPU gets one CPU slot
        if placement is None:
            dev = session.sim.device
            placement = DevicePlacement(
                devices=None if dev.type == "cuda" else [dev])
        self.placement = placement
        self.faults = faults                      # optional FaultPlan
        self.retry = retry or RetryPolicy()
        # optional repro_torch.durability.Journal: svc_dispatch before any retrain
        # work, svc_commit (with the full ledger entry) after — a crash in
        # between leaves the id dispatched-but-uncommitted, and
        # serve(resume=True) re-dispatches it exactly once
        self.journal = journal
        # hash-chained lifecycle audit (received → scheduled → retrained →
        # committed); with a journal the chain is durable and a fresh service
        # on the same journal splices onto the existing chain (resume path)
        self.audit = AuditLog(journal=journal)

    def _journal(self, event: dict) -> None:
        if self.journal is not None:
            self.journal.append(event)

    # ------------------------------------------------------------- recovery
    def _attempt_with_retries(self, key: tuple, dev_idx: int, body):
        """Run ``body(dev_idx)`` with the service's recovery semantics:
        consult the fault plan per attempt (straggler delay / injected
        error), catch ONLY typed ``FaultError``s (genuine bugs propagate),
        mark failed/hung devices unhealthy and re-dispatch to the next
        healthy one, back off exponentially between attempts, and abort
        cleanly once ``retry.max_retries`` re-dispatches are spent.

        Returns ``(result_or_None, dev_idx, attempts, aborted)``.
        """
        plan, rp = self.faults, self.retry
        attempts = 0
        while True:
            attempts += 1
            try:
                err = None
                if plan is not None:
                    delay, err = plan.job_action(key, attempts, dev_idx)
                    if delay:
                        time.sleep(delay)
                if err is not None:
                    if isinstance(err, JobHang):
                        hang = err.hang_s if rp.timeout is None \
                            else min(err.hang_s, rp.timeout)
                        time.sleep(max(hang, 0.0))
                    raise err
                return body(dev_idx), dev_idx, attempts, False
            except FaultError as exc:
                if isinstance(exc, (DeviceFault, JobHang)):
                    self.placement.mark_unhealthy(dev_idx)
                if attempts > rp.max_retries:
                    if plan is not None:
                        plan.ledger.record(RecoveryEvent(
                            "abort", site=key,
                            detail=(attempts, type(exc).__name__)))
                    return None, dev_idx, attempts, True
                time.sleep(rp.backoff_for(attempts))
                if isinstance(exc, (DeviceFault, JobHang)):
                    # device-level fault: re-dispatch to the next healthy
                    # device (deterministic; never consumes the rr cursor)
                    dev_idx = self.placement.reassign(dev_idx)
                    event = "redispatch"
                else:
                    # job-level transient: same device, fresh attempt
                    event = "retry"
                if plan is not None:
                    plan.ledger.record(RecoveryEvent(
                        event, site=key,
                        detail=(attempts, type(exc).__name__)))

    # ----------------------------------------------------------- scheduling
    def _impact_of(self, req: ServiceRequest) -> frozenset:
        """What the request's framework reports it would retrain — the
        (stage, shard) pairs the scheduler merges and places by."""
        fw_cls = FRAMEWORKS.get(req.framework)
        if fw_cls is None:
            raise ValueError(f"unknown unlearning framework "
                             f"{req.framework!r} in request {req.rid}")
        out = set()
        for i, rec in enumerate(self.session.records):
            stage_clients = [c for c in req.clients
                             if c in set(rec.plan.clients)]
            if not stage_clients:
                continue
            for s in fw_cls.impacted_shards(rec.plan, stage_clients):
                out.add((i, s))
        return frozenset(out)

    def plan_schedule(self, trace) -> List[_Batch]:
        """The deterministic half: run the discrete-event loop over the
        trace and return the dispatch plan (who batches with whom, when).
        Pure virtual time — no wall clock, no device work.

        ``trace`` may be a materialized sequence (sorted here) or any
        iterable/generator (streaming replay: requests are
        admitted one at a time and never held as a list — the stream must
        arrive in non-decreasing ``t`` order, which the seeded ``iter_*``
        generators produce by construction).  Both forms plan, audit, and
        serve bit-identically for the same requests."""
        if isinstance(trace, Sequence):
            trace = sorted(trace, key=lambda r: (r.t, r.rid))
        return self._plan_stream(iter(trace))

    def _plan_stream(self, it) -> List[_Batch]:
        """The discrete-event loop: pulls one request ahead of the clock,
        records its ``received`` audit at admission, and enforces the
        monotone-arrival contract a stream cannot be re-sorted around."""
        clock = VirtualClock()
        tr = get_tracer()
        tr.attach_clock(clock)
        queue: List[Pending] = []
        batches: List[_Batch] = []
        nxt = next(it, None)
        last_t = float("-inf")
        n = 0
        with tr.span("service.plan") as sp:
            while nxt is not None or queue:
                candidates = []
                if nxt is not None:
                    candidates.append(nxt.t)
                t_policy = self.policy.next_event(queue, clock.now)
                if t_policy is not None:
                    candidates.append(t_policy)
                final = not candidates
                if candidates:
                    clock.advance_to(min(candidates))
                while nxt is not None and nxt.t <= clock.now:
                    if nxt.t < last_t:
                        raise ValueError(
                            f"streamed trace is not time-ordered: request "
                            f"{nxt.rid} arrives at t={nxt.t} after t="
                            f"{last_t}; stream traces must be sorted "
                            f"(materialize + sort, or generate in order)")
                    last_t = nxt.t
                    self.audit.record("received",
                                      request_id=service_request_id(nxt),
                                      clients=list(nxt.clients),
                                      framework=nxt.framework,
                                      t_virtual=nxt.t)
                    queue.append(Pending(nxt,
                                         impacted=self._impact_of(nxt)))
                    n += 1
                    nxt = next(it, None)
                for group in self.policy.release(queue, clock.now,
                                                 final=final):
                    batches.append(_Batch(len(batches), clock.now, group))
                if final and queue:
                    batches.append(_Batch(len(batches), clock.now,
                                          list(queue)))
                    queue.clear()
            sp.annotate(requests=n, batches=len(batches))
        self._audit_scheduled(batches)
        return batches

    def _audit_scheduled(self, batches: List[_Batch]) -> None:
        for b in batches:
            for p in b.pendings:
                self.audit.record(
                    "scheduled", request_id=service_request_id(p.req),
                    batch_id=b.bid, t_virtual=b.time,
                    shards=[list(x) for x in sorted(p.impacted)])

    # ------------------------------------------------------------- dispatch
    def _merge_groups(self, batch: _Batch) -> List[_Serve]:
        """Union-of-clients merge per compatible serving options — the same
        grouping rule as ``FederatedSession.unlearn_batch``."""
        groups: Dict[tuple, _Serve] = {}
        for p in batch.pendings:
            key = (p.req.framework, p.req.rounds, p.req.apply)
            serve = groups.get(key)
            if serve is None:
                serve = groups[key] = _Serve(
                    batch=batch, requests=[], framework=p.req.framework,
                    rounds=p.req.rounds, apply=p.req.apply, clients=[])
            serve.requests.append(p)
            for c in p.req.clients:
                if c not in serve.clients:
                    serve.clients.append(c)
        return list(groups.values())

    def _job_shard(self, serve: _Serve, stage: int, shard: int,
                   dev_idx: int, t0: float):
        """Worker body for one shard-level retraining job: on the slot's
        stream, prepare from the (lock-protected) store, run the G'
        calibration rounds, and wait only for this job's own stream — the
        completion ledger."""
        ctx = serve.stage_ctxs[stage]
        fw = get_framework(serve.framework)
        start = time.perf_counter() - t0

        def work(device):
            job = fw.prepare_shard_job(ctx, shard)
            if job is None:
                return {"models": {}, "cost": 0.0}
            s, w, cost = run_prepared_job(ctx, job, device=device)
            return {"models": {s: w}, "cost": cost}

        def body(dev: int):
            return self.placement.run(dev, work)

        key = ("shard", stage, shard, tuple(serve.clients))
        with get_tracer().span("service.job", kind="shard", stage=stage,
                               shard=shard, batch=serve.batch.bid) as sp:
            out, dev_idx, attempts, aborted = self._attempt_with_retries(
                key, dev_idx, body)
            sp.annotate(device=dev_idx, attempts=attempts, aborted=aborted)
        if out is None:
            out = {"models": {}, "cost": 0.0}
        return {**out, "start": start, "done": time.perf_counter() - t0,
                "device": dev_idx, "attempts": attempts, "aborted": aborted}

    def _job_federation(self, serve: _Serve, stage: int, dev_idx: int,
                        t0: float):
        """Worker body for a federation-level framework (FE/FR/RR): one job
        retraining everything — still dispatched asynchronously so it
        overlaps with other in-flight serves."""
        ctx = serve.stage_ctxs[stage]
        fw = get_framework(serve.framework)
        start = time.perf_counter() - t0

        def work(_device):
            models, cost = fw.run(ctx)
            return {"models": models, "cost": cost}

        def body(dev: int):
            return self.placement.run(dev, work)

        key = ("federation", stage, tuple(serve.clients))
        with get_tracer().span("service.job", kind="federation", stage=stage,
                               batch=serve.batch.bid) as sp:
            out, dev_idx, attempts, aborted = self._attempt_with_retries(
                key, dev_idx, body)
            sp.annotate(device=dev_idx, attempts=attempts, aborted=aborted)
        if out is None:
            out = {"models": {}, "cost": 0.0}
        return {**out, "start": start, "done": time.perf_counter() - t0,
                "device": dev_idx, "attempts": attempts, "aborted": aborted}

    def _dispatch(self, serves: List[_Serve], t0: float):
        tr = get_tracer()
        for serve in serves:
            serve.dispatch_off = time.perf_counter() - t0
            with tr.span("service.dispatch", batch=serve.batch.bid,
                         framework=serve.framework,
                         clients=sorted(serve.clients)) as sp:
                for p in serve.requests:
                    self._journal({"ev": "svc_dispatch",
                                   "request_id": service_request_id(p.req),
                                   "batch_id": serve.batch.bid})
                sim = self.session.sim
                # resolve against completed stages (session step-wise API)
                request = UnlearnRequest(serve.clients,
                                         framework=serve.framework,
                                         rounds=serve.rounds,
                                         apply=serve.apply)
                _clients, stage_plan = self.session.resolve_request(request)
                fw_cls = FRAMEWORKS[serve.framework]
                rounds = (serve.rounds or self.session.rounds
                          or sim.fl.global_rounds)
                n_jobs = 0
                for i, stage_clients in stage_plan.items():
                    record = self.session.records[i]
                    ctx = UnlearnContext(sim, record, list(stage_clients),
                                         rounds)
                    serve.stage_ctxs[i] = ctx
                    futures = []
                    if fw_cls.shard_level:
                        for shard in ctx.impacted:
                            dev = self.placement.assign()
                            futures.append(self.placement.submit(
                                self._job_shard, serve, i, shard, dev, t0,
                                slot=dev))
                    else:
                        dev = self.placement.assign()
                        futures.append(self.placement.submit(
                            self._job_federation, serve, i, dev, t0,
                            slot=dev))
                    serve.stage_jobs[i] = futures
                    n_jobs += len(futures)
                sp.annotate(n_jobs=n_jobs)

    # --------------------------------------------------------------- gather
    def _gather(self, serves: List[_Serve], report: ServiceReport, t0: float):
        for serve in serves:
            outs = {i: [f.result() for f in futs]
                    for i, futs in serve.stage_jobs.items()}
            starts = [o["start"] for os_ in outs.values() for o in os_]
            dones = [o["done"] for os_ in outs.values() for o in os_]
            devices = sorted({o["device"] for os_ in outs.values()
                              for o in os_})
            done_off = max(dones, default=serve.dispatch_off)
            # land per-stage UnlearnResults through the session report
            total_cost = 0.0
            for i, os_ in sorted(outs.items()):
                ctx = serve.stage_ctxs[i]
                record = self.session.records[i]
                fw_cls = FRAMEWORKS[serve.framework]
                if fw_cls.shard_level:
                    models = dict(record.shard_models)
                else:
                    models = {}
                cost = 0.0
                for o in os_:
                    models.update(o["models"])
                    cost += o["cost"]
                total_cost += cost
                stage_dones = [o["done"] for o in os_]
                res = UnlearnResult(
                    serve.framework, models,
                    max(stage_dones, default=serve.dispatch_off)
                    - serve.dispatch_off,
                    cost, getattr(record.store, "stats", None), ctx.impacted)
                self.session.record_result(i, res, apply=serve.apply)
            # one ledger entry per ORIGINAL request in the merged group
            start_off = min(starts) if starts else serve.dispatch_off
            batch_wait = start_off - serve.dispatch_off
            retrain_wall = done_off - start_off
            attempts = sum(o.get("attempts", 1) for os_ in outs.values()
                           for o in os_)
            n_jobs_total = sum(len(v) for v in outs.values())
            aborted = any(o.get("aborted", False) for os_ in outs.values()
                          for o in os_)
            tr = get_tracer()
            for p in serve.requests:
                self.audit.record(
                    "retrained", request_id=service_request_id(p.req),
                    batch_id=serve.batch.bid,
                    shards=[list(x) for x in sorted(p.impacted)],
                    aborted=aborted)
            for p in serve.requests:
                queue_wait = serve.batch.time - p.req.t
                latency = queue_wait + batch_wait + retrain_wall
                entry = LedgerEntry(
                    rid=p.req.rid, arrival=p.req.t, clients=p.req.clients,
                    framework=serve.framework, batch_id=serve.batch.bid,
                    queue_wait=queue_wait, batch_wait=batch_wait,
                    retrain_wall=retrain_wall, latency=latency,
                    n_jobs=sum(len(v) for v in outs.values()),
                    devices=devices, impacted=sorted(p.impacted),
                    cost_units=total_cost / max(len(serve.requests), 1),
                    deadline=p.req.deadline,
                    sla_met=(latency <= p.req.deadline
                             if p.req.deadline is not None else None),
                    job_attempts=attempts,
                    job_retries=attempts - n_jobs_total,
                    aborted=aborted,
                    request_id=service_request_id(p.req))
                report.entries.append(entry)
                self._journal({"ev": "svc_commit",
                               "request_id": entry.request_id,
                               "entry": entry.to_dict()})
                self.audit.record("committed", request_id=entry.request_id,
                                  batch_id=serve.batch.bid,
                                  queue_wait_virtual_s=queue_wait)
                if not entry.aborted:
                    tr.metrics.counter("service.requests_served").inc()
                    for c in entry.clients:
                        tr.metrics.histogram("service.client_latency_s",
                                             client=c).observe(latency)

    # ---------------------------------------------------------------- serve
    def serve(self, trace, resume: bool = False) -> ServiceReport:
        """Serve the whole trace: plan the dispatch schedule (virtual,
        deterministic), dispatch every batch's shard programs across the
        placement without blocking, then gather completions into the
        ledger.  Returns the ``ServiceReport``.

        ``trace`` is a sequence of ``ServiceRequest`` or any time-ordered
        iterable/generator (``iter_poisson_trace`` / ``iter_trace``) — the
        streaming form never materializes the request list and serves
        bit-identically to the materialized trace for the same seed.

        With ``resume=True`` and a journal attached, requests whose
        ``svc_commit`` is already journaled are NOT re-dispatched — their
        ledger entries are replayed bit-identically from the journal — and
        dispatched-but-uncommitted requests (crash between retrain and
        ledger-commit) re-dispatch exactly once.
        """
        if not self.session.records:
            raise RuntimeError("train at least one stage before serving")
        replayed: List[LedgerEntry] = []
        if resume and self.journal is not None:
            committed: Dict[str, dict] = {}
            for ev in self.journal.events():
                if ev.get("ev") == "svc_commit":
                    committed[ev["request_id"]] = ev["entry"]
            if committed:
                if isinstance(trace, Sequence):
                    trace = [r for r in trace
                             if service_request_id(r) not in committed]
                else:                       # keep a stream a stream
                    trace = (r for r in trace
                             if service_request_id(r) not in committed)
                replayed = [LedgerEntry.from_dict(d)
                            for d in committed.values()]
        tr = get_tracer()
        batches = self.plan_schedule(trace)
        # every admitted request lands in exactly one batch, so this equals
        # len(trace) for materialized traces — and is the only way to count
        # a streamed one
        n_requests = sum(len(b.pendings) for b in batches)
        self.placement.reset_assignment()
        self.placement.reset_health()
        if self.faults is not None:
            for rec in self.session.records:
                if hasattr(rec.store, "attach_faults"):
                    rec.store.attach_faults(self.faults)
        rec_before = self._recovery_counters()
        report = ServiceReport(policy=self.policy.describe(),
                               placement=self.placement.describe(),
                               num_batches=len(batches))
        t0 = time.perf_counter()
        all_serves: List[_Serve] = []
        with tr.span("service.serve", requests=n_requests,
                     batches=len(batches), resume=resume):
            for batch in batches:
                serves = self._merge_groups(batch)
                self._dispatch(serves, t0)
                all_serves.extend(serves)
            with tr.span("service.gather"):
                self._gather(all_serves, report, t0)
        report.serve_wall = time.perf_counter() - t0
        report.placement = self.placement.describe()   # incl. job counters
        report.entries.extend(replayed)          # journal-replayed commits
        report.entries.sort(key=lambda e: e.rid)
        rec_after = self._recovery_counters()
        attempts = retries = aborts = 0
        for serve_ in all_serves:
            for futs in serve_.stage_jobs.values():
                for f in futs:                       # results already cached
                    o = f.result()
                    attempts += o.get("attempts", 1)
                    retries += o.get("attempts", 1) - 1
                    aborts += int(o.get("aborted", False))
        report.faults = {
            "attempts": attempts, "retries": retries, "aborts": aborts,
            "recoveries": rec_after["recovered_reads"]
            - rec_before["recovered_reads"],
            "recovered_slices": rec_after["slices"] - rec_before["slices"],
            "failed_reads": rec_after["failed_reads"]
            - rec_before["failed_reads"],
            "retry_policy": self.retry.describe(),
        }
        if self.faults is not None:
            report.faults["ledger"] = self.faults.ledger.kinds()
        # re-expose the serve's aggregates (incl. the per-client p99
        # breakdown) through the metrics registry; idempotent gauges
        tr.metrics.absorb_service_report(report)
        return report

    def _recovery_counters(self) -> dict:
        """Quorum-read recovery totals across the session's (unique) stores
        — diffed around a serve to report per-serve recoveries."""
        out = {"recovered_reads": 0, "slices": 0, "failed_reads": 0}
        for store in {id(r.store): r.store
                      for r in self.session.records}.values():
            stats = getattr(store, "stats", None)
            if stats is None:
                continue
            out["recovered_reads"] += getattr(stats, "recovered_reads", 0)
            out["slices"] += (getattr(stats, "erased_slices", 0)
                              + getattr(stats, "corrupted_slices", 0))
            out["failed_reads"] += getattr(stats, "failed_reads", 0)
        return out
