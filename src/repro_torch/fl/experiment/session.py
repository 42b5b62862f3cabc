"""Multi-stage federated session driver (``repro.fl.experiment.session`` on
torch): K stages back-to-back against one simulator, serving a stream of
unlearning requests scheduled between stages.  Each request goes to its
registered framework on only the impacted stages and, within each, only the
impacted shards retrain.  With ``batch_requests=True`` the requests due
after a stage merge into one request per compatible option set.

A fault plan (``faults=``) reaches every stage's training and store and
fires its crash injectors at the session's named sites (``after_stage``,
``after_requests``, ``after_snapshot``); every request's lifecycle
(received, retrained, committed) lands in a hash-chained ``AuditLog``.
With ``checkpoint_dir`` (and ``checkpoint_every``) the session journals
every stage and request event through a ``CheckpointManager``'s write-ahead
journal, on which the audit chain lives too, and commits a snapshot every
``checkpoint_every`` completed stages; ``run(..., resume_from=<dir>)``
restores the newest good snapshot and finishes the run bit-identically to
an uninterrupted one (``repro_torch.durability``).
"""
from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

from repro_torch.fl.experiment.frameworks import run_unlearn
from repro_torch.fl.experiment.stage import train_stage
from repro_torch.stores.store import StoreStats
from repro_torch.telemetry import AuditLog, get_tracer

ClientSpec = Union[Sequence[int], Callable[[object], Sequence[int]]]


@dataclass
class UnlearnRequest:
    """One unlearning request in a session.

    ``clients``: ids, or a callable ``plan -> ids`` resolved against the
    most recent stage.  ``after_stage``: serve once that stage completed.
    ``stages``: explicit target stage indices (default: every completed
    stage a requested client took part in).  ``apply``: fold the unlearned
    shard models back into the stage record (shard-level frameworks only).
    ``request_id``: stable idempotency key (``req-s<stage>-<i>`` if unset).
    """
    clients: ClientSpec
    framework: str = "SE"
    after_stage: int = 0
    stages: Optional[Sequence[int]] = None
    rounds: Optional[int] = None
    apply: bool = False
    request_id: str = ""

    def resolve_clients(self, plan) -> List[int]:
        cs = self.clients(plan) if callable(self.clients) else self.clients
        return list(dict.fromkeys(int(c) for c in cs))


@dataclass
class RequestSchedule:
    """A stream of requests keyed by the stage they arrive after."""
    requests: List[UnlearnRequest] = field(default_factory=list)

    def add(self, request: UnlearnRequest) -> "RequestSchedule":
        self.requests.append(request)
        return self

    def due(self, stage: int) -> List[UnlearnRequest]:
        return [r for r in self.requests if r.after_stage == stage]


@dataclass
class StageReport:
    stage: int                               # session-local index (records[])
    plan_stage: int                          # the ShardManager's global stage
    train_wall: float
    num_shards: int
    clients: List[int]
    store_stats: StoreStats                  # snapshot right after training
    unlearn: List[object] = field(default_factory=list)   # UnlearnResults

    def to_dict(self) -> dict:
        return {
            "stage": self.stage,
            "plan_stage": self.plan_stage,
            "train_wall_s": self.train_wall,
            "num_shards": self.num_shards,
            "clients": list(self.clients),
            "store_stats": self.store_stats.to_dict(),
            "unlearn": [u.to_dict() for u in self.unlearn],
        }


@dataclass
class SessionReport:
    stages: List[StageReport] = field(default_factory=list)
    store_kind: str = "coded"

    @property
    def total_train_wall(self) -> float:
        return sum(s.train_wall for s in self.stages)

    @property
    def total_unlearn_wall(self) -> float:
        return sum(u.wall_time for s in self.stages for u in s.unlearn)

    @property
    def total_cost_units(self) -> float:
        return sum(u.cost_units for s in self.stages for u in s.unlearn)

    @property
    def store_stats(self) -> StoreStats:
        """Whole-session storage accounting, merged across stages."""
        total = StoreStats()
        for s in self.stages:
            total += s.store_stats
        return total

    def to_dict(self) -> dict:
        d = {
            "store_kind": self.store_kind,
            "num_stages": len(self.stages),
            "total_train_wall_s": self.total_train_wall,
            "total_unlearn_wall_s": self.total_unlearn_wall,
            "total_cost_units": self.total_cost_units,
            "store_stats": self.store_stats.to_dict(),
            "stages": [s.to_dict() for s in self.stages],
        }
        tr = get_tracer()
        if tr.enabled:
            d["telemetry"] = tr.describe()
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)


class FederatedSession:
    """Drives one simulator through K training stages with interleaved
    unlearning requests.  ``init_fn(salt) -> params``, when given, replaces
    the simulator's initial-model draws (see ``FLSimulator``)."""

    def __init__(self, sim, store_kind: str = "coded", engine: str = "fused",
                 encode_group: Optional[int] = None, slice_dtype=None,
                 rounds: Optional[int] = None, batch_requests: bool = False,
                 strict_schedule: bool = False, faults=None,
                 checkpoint_every: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 store_options: Optional[dict] = None,
                 init_fn: Optional[Callable[[int], dict]] = None):
        if checkpoint_every and not checkpoint_dir:
            raise ValueError(
                f"checkpoint_every={checkpoint_every} needs a "
                f"checkpoint_dir to write snapshots to")
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0 (0 disables periodic "
                f"snapshots), got {checkpoint_every}")
        self.sim = sim
        if init_fn is not None:
            sim.init_fn = init_fn
        self.store_kind = store_kind
        self.store_options = dict(store_options or {})
        self.engine = engine
        self.encode_group = encode_group
        self.slice_dtype = slice_dtype
        self.rounds = rounds
        self.batch_requests = batch_requests
        self.strict_schedule = strict_schedule
        self.faults = faults                     # optional FaultPlan
        self.records: List[object] = []
        self.report = SessionReport(store_kind=store_kind)
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_dir = checkpoint_dir
        self.checkpointer = None
        if checkpoint_dir is not None:
            from repro_torch.durability.checkpointer import CheckpointManager
            self.checkpointer = CheckpointManager(checkpoint_dir,
                                                  faults=faults)
            if not self.checkpoint_every:
                self.checkpoint_every = 1        # dir given: snapshot per stage
        self._served: set = set()                # committed request ids
        self.last_resume_info: Optional[dict] = None
        # hash-chained audit of unlearning lifecycle events; journal-backed
        # (and crash-durable) whenever the session checkpoints
        self.audit = AuditLog(
            journal=self.checkpointer.journal
            if self.checkpointer is not None else None)

    def run_stage(self, rounds: Optional[int] = None):
        """Train the next stage and append its record + report entry."""
        tr = get_tracer()
        t0 = time.perf_counter()
        with tr.span("session.stage", stage=len(self.records),
                     engine=self.engine, store=self.store_kind):
            record = train_stage(self.sim, store_kind=self.store_kind,
                                 rounds=rounds or self.rounds,
                                 engine=self.engine,
                                 encode_group=self.encode_group,
                                 slice_dtype=self.slice_dtype,
                                 faults=self.faults,
                                 store_options=self.store_options)
        wall = time.perf_counter() - t0
        self.records.append(record)
        stats = record.store.stats.snapshot()
        tr.metrics.absorb_store_stats(stats, stage=len(self.records) - 1)
        self.report.stages.append(StageReport(
            stage=len(self.records) - 1, plan_stage=record.plan.stage,
            train_wall=wall, num_shards=record.plan.num_shards,
            clients=record.plan.clients, store_stats=stats))
        return record

    def _target_stages(self, request: UnlearnRequest,
                       clients: Sequence[int]) -> List[int]:
        if request.stages is not None:
            bad = [i for i in request.stages
                   if not 0 <= i < len(self.records)]
            if bad:
                raise ValueError(
                    f"request targets session stage(s) {bad}; only "
                    f"{len(self.records)} stage(s) have completed")
            return sorted(request.stages)
        hit = set(clients)
        return [i for i, rec in enumerate(self.records)
                if hit & set(rec.plan.clients)]

    def resolve_request(self, request: UnlearnRequest):
        """``(clients, stage_plan)``: each impacted session stage index maps
        to the subset of ``clients`` that took part in it."""
        if not self.records:
            raise RuntimeError("no completed stages to unlearn from")
        clients = request.resolve_clients(self.records[-1].plan)
        stage_plan = {}
        for i in self._target_stages(request, clients):
            members = set(self.records[i].plan.clients)
            stage_clients = [c for c in clients if c in members]
            if stage_clients:
                stage_plan[i] = stage_clients
        return clients, stage_plan

    def record_result(self, stage: int, res, apply: bool = False):
        """Land one stage's ``UnlearnResult`` in the report (and, with
        ``apply``, fold the unlearned shard models into the record)."""
        record = self.records[stage]
        if apply:
            if set(res.models) != set(record.shard_models):
                raise ValueError(
                    f"apply=True needs shard-level models; framework "
                    f"{res.framework!r} returned keys "
                    f"{sorted(res.models)} for shards "
                    f"{sorted(record.shard_models)}")
            record.shard_models = dict(res.models)
        self.report.stages[stage].unlearn.append(res)
        # decode/retrieve traffic lands after the training snapshot
        self.report.stages[stage].store_stats = record.store.stats.snapshot()
        return res

    def unlearn(self, request: UnlearnRequest):
        """Serve one request on every impacted stage (and only those)."""
        _clients, stage_plan = self.resolve_request(request)
        results = []
        for i, stage_clients in stage_plan.items():
            res = run_unlearn(self.sim, request.framework, self.records[i],
                              stage_clients,
                              rounds=request.rounds or self.rounds)
            res.request_id = request.request_id
            results.append(self.record_result(i, res, apply=request.apply))
        return results

    def unlearn_batch(self, requests: Sequence[UnlearnRequest]):
        """Serve a group of requests together: compatible requests (same
        framework, rounds, stages, apply) merge into ONE request over the
        union of their clients, so each impacted shard retrains once."""
        if not self.records:
            raise RuntimeError("no completed stages to unlearn from")
        plan = self.records[-1].plan
        groups: dict = {}
        group_ids: dict = {}
        for r in requests:
            key = (r.framework, r.rounds,
                   tuple(r.stages) if r.stages is not None else None, r.apply)
            clients = groups.setdefault(key, [])
            for c in r.resolve_clients(plan):
                if c not in clients:
                    clients.append(c)
            if r.request_id:
                group_ids.setdefault(key, []).append(r.request_id)
        results = []
        for key, clients in groups.items():
            fw, rounds, stages, apply = key
            merged = UnlearnRequest(clients, framework=fw, rounds=rounds,
                                    stages=list(stages) if stages else None,
                                    apply=apply,
                                    request_id="+".join(group_ids.get(key,
                                                                      [])))
            results.extend(self.unlearn(merged))
        return results

    # ------------------------------------------------------------ durability
    def _journal(self, event: dict) -> None:
        if self.checkpointer is not None:
            self.checkpointer.journal.append(event)

    def _crash_site(self, phase: str, stage: int) -> None:
        """Named process-crash site for the chaos harness (``process_kill``
        fires here; a plan without crash injectors is a no-op)."""
        if self.faults is not None and hasattr(self.faults, "crash_site"):
            self.faults.crash_site(("session", phase, stage))

    def _maybe_checkpoint(self, k: int, num_stages: int) -> None:
        if self.checkpointer is None or self.checkpoint_every <= 0:
            return
        if (k + 1) % self.checkpoint_every == 0 or k == num_stages - 1:
            from repro_torch.durability import session_state
            path = self.checkpointer.save(
                session_state.capture_session(self), step=k)
            self._journal({"ev": "snapshot", "step": k,
                           "path": os.path.basename(path)})
            self._crash_site("after_snapshot", k)

    def resume(self, resume_from: str) -> int:
        """Restore from the newest good snapshot under ``resume_from`` (its
        tensors onto this session's device) and replay its journal.
        Returns the first stage index still to run.

        Corrupt snapshots (torn writes) are skipped — recovery falls back
        to the previous good one.  Requests the journal shows dispatched
        but never committed re-dispatch exactly once: the restored report
        does not contain them, and re-serving from the restored RNG state
        reproduces the uninterrupted run bit-for-bit."""
        from repro_torch.durability import session_state
        from repro_torch.durability.checkpointer import CheckpointManager
        mgr = self.checkpointer
        if mgr is None or os.path.abspath(mgr.directory) != \
                os.path.abspath(resume_from):
            mgr = CheckpointManager(resume_from, faults=self.faults)
        got = mgr.load_latest(device=self.sim.device)
        if got is None:
            raise FileNotFoundError(
                f"no usable snapshot under {resume_from!r}"
                + (f" ({len(mgr.skipped)} corrupt snapshot(s) skipped: "
                   f"{mgr.skipped})" if mgr.skipped else ""))
        state, step, path = got
        start = session_state.restore_session(self, state)
        if self.checkpointer is None:
            self.checkpointer = mgr
        # splice the audit chain: replay + verify the journaled chain and
        # continue appending from its head, one verifiable history
        if getattr(self.audit, "journal", None) is not mgr.journal:
            self.audit = AuditLog(journal=mgr.journal)
        # exactly-once accounting: ids dispatched but never committed in the
        # journal are re-dispatched by the resumed run (they are absent from
        # the restored report); committed ids at/before the snapshot are in
        # ``self._served`` and are never served twice
        dispatched: list = []
        committed: set = set()
        for ev in mgr.journal.events():
            if ev.get("ev") == "req_dispatch":
                dispatched.extend(ev.get("rids", []))
            elif ev.get("ev") == "req_commit":
                committed.update(ev.get("rids", []))
        inflight = sorted(set(dispatched) - committed - self._served)
        self.last_resume_info = {
            "step": step, "path": path, "start_stage": start,
            "skipped_snapshots": list(mgr.skipped), "inflight": inflight,
        }
        self._journal({"ev": "resume", "from_step": step, "start": start,
                       "skipped": [os.path.basename(p) for p in mgr.skipped],
                       "inflight": inflight})
        return start

    # ------------------------------------------------------------------- run
    def run(self, num_stages: int,
            schedule: Optional[RequestSchedule] = None,
            resume_from: Optional[str] = None) -> SessionReport:
        """K stages back-to-back; after stage k, serve every scheduled
        request with ``after_stage == k`` (one by one, or merged when the
        session was built with ``batch_requests=True``).  Requests that can
        never come due warn (or raise with ``strict_schedule``).

        With ``checkpoint_dir``/``checkpoint_every`` set, a snapshot is
        committed every ``checkpoint_every`` completed stages (and after
        the last), and every stage completion / request dispatch / request
        commit is journaled first.  ``resume_from=<dir>`` restores the
        newest good snapshot and continues: completed stages are skipped,
        served requests (by ``request_id``) are never re-applied, and the
        resumed run's models, slices, and accounting are bit-identical to
        an uninterrupted run."""
        start = 0
        if resume_from is not None:
            start = self.resume(resume_from)
        for k in range(start, num_stages):
            self._journal({"ev": "stage_begin", "stage": k})
            self.run_stage()
            self._crash_site("after_stage", k)
            due = schedule.due(k) if schedule is not None else []
            for i, req in enumerate(due):
                if not req.request_id:
                    req.request_id = f"req-s{k}-{i}"
            due = [r for r in due if r.request_id not in self._served]
            if due:
                rids = [r.request_id for r in due]
                for rid in rids:
                    self.audit.record("received", request_id=rid,
                                      after_stage=k)
                if self.batch_requests:
                    self._journal({"ev": "req_dispatch", "rids": rids,
                                   "stage_after": k})
                    self.unlearn_batch(due)
                    self._served.update(rids)
                    for rid in rids:
                        self.audit.record("retrained", request_id=rid,
                                          after_stage=k, batched=True)
                    self._journal({"ev": "req_commit", "rids": rids,
                                   "stage_after": k})
                    for rid in rids:
                        self.audit.record("committed", request_id=rid,
                                          after_stage=k)
                else:
                    for req in due:
                        self._journal({"ev": "req_dispatch",
                                       "rids": [req.request_id],
                                       "stage_after": k})
                        self.unlearn(req)
                        self._served.add(req.request_id)
                        self.audit.record("retrained",
                                          request_id=req.request_id,
                                          after_stage=k, batched=False)
                        self._journal({"ev": "req_commit",
                                       "rids": [req.request_id],
                                       "stage_after": k})
                        self.audit.record("committed",
                                          request_id=req.request_id,
                                          after_stage=k)
            self._crash_site("after_requests", k)
            self._maybe_checkpoint(k, num_stages)
            self._journal({"ev": "stage_commit", "stage": k})
        if schedule is not None:
            missed = [r for r in schedule.requests
                      if not 0 <= r.after_stage < num_stages]
            if missed:
                msg = (f"{len(missed)} scheduled unlearning request(s) were "
                       f"never served: after_stage "
                       f"{sorted(r.after_stage for r in missed)} outside the "
                       f"run's [0, {num_stages}) stage range")
                if self.strict_schedule:
                    raise ValueError(msg)
                warnings.warn(msg, stacklevel=2)
        return self.report
