"""Deterministic, seeded fault plans — the chaos harness's control plane.

A ``FaultPlan`` is a registry-style collection of seeded injectors
(``INJECTORS`` / ``@register_injector``, mirroring ``STORES``/``POLICIES``)
threaded through the store, session, and service layers:

* ``client_dropout``    — stage-level client churn: clients vanish from the
  stage before their params are stored, making shards ragged (the training
  engines degrade to the per-shard path instead of crashing).
* ``straggler``         — per-job straggler delay in the serving path.
* ``slice_erasure``     — coded slices become unreachable at read time
  (``CodedStore`` recovers via erasure decoding from any >= S survivors).
* ``slice_corruption``  — coded slices are bit-corrupted at read time
  (recovered via Berlekamp-Welch / RANSAC error decoding).
* ``device_failure``    — a device fails: every job routed to it errors, the
  service marks it unhealthy and re-dispatches to healthy devices.
* ``device_hang``       — a job hangs on its device; the engine times the
  attempt out and retries elsewhere.
* ``job_exception``     — transient job exceptions that succeed on retry.

Every decision an injector makes is a pure function of ``(plan seed, site
key)`` — *not* of call order, thread interleaving, or the wall clock — so a
chaotic run reproduces bit-for-bit: the same plan seed against the same
workload injects the same faults at the same sites and yields the identical
``FaultLedger.signature()``.  Site keys are content-derived (round ids,
stage ids, shard ids, client tuples), which also means two concurrent reads
of the same round observe the *same* injected fault — corruption is a
property of the data, not of the reader.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from repro_torch.faults.events import (DeviceFault, FaultEvent, FaultLedger,
                                 JobHang, TransientJobError)


def _site_entropy(site: Tuple) -> List[int]:
    """Stable integer entropy for a site key (``hash()`` is salted per
    process; crc32 is not)."""
    return [zlib.crc32(repr(x).encode()) for x in site]


class FaultInjector:
    """Base injector.  Subclass, implement the hook(s) you inject at, and
    register with ``@register_injector("name")``.  Hooks return ``None``
    when the injector does not fire at that site."""

    name: str = ""

    # ----- hooks (all optional) -------------------------------------------
    def stage_dropout(self, plan: "FaultPlan", stage: int,
                      shard_clients: Dict[int, List[int]]
                      ) -> Dict[int, List[int]]:
        """Clients to drop per shard for one training stage."""
        return {}

    def slice_loss(self, plan: "FaultPlan", rnd: int, scheme) -> List[int]:
        """Coded-slice row ids unreachable for round ``rnd``."""
        return []

    def slice_noise(self, plan: "FaultPlan", rnd: int, scheme,
                    width: int, scale_ref: float) -> Dict[int, np.ndarray]:
        """row id -> additive corruption vector for round ``rnd``."""
        return {}

    def cold_noise(self, plan: "FaultPlan", rnd: int, scheme,
                   width: int, scale_ref: float) -> Dict[int, np.ndarray]:
        """row id -> additive corruption for a round served from the
        *cold* (disk-offloaded) tier of a tiered store."""
        return {}

    def job_action(self, plan: "FaultPlan", key: Tuple, attempt: int,
                   device: int) -> Optional[Tuple[float, Optional[Exception]]]:
        """(delay_s, error-or-None) for one job attempt, or ``None``."""
        return None

    def crash(self, plan: "FaultPlan", site: Tuple) -> None:
        """Process-crash hook: fired at the session's named crash sites
        (``("session", phase, stage)``); may raise ``InjectedCrash`` or
        kill the process outright."""

    def snapshot_written(self, plan: "FaultPlan", path: str,
                         step: int) -> None:
        """Durability hook: fired right after a snapshot commit — the
        torn-write injector corrupts the file here."""

    def describe(self) -> dict:
        return {"injector": self.name}


INJECTORS: Dict[str, Type[FaultInjector]] = {}


def register_injector(*names: str):
    """Class decorator registering a ``FaultInjector`` under ``names``."""
    if not names:
        raise ValueError("register_injector needs at least one name")

    def deco(cls: Type[FaultInjector]) -> Type[FaultInjector]:
        cls.name = names[0]
        for n in names:
            INJECTORS[n] = cls
        return cls
    return deco


def make_injector(name: str, **options) -> FaultInjector:
    try:
        cls = INJECTORS[name]
    except KeyError:
        raise ValueError(f"unknown fault injector {name!r}; registered: "
                         f"{sorted(INJECTORS)}") from None
    return cls(**options)


class FaultPlan:
    """A seeded set of injectors plus the ledger their firings land in.

    >>> plan = (FaultPlan(seed=7)
    ...         .add("slice_corruption", count=2, scale=10.0)
    ...         .add("job_exception", rate=1.0))
    >>> session = FederatedSession(sim, faults=plan)        # doctest: +SKIP
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.injectors: List[FaultInjector] = []
        self.ledger = FaultLedger()

    def add(self, name: str, **options) -> "FaultPlan":
        self.injectors.append(make_injector(name, **options))
        return self

    def rng(self, *site) -> np.random.Generator:
        """Deterministic per-site generator: a pure function of
        ``(plan seed, site)`` — independent of call order and threads."""
        return np.random.default_rng([self.seed] + _site_entropy(site))

    # ------------------------------------------------------------- hooks
    def dropped_clients(self, stage: int,
                        shard_clients: Dict[int, List[int]]
                        ) -> Dict[int, List[int]]:
        """Union of every injector's stage-level dropout for ``stage``."""
        out: Dict[int, List[int]] = {}
        for inj in self.injectors:
            for s, cs in inj.stage_dropout(self, stage, shard_clients).items():
                keep = out.setdefault(s, [])
                keep.extend(c for c in cs if c not in keep)
        for s in out:
            out[s] = sorted(out[s])
        if any(out.values()):
            self.ledger.record(FaultEvent(
                "client_dropout", site=("stage", stage),
                detail=tuple(sorted((s, tuple(cs)) for s, cs in out.items()
                                    if cs))))
        return out

    def slice_faults(self, rnd: int, scheme, width: int,
                     scale_ref: float = 1.0
                     ) -> Tuple[List[int], Dict[int, np.ndarray]]:
        """(lost row ids, {row id: corruption vector}) for one stored round.
        Keyed on the round — every reader of the round sees the same fault."""
        lost: set = set()
        noise: Dict[int, np.ndarray] = {}
        for inj in self.injectors:
            got = inj.slice_loss(self, rnd, scheme)
            if got:
                lost.update(int(i) for i in got)
                self.ledger.record(FaultEvent(
                    inj.name, site=("round", rnd),
                    detail=tuple(sorted(int(i) for i in got))))
            nz = inj.slice_noise(self, rnd, scheme, width, scale_ref)
            if nz:
                noise.update(nz)
                self.ledger.record(FaultEvent(
                    inj.name, site=("round", rnd),
                    detail=tuple(sorted(int(i) for i in nz))))
        return sorted(lost), noise

    def cold_faults(self, rnd: int, scheme, width: int,
                    scale_ref: float = 1.0) -> Dict[int, np.ndarray]:
        """{row id: corruption vector} for one round *served from the cold
        tier* of a tiered store.  Keyed on the round like ``slice_faults`` —
        every cold read of the round observes the same corruption (it models
        media rot on the offloaded file, not a flaky reader)."""
        noise: Dict[int, np.ndarray] = {}
        for inj in self.injectors:
            nz = inj.cold_noise(self, rnd, scheme, width, scale_ref)
            if nz:
                noise.update(nz)
                self.ledger.record(FaultEvent(
                    inj.name, site=("cold", rnd),
                    detail=tuple(sorted(int(i) for i in nz))))
        return noise

    def job_action(self, key: Tuple, attempt: int,
                   device: int) -> Tuple[float, Optional[Exception]]:
        """Aggregate every injector's verdict on one job attempt: total
        straggler delay plus the first error (if any)."""
        delay, err = 0.0, None
        for inj in self.injectors:
            act = inj.job_action(self, key, attempt, device)
            if act is None:
                continue
            d, e = act
            delay += d
            if e is not None and err is None:
                err = e
            # the device index stays OUT of the event: re-dispatch targets
            # are a recovery detail, not part of the injected-fault identity
            self.ledger.record(FaultEvent(
                inj.name, site=("job",) + tuple(key) + (attempt,),
                detail=(round(d, 9), type(e).__name__ if e else "")))
        return delay, err

    def crash_site(self, site: Tuple) -> None:
        """Fire every injector's process-crash hook at one named site (the
        session calls this after stage training, after request serving, and
        after a snapshot commit)."""
        for inj in self.injectors:
            inj.crash(self, site)

    def post_snapshot(self, path: str, step: int) -> None:
        """Fire every injector's snapshot-written hook (torn-write site)."""
        for inj in self.injectors:
            inj.snapshot_written(self, path, step)

    def describe(self) -> dict:
        return {"seed": self.seed,
                "injectors": [inj.describe() for inj in self.injectors]}

    def to_dict(self) -> dict:
        return {**self.describe(), "ledger": self.ledger.to_dict()}


# ---------------------------------------------------------------------------
# Built-in injectors
# ---------------------------------------------------------------------------

def _quorum_rows(scheme) -> set:
    """The canonical well-spread decode subset — the S rows a fault-free
    quorum read actually consumes (see ``CodingScheme.quorum``)."""
    return set(int(i) for i in scheme.quorum())


@register_injector("client_dropout")
class ClientDropout(FaultInjector):
    """Stage-level client churn: each stage client independently drops out
    with probability ``rate`` (seeded per (stage, client)); ``min_keep``
    clients always survive per shard so training stays well-posed."""

    def __init__(self, rate: float = 0.0, min_keep: int = 1,
                 stages: Optional[Tuple[int, ...]] = None):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("dropout rate must be in [0, 1]")
        self.rate = float(rate)
        self.min_keep = max(int(min_keep), 1)
        self.stages = tuple(stages) if stages is not None else None

    def stage_dropout(self, plan, stage, shard_clients):
        if self.stages is not None and stage not in self.stages:
            return {}
        out = {}
        for s, cs in sorted(shard_clients.items()):
            rng = plan.rng(self.name, stage, s)
            drop = [c for c in cs if rng.random() < self.rate]
            # keep the shard trainable: spare the lowest-id clients
            excess = len(cs) - len(drop)
            if excess < self.min_keep:
                spare = len(drop) - (len(cs) - self.min_keep)
                drop = drop[spare:]
            if drop:
                out[s] = drop
        return out

    def describe(self):
        return {"injector": self.name, "rate": self.rate,
                "min_keep": self.min_keep, "stages": self.stages}


@register_injector("straggler")
class StragglerDelay(FaultInjector):
    """Per-job straggler: with probability ``rate`` (seeded per job) the
    first attempt is delayed by ``delay_s`` before the work runs — the job
    still completes; only its measured wall (and SLA verdict) suffers."""

    def __init__(self, rate: float = 0.0, delay_s: float = 0.05):
        self.rate = float(rate)
        self.delay_s = float(delay_s)

    def job_action(self, plan, key, attempt, device):
        if attempt != 1:
            return None
        if plan.rng(self.name, *key).random() < self.rate:
            return (self.delay_s, None)
        return None

    def describe(self):
        return {"injector": self.name, "rate": self.rate,
                "delay_s": self.delay_s}


@register_injector("slice_erasure")
class SliceErasure(FaultInjector):
    """``count`` coded slices of each targeted round become unreachable
    (seeded per round).  ``spare_quorum=True`` (default) only erases slices
    outside the canonical decode subset — the regime where quorum-read
    recovery is *bit-identical* to the fault-free decode; set it ``False``
    to also hit the read set (recovery then re-interpolates from a different
    well-spread subset: correct, but only float-close).  ``rounds``
    restricts targeting."""

    def __init__(self, count: int = 1, spare_quorum: bool = True,
                 rounds: Optional[Tuple[int, ...]] = None):
        self.count = int(count)
        self.spare_quorum = bool(spare_quorum)
        self.rounds = tuple(rounds) if rounds is not None else None

    def _eligible(self, scheme) -> List[int]:
        rows = set(range(scheme.num_clients))
        if self.spare_quorum:
            rows -= _quorum_rows(scheme)
        return sorted(rows)

    def slice_loss(self, plan, rnd, scheme):
        if self.count <= 0 or (self.rounds is not None
                               and rnd not in self.rounds):
            return []
        rows = self._eligible(scheme)
        rng = plan.rng(self.name, rnd)
        k = min(self.count, len(rows))
        return sorted(int(i) for i in
                      rng.choice(rows, size=k, replace=False))

    def describe(self):
        return {"injector": self.name, "count": self.count,
                "spare_quorum": self.spare_quorum, "rounds": self.rounds}


@register_injector("slice_corruption")
class SliceCorruption(SliceErasure):
    """``count`` coded slices of each targeted round are bit-corrupted with
    additive noise at ``scale`` x the slice magnitude (seeded per round).
    Same ``spare_quorum`` semantics as ``slice_erasure``; the recovery path
    must now *localize* the corruption (Berlekamp-Welch / RANSAC) before
    excluding it."""

    def __init__(self, count: int = 1, scale: float = 10.0,
                 spare_quorum: bool = True,
                 rounds: Optional[Tuple[int, ...]] = None):
        super().__init__(count=count, spare_quorum=spare_quorum,
                         rounds=rounds)
        self.scale = float(scale)

    def slice_loss(self, plan, rnd, scheme):
        return []

    def slice_noise(self, plan, rnd, scheme, width, scale_ref):
        if self.count <= 0 or (self.rounds is not None
                               and rnd not in self.rounds):
            return {}
        rows = self._eligible(scheme)
        rng = plan.rng(self.name, rnd)
        k = min(self.count, len(rows))
        picked = sorted(int(i) for i in
                        rng.choice(rows, size=k, replace=False))
        amp = self.scale * (abs(scale_ref) + 1e-8)
        return {i: rng.standard_normal(width) * amp for i in picked}

    def describe(self):
        return {**super().describe(), "scale": self.scale}


@register_injector("cold_corrupt")
class ColdCorruption(SliceCorruption):
    """Corruption on *offloaded* slices: ``count`` rows of a round gain
    additive noise only when the round is served from the cold
    (disk-offloaded) tier of a tiered store — bit-rot on the cold medium.
    Hot/warm serves of the same round are clean, so the injector exercises
    the ``locate_errors``/RANSAC localization path precisely on the mmap'd
    read-back.  Same ``count``/``scale``/``spare_quorum``/``rounds`` knobs
    as ``slice_corruption``; seeded per ``("cold", round)`` site."""

    def slice_noise(self, plan, rnd, scheme, width, scale_ref):
        return {}

    def cold_noise(self, plan, rnd, scheme, width, scale_ref):
        if self.count <= 0 or (self.rounds is not None
                               and rnd not in self.rounds):
            return {}
        rows = self._eligible(scheme)
        rng = plan.rng(self.name, rnd)
        k = min(self.count, len(rows))
        picked = sorted(int(i) for i in
                        rng.choice(rows, size=k, replace=False))
        amp = self.scale * (abs(scale_ref) + 1e-8)
        return {i: rng.standard_normal(width) * amp for i in picked}


@register_injector("device_failure")
class DeviceFailure(FaultInjector):
    """Device ``device`` is dead: every job routed to it raises
    ``DeviceFault``.  The service marks it unhealthy after the first
    failure and re-dispatches — with >= 2 devices the serve completes with
    bit-identical models (the retried program is the same program)."""

    def __init__(self, device: int = 0):
        self.device = int(device)

    def job_action(self, plan, key, attempt, device):
        if device == self.device:
            return (0.0, DeviceFault(device))
        return None

    def describe(self):
        return {"injector": self.name, "device": self.device}


@register_injector("device_hang")
class DeviceHangInjector(FaultInjector):
    """A job hangs for ``hang_s`` (then errors as a timeout): targets a
    specific ``device``, or fires with probability ``rate`` per job."""

    def __init__(self, device: Optional[int] = None, rate: float = 0.0,
                 hang_s: float = 0.05):
        self.device = device if device is None else int(device)
        self.rate = float(rate)
        self.hang_s = float(hang_s)

    def job_action(self, plan, key, attempt, device):
        if self.device is not None:
            if device == self.device:
                return (0.0, JobHang(device, self.hang_s))
            return None
        if plan.rng(self.name, *key).random() < self.rate:
            return (0.0, JobHang(device, self.hang_s))
        return None

    def describe(self):
        return {"injector": self.name, "device": self.device,
                "rate": self.rate, "hang_s": self.hang_s}


@register_injector("job_exception")
class TransientJobException(FaultInjector):
    """Transient job failures: with probability ``rate`` (seeded per job —
    the *job* is flaky, not the attempt) the first ``fail_attempts``
    attempts raise ``TransientJobError``; later attempts succeed.  With
    ``fail_attempts`` <= the service's retry budget every request still
    completes; beyond it, the job aborts cleanly."""

    def __init__(self, rate: float = 0.0, fail_attempts: int = 1):
        self.rate = float(rate)
        self.fail_attempts = int(fail_attempts)

    def job_action(self, plan, key, attempt, device):
        if attempt > self.fail_attempts:
            return None
        if plan.rng(self.name, *key).random() < self.rate:
            return (0.0, TransientJobError(key))
        return None

    def describe(self):
        return {"injector": self.name, "rate": self.rate,
                "fail_attempts": self.fail_attempts}


@register_injector("process_kill")
class ProcessKill(FaultInjector):
    """Kill the process at one named session crash site — the crash half of
    the durability acceptance test.

    Sites are ``("session", phase, stage)`` with ``phase`` one of
    ``after_stage`` (training done, nothing served or snapshotted),
    ``after_requests`` (requests served, snapshot not yet written), and
    ``after_snapshot`` (snapshot committed, stage not yet journal-marked).

    ``mode="exit"`` is the real thing — ``os._exit(exit_code)``, no atexit,
    no flushes, for the subprocess kill test.  ``mode="raise"`` throws the
    typed ``InjectedCrash`` instead, so in-process tests can simulate the
    crash and then resume from the snapshots the dead session left behind.
    Fires at most once per plan (a resumed run must pass a fresh plan or
    none at all — a durable restart does not replay the crash)."""

    def __init__(self, stage: int = 0, phase: str = "after_stage",
                 mode: str = "raise", exit_code: int = 137):
        phases = ("after_stage", "after_requests", "after_snapshot")
        if phase not in phases:
            raise ValueError(f"phase must be one of {phases}, got {phase!r}")
        if mode not in ("exit", "raise"):
            raise ValueError(f"mode must be 'exit' or 'raise', got {mode!r}")
        self.stage = int(stage)
        self.phase = phase
        self.mode = mode
        self.exit_code = int(exit_code)
        self.fired = False

    def crash(self, plan, site):
        if self.fired or len(site) != 3:
            return
        kind, phase, stage = site
        if kind != "session" or phase != self.phase or stage != self.stage:
            return
        self.fired = True
        plan.ledger.record(FaultEvent("process_kill", site=tuple(site),
                                      detail=(self.mode,)))
        if self.mode == "raise":
            from repro_torch.faults.events import InjectedCrash
            raise InjectedCrash(site)
        import os
        os._exit(self.exit_code)

    def describe(self):
        return {"injector": self.name, "stage": self.stage,
                "phase": self.phase, "mode": self.mode,
                "exit_code": self.exit_code}


@register_injector("torn_write")
class TornWrite(FaultInjector):
    """Corrupt a just-committed snapshot — a torn write the checksum layer
    must catch.  ``flip=False`` (default) truncates the file to ``frac`` of
    its bytes (power loss mid-write-back); ``flip=True`` XOR-flips a byte
    run in place (media corruption).  Targets the snapshot at ``step``;
    recovery must fall back to the previous good snapshot."""

    def __init__(self, step: int = 0, frac: float = 0.5, flip: bool = False):
        if not 0.0 <= frac < 1.0:
            raise ValueError("frac must be in [0, 1)")
        self.step = int(step)
        self.frac = float(frac)
        self.flip = bool(flip)

    def snapshot_written(self, plan, path, step):
        if step != self.step:
            return
        import os
        size = os.path.getsize(path)
        if self.flip:
            with open(path, "r+b") as f:
                f.seek(size // 2)
                chunk = f.read(min(16, size - size // 2))
                f.seek(size // 2)
                f.write(bytes(b ^ 0xFF for b in chunk))
            detail = ("flip", size)
        else:
            with open(path, "r+b") as f:
                f.truncate(int(size * self.frac))
            detail = ("truncate", size, int(size * self.frac))
        plan.ledger.record(FaultEvent("torn_write",
                                      site=("snapshot", step), detail=detail))

    def describe(self):
        return {"injector": self.name, "step": self.step,
                "frac": self.frac, "flip": self.flip}


def chaos_plan(seed: int = 0, *, corrupt: int = 0, erase: int = 0,
               job_rate: float = 0.0, dead_device: Optional[int] = None,
               dropout: float = 0.0,
               spec: Optional[Callable[["FaultPlan"], None]] = None
               ) -> FaultPlan:
    """Constructor for the common chaos mixtures (benchmarks, CI)."""
    plan = FaultPlan(seed=seed)
    if corrupt:
        plan.add("slice_corruption", count=corrupt)
    if erase:
        plan.add("slice_erasure", count=erase)
    if job_rate:
        plan.add("job_exception", rate=job_rate)
    if dead_device is not None:
        plan.add("device_failure", device=dead_device)
    if dropout:
        plan.add("client_dropout", rate=dropout)
    if spec is not None:
        spec(plan)
    return plan
