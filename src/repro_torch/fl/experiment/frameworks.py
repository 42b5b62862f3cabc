"""Unlearning-framework registry (``repro.fl.experiment.frameworks`` on
torch).

Each framework is a class registered under one or more names; ``run``
receives an ``UnlearnContext`` — the stage record plus the simulator's
stacked steps, stored-norm lookups and store reads — and returns
``(models, cost_units)``.  ``run_unlearn`` dispatches by name, waits for the
device, and packages a timed ``UnlearnResult``.

The port carries the paper's four frameworks, SE / SE-uncoded, FE, FR and
RR, and the retrain oracle of ``repro_torch.verify`` registers itself here
as ``"oracle"`` / ``"retrain-oracle"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from repro_torch.core import unlearning
from repro_torch.core.tree import tree_map
from repro_torch.telemetry import get_tracer


@dataclass
class UnlearnContext:
    """Everything a framework needs to serve one unlearning request against
    one stage record."""
    sim: object                       # FLSimulator
    record: object                    # StageRecord
    requests: List[int]               # client ids to erase
    rounds: int                       # unlearning rounds G'
    available: Optional[Sequence[int]] = None   # reachable coded slices
    corrupt: Optional[np.ndarray] = None        # modelled slice corruption

    @property
    def plan(self):
        return self.record.plan

    @property
    def fl(self):
        return self.sim.fl

    @property
    def mgr(self):
        return self.sim.mgr

    @property
    def retrain_epochs(self) -> int:
        """L/r — the reduced local-epoch budget of calibrated retraining."""
        return max(int(self.fl.local_epochs / self.fl.retrain_ratio), 1)

    @property
    def impacted(self) -> List[int]:
        """S' — shards containing at least one requested client."""
        return sorted(self.mgr.impacted_shards(self.plan, self.requests))

    def retained(self, shard: int) -> List[int]:
        return self.mgr.retained(self.plan, shard, self.requests)

    def retained_all(self) -> List[int]:
        gone = set(self.requests)
        return [c for c in self.plan.clients if c not in gone]

    def stack_client_data(self, clients: Sequence[int]):
        return self.sim._stack_client_data(clients)

    def stored_round(self, shard: int, rnd: int) -> Dict[int, object]:
        """Reconstruct one shard's stored round from the parameter store."""
        return self.record.store.get_shard(rnd, shard,
                                           available=self.available,
                                           corrupt=self.corrupt)

    def all_stored_round(self, rnd: int) -> Dict[int, object]:
        out = {}
        for s in self.plan.shard_clients:
            out.update(self.stored_round(s, rnd))
        return out

    def stored_norms(self, shard_of: Callable[[int], int],
                     retained: Sequence[int], n_rounds: int) -> torch.Tensor:
        """(G', M) historical update norms, moved to the device once."""
        hn = self.record.history_norms
        return torch.tensor([[hn[(shard_of(c), g, c)] for c in retained]
                             for g in range(n_rounds)],
                            dtype=torch.float32, device=self.sim.device)

    def calib_round(self, w, xs, ys, round_norms):
        """One calibrated-retraining round (eq. 3) at L/r epochs."""
        return self.sim.calib_round(w, xs, ys, round_norms,
                                    self.retrain_epochs)

    def calib_stage(self, ws, xs, ys, nmats):
        """The calibrated-retraining pass of K shards together."""
        return self.sim.calib_stage(ws, xs, ys, nmats, self.retrain_epochs)

    def local_train(self, w, xs, ys, epochs: int, fisher=None):
        """Stacked local training of the M clients from one model (with
        ``fisher``, Fisher-preconditioned steps) -> (M, ...) client
        params."""
        from repro_torch.fl.simulator import _broadcast, _lift
        p0 = _broadcast(_lift(w), (xs.shape[0],))
        return self.sim.local_train(p0, xs, ys, epochs, fisher)

    def stacked_mean(self, stacked):
        return unlearning.stacked_mean(stacked)

    def init_model(self, salt: int = 777):
        return self.sim.init_model(salt)

    def stage_init_model(self):
        """The stage's actual initial model w0: the simulator's draw at salt
        ``plan.stage``, through the same ``init_fn`` hook the stage trained
        from — retraining from it with a client removed is the exact
        counterfactual the retrain oracle (``repro_torch.verify.oracle``)
        measures against."""
        return self.sim.init_model(self.plan.stage)

    def retrain_shards(self, w0, xs, ys, g_rounds: int):
        """From-scratch FedAvg of a stacked (K, M, n, ...) batch of shards
        at the full L local epochs; returns the (K, ...) final models."""
        return self.sim.retrain_shards(w0, xs, ys, g_rounds)

    def estimate_fisher(self, w, clients: Sequence[int]):
        return self.sim._estimate_fisher(w, clients)


class UnlearnFramework:
    """Base class for unlearning strategies.  Subclass, implement ``run``,
    and register with ``@register_framework(name, *aliases)``."""

    name: str = ""
    shard_level: bool = False

    def run(self, ctx: UnlearnContext):
        """Return ``(models, cost_units)``: shard id -> unlearned model
        ({0: w} for federation-level frameworks), and client-epochs."""
        raise NotImplementedError

    @classmethod
    def impacted_shards(cls, plan, clients: Sequence[int]) -> List[int]:
        return sorted(plan.shard_clients)


FRAMEWORKS: Dict[str, Type[UnlearnFramework]] = {}


def register_framework(*names: str):
    """Class decorator registering an ``UnlearnFramework`` under ``names``."""
    if not names:
        raise ValueError("register_framework needs at least one name")

    def deco(cls: Type[UnlearnFramework]) -> Type[UnlearnFramework]:
        cls.name = names[0]
        for n in names:
            FRAMEWORKS[n] = cls
        return cls
    return deco


def get_framework(name: str) -> UnlearnFramework:
    try:
        return FRAMEWORKS[name]()
    except KeyError:
        raise ValueError(f"unknown unlearning framework {name!r}; "
                         f"registered: {sorted(FRAMEWORKS)}") from None


def run_unlearn(sim, framework: str, record, requests: Sequence[int],
                rounds: Optional[int] = None,
                available: Optional[Sequence[int]] = None,
                corrupt: Optional[np.ndarray] = None):
    """Dispatch one unlearning request to the registered framework and
    package the timed ``UnlearnResult`` (the wall time includes waiting for
    the device to finish)."""
    from repro_torch.fl.simulator import UnlearnResult

    fw = get_framework(framework)
    ctx = UnlearnContext(sim, record, list(requests),
                         rounds or sim.fl.global_rounds, available, corrupt)
    t0 = time.perf_counter()
    impacted = ctx.impacted
    with get_tracer().span("unlearn.dispatch", framework=fw.name,
                           clients=sorted(requests),
                           impacted=impacted) as sp:
        models, cost = fw.run(ctx)
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)
        sp.annotate(cost_units=float(cost))
    wall = time.perf_counter() - t0
    stats = getattr(record.store, "stats", None)
    return UnlearnResult(framework, models, wall, cost, stats, impacted)


# ---------------------------------------------------------------------------
# The paper's frameworks
# ---------------------------------------------------------------------------

@register_framework("SE", "SE-uncoded")
class ShardedEraser(UnlearnFramework):
    """SE (paper Sec 4): only impacted shards retrain — preparation from the
    stored round-0 locals (eq. 2), then calibrated retraining at L/r epochs
    (eq. 3).  "SE-uncoded" is the same algorithm on an uncoded store.
    Several impacted shards of one geometry retrain together through
    ``calib_stage``; otherwise shard by shard (identical math)."""

    shard_level = True

    def run(self, ctx: UnlearnContext):
        models = dict(ctx.record.shard_models)
        jobs = self.prepare_jobs(ctx)
        if len(jobs) > 1 and self._batchable(jobs):
            out, cost = self._run_batched(ctx, jobs)
        else:
            out, cost = self._run_sequential(ctx, jobs)
        models.update(out)
        return models, cost

    @classmethod
    def impacted_shards(cls, plan, clients: Sequence[int]) -> List[int]:
        hit = set(clients)
        return sorted(s for s, cs in plan.shard_clients.items()
                      if hit & set(cs))

    @staticmethod
    def prepare_shard_job(ctx: UnlearnContext, shard: int):
        """One impacted shard's job: stacked retained data, the eq.-(2)
        prepared initial model from the store's round-0 locals, and the
        (G', M') stored-norm matrix.  ``None`` when every client of the
        shard was requested."""
        retained = ctx.retained(shard)
        if not retained:
            return None
        xs, ys = ctx.stack_client_data(retained)
        stored0 = ctx.stored_round(shard, 0)
        w0 = unlearning.prepare_initial_model([stored0[c] for c in retained])
        n_r = min(ctx.rounds, len(ctx.record.round_globals[shard]) - 1)
        nmat = ctx.stored_norms(lambda c, s=shard: s, retained, n_r)
        return (shard, retained, xs, ys, w0, nmat, n_r)

    def prepare_jobs(self, ctx: UnlearnContext):
        jobs = (self.prepare_shard_job(ctx, s) for s in ctx.impacted)
        return [j for j in jobs if j is not None]

    @staticmethod
    def _batchable(jobs) -> bool:
        return len({(tuple(j[2].shape), j[6]) for j in jobs}) == 1

    def _run_sequential(self, ctx: UnlearnContext, jobs):
        models, cost = {}, 0.0
        for job in jobs:
            s, w, c = run_prepared_job(ctx, job)
            models[s] = w
            cost += c
        return models, cost

    def _run_batched(self, ctx: UnlearnContext, jobs):
        """All impacted shards retrain together through ``calib_stage``."""
        ws = tree_map(lambda *vs: torch.stack(vs), *[j[4] for j in jobs])
        xs = torch.stack([j[2] for j in jobs])
        ys = torch.stack([j[3] for j in jobs])
        nmats = torch.stack([j[5] for j in jobs], dim=1)      # (G', K, M')
        out = ctx.calib_stage(ws, xs, ys, nmats)
        models, cost = {}, 0.0
        for i, (s, retained, *_rest, n_r) in enumerate(jobs):
            models[s] = tree_map(lambda v, i=i: v[i], out)
            cost += n_r * len(retained) * ctx.retrain_epochs
        return models, cost


def run_prepared_job(ctx: UnlearnContext, job, device=None):
    """Retrain ONE prepared shard job (eq. 3, G' calibrated rounds) and
    return ``(shard, model, cost_units)``.

    With ``device`` set, the job's tensors move there first — the unit of
    work the service's ``DevicePlacement`` runs on a slot (whose stream
    the caller has made current).  ``device=None`` is the sequential path,
    unchanged."""
    s, retained, xs, ys, w, nmat, n_r = job
    with get_tracer().span("unlearn.shard", shard=s, rounds=n_r,
                           retained=len(retained)):
        if device is not None:
            xs, ys, nmat = xs.to(device), ys.to(device), nmat.to(device)
            w = tree_map(lambda v: v.to(device), w)
        cost = 0.0
        for g in range(n_r):
            w = ctx.calib_round(w, xs, ys, nmat[g])
            cost += len(retained) * ctx.retrain_epochs
    return s, w, cost


@register_framework("FE")
class FedEraser(UnlearnFramework):
    """FedEraser without sharding: calibrated retraining over ALL retained
    clients from the full central store."""

    def run(self, ctx: UnlearnContext):
        retained = ctx.retained_all()
        xs, ys = ctx.stack_client_data(retained)
        stored0 = ctx.all_stored_round(0)
        w = unlearning.prepare_initial_model([stored0[c] for c in retained])
        nmat = ctx.stored_norms(ctx.plan.shard_of, retained, ctx.rounds)
        cost = 0.0
        for g in range(ctx.rounds):
            w = ctx.calib_round(w, xs, ys, nmat[g])
            cost += len(retained) * ctx.retrain_epochs
        return {0: w}, cost


class _FullRetrain(UnlearnFramework):
    """Federation-wide retraining from scratch (no stored parameters
    used)."""

    use_fisher = False

    def run(self, ctx: UnlearnContext):
        retained = ctx.retained_all()
        xs, ys = ctx.stack_client_data(retained)
        w = ctx.init_model(777)
        ep = ctx.retrain_epochs if self.use_fisher else ctx.fl.local_epochs
        # RR: estimate the diagonal Fisher on retained data once
        fisher = ctx.estimate_fisher(w, retained) if self.use_fisher else None
        cost = 0.0
        for g in range(ctx.rounds):
            locals_ = ctx.local_train(w, xs, ys, ep, fisher)
            w = ctx.stacked_mean(locals_)
            cost += len(retained) * ep
        return {0: w}, cost


@register_framework("FR")
class FedRetrain(_FullRetrain):
    """The gold standard: full retraining at the original L epochs."""


@register_framework("RR")
class RapidRetrain(_FullRetrain):
    """Rapid retraining: reduced L/r epochs with diagonal-Fisher
    preconditioned local steps."""
    use_fisher = True
