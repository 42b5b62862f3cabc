"""Stage training — one isolated-sharding FedAvg stage against a registered
parameter store (``repro.fl.experiment.stage`` on torch).

``train_stage(sim, ...)`` runs G FedAvg rounds for every shard of a freshly
sampled stage and writes each round through ``ParameterStore.put_round``.
The store's ``wants`` attribute picks the payload the round step computes
("flat" for the coded store, "stacked" for the uncoded ones).

Three engines:

* ``engine="stage"`` — all S shards advance together as one stack of S*M
  clients, and the coded store's encode runs on the whole (G, S, M*P)
  history in one ``coded_matmul_rounds`` launch.  Ragged stages (unequal
  client or sample counts per shard) degrade to the fused path.
* ``engine="fused"`` (default) — one stacked ``shard_round`` per (shard,
  round) over the shard's M clients, plus one deferred batched encode
  (``coded_matmul``) in the store's ``flush``.
* ``engine="legacy"`` — the reference's seed per-client path, kept for A/B
  benchmarking: each shard's clients train as one stack, but every client
  is unstacked, its update norm pulled to the host one scalar at a time,
  and each round stored as per-client trees (``RoundPayload.from_clients``:
  the coded store flattens and encodes every round on its own).

``faults`` (a ``repro_torch.faults.FaultPlan``) drops the plan's clients
from the freshly sampled stage before training and attaches the plan to the
stage's store; a stage the dropout made ragged degrades from the stage
engine to the fused one, recorded as a ``DegradedModeEvent`` in the plan's
ledger.  Spans: ``stage.train`` and, on the stage engine,
``device.stage_program`` (the reference's ``xla.stage_program``; under
``annotate_costs`` it carries ``telemetry.stage_cost``'s training counts
and, where it encodes, ``encode_cost``'s).

``FLSimulator.train_stage`` is a deprecated shim over ``train_stage``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import coding
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.faults.events import DegradedModeEvent
from repro_torch.stores.store import RoundPayload
from repro_torch.telemetry import encode_cost, get_tracer, stage_cost

ENGINES = ("stage", "fused", "legacy")


def train_stage(sim, store_kind: str = "coded", rounds: Optional[int] = None,
                engine: str = "fused", encode_group: Optional[int] = None,
                slice_dtype=None, faults=None, store_options=None,
                init_fn: Optional[Callable[[int], dict]] = None):
    """One stage: sample clients, split them into shards, G FedAvg rounds
    per shard, storing intermediate params in the requested store.

    ``encode_group`` batches that many rounds per coded encode on the fused
    engine (default: all G in one).  ``slice_dtype`` optionally stores coded
    slices in bf16.  ``faults`` applies a fault plan's client dropout and
    attaches its slice injectors to the store (see the module docstring).
    ``init_fn(stage) -> params`` overrides the simulator's initial model for
    this stage.  Returns a ``StageRecord``.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if engine == "legacy":
        if encode_group is not None or slice_dtype is not None:
            raise ValueError("encode_group/slice_dtype need engine="
                             "'fused' or 'stage'")
        if faults is not None:
            raise ValueError("fault plans need engine='fused' or 'stage'")
    if engine == "stage" and encode_group is not None:
        raise ValueError("encode_group is a fused-engine option; the stage "
                         "engine always encodes all rounds at once")
    fl = sim.fl
    g_rounds = rounds or fl.global_rounds
    with get_tracer().span("stage.train", engine=engine,
                           store=store_kind) as sp:
        plan = sim.mgr.new_stage()
        if init_fn is not None:
            w0 = tree_map(lambda v: v.to(sim.device, torch.float32),
                          init_fn(plan.stage))
        else:
            w0 = sim.init_model(plan.stage)
        if engine == "legacy":
            rec = _train_stage_legacy(sim, plan, w0, store_kind, g_rounds)
            sp.annotate(stage=rec.plan.stage)
            return rec
        dropped = []
        if faults is not None:
            by_shard = faults.dropped_clients(plan.stage, plan.shard_clients)
            for s, cs in by_shard.items():
                gone = set(cs)
                plan.shard_clients[s] = [c for c in plan.shard_clients[s]
                                         if c not in gone]
                dropped.extend(cs)
            dropped.sort()
        sp.annotate(stage=plan.stage, shards=len(plan.shard_clients),
                    rounds=g_rounds, dropped=len(dropped))
        store = sim._make_store(store_kind, plan,
                                group_rounds=encode_group or g_rounds,
                                slice_dtype=slice_dtype,
                                **(store_options or {}))
        if faults is not None and hasattr(store, "attach_faults"):
            store.attach_faults(faults)
        kind = ("flat" if getattr(store, "wants", "stacked") == "flat"
                else "stacked")
        data = {s: sim._stack_client_data(cs)
                for s, cs in plan.shard_clients.items()}
        if engine == "stage":
            if _stackable(plan, data):
                return _run_stage_program(sim, plan, store, w0, data,
                                          g_rounds, kind, slice_dtype)
            sp.annotate(degraded="ragged_stage")
            if faults is not None:
                faults.ledger.record(DegradedModeEvent(
                    stage=plan.stage, reason="ragged_stage",
                    fallback="fused", dropped_clients=tuple(dropped)))
            else:
                warnings.warn(
                    "ragged stage (unequal client or sample counts per "
                    "shard); stage engine degrading to per-shard fused "
                    "dispatch", stacklevel=2)
        return _run_fused(sim, plan, store, w0, data, g_rounds, kind)


def _stackable(plan, data) -> bool:
    """The stage engine needs one (S, M, n, ...) stack: every shard must hold
    the same number of clients with the same per-client sample count."""
    return len({tuple(data[s][0].shape) for s in plan.shard_clients}) == 1


def _flat_row_len(w0) -> int:
    """Per-client flat parameter length P."""
    return sum(int(np.prod(v.shape)) for v in tree_leaves(w0))


def _norms_dict(plan, shards, arr, g_rounds):
    """{(shard, round, client): norm} from a host (G, S, M) array."""
    out = {}
    for i, s in enumerate(shards):
        for g in range(g_rounds):
            for j, c in enumerate(plan.shard_clients[s]):
                out[(s, g, c)] = float(arr[g, i, j])
    return out


def _run_stage_program(sim, plan, store, w0, data, g_rounds, kind,
                       slice_dtype):
    from repro_torch.fl.simulator import StackedRoundGlobals, StageRecord

    fl = sim.fl
    shards = sorted(plan.shard_clients)
    xs = torch.stack([data[s][0] for s in shards])      # (S, M, n, ...)
    ys = torch.stack([data[s][1] for s in shards])
    # encode in the program only when the store takes pre-encoded slices
    encode = kind == "flat" and hasattr(store, "put_stage_encoded")
    prog = sim._get_stage_program(fl.local_epochs, kind, g_rounds,
                                  encode=encode, out_dtype=slice_dtype)
    row_spec = coding.tree_to_flat(w0)[1] if kind == "flat" else None
    tr = get_tracer()
    if encode:
        enc = coding._matrix(store.scheme.encode_matrix(), sim.device)
        args = (w0, xs, ys, enc)
    else:
        args = (w0, xs, ys)
    with tr.span("device.stage_program", stage=plan.stage, shards=len(shards),
                 rounds=g_rounds, encode=encode) as sp:
        if tr.annotate_costs:
            sp.annotate(**stage_cost(sim, w0, xs, ys, g_rounds))
        if tr.annotate_costs and encode:
            sp.annotate(**encode_cost(
                store.scheme.num_clients, store.scheme.num_shards, g_rounds,
                int(xs.shape[1]) * _flat_row_len(w0),
                2 if coding.as_dtype(slice_dtype) == torch.bfloat16 else 4))
        final, round_in, hist, norms_dev = prog(*args)
    if encode:
        store.put_stage_encoded(hist, row_spec, row_len=_flat_row_len(w0))
    else:
        for g in range(g_rounds):
            if kind == "flat":
                payload = RoundPayload.from_flat(
                    g, plan.shard_clients,
                    {s: hist[g, i] for i, s in enumerate(shards)}, row_spec)
            else:
                payload = RoundPayload.from_stacked(
                    g, plan.shard_clients,
                    {s: tree_map(lambda v, i=i: v[i], hist[g])
                     for i, s in enumerate(shards)})
            store.put_round(payload)
    store.flush()
    shard_models = {s: tree_map(lambda v, i=i: v[i], final)
                    for i, s in enumerate(shards)}
    round_globals = {s: StackedRoundGlobals(round_in, final, i)
                     for i, s in enumerate(shards)}
    # ONE host sync for every stored-update norm of the stage
    arr = norms_dev.cpu().numpy()                       # (G, S, M)
    return StageRecord(plan, shard_models, round_globals, store,
                       history_norms=_norms_dict(plan, shards, arr, g_rounds))


def _run_fused(sim, plan, store, w0, data, g_rounds, kind):
    from repro_torch.fl.simulator import StageRecord

    fl = sim.fl
    row_spec = coding.tree_to_flat(w0)[1] if kind == "flat" else None
    # round-major loop: all shards advance one round, then the round is
    # stored together (the coded store encodes ACROSS the S shards)
    shards = sorted(plan.shard_clients)
    ws = {s: w0 for s in shards}
    round_globals = {s: [] for s in shards}
    norms_dev = {s: [] for s in shards}
    for g in range(g_rounds):
        payload = {}
        for s in shards:
            round_globals[s].append(ws[s])
            xs, ys = data[s]
            stacked = tree_map(lambda v: v.float().unsqueeze(0), ws[s])
            new, out, nrm = sim.shard_round(stacked, xs.unsqueeze(0),
                                            ys.unsqueeze(0), fl.local_epochs,
                                            kind)
            ws[s] = tree_map(lambda v: v[0], new)
            payload[s] = (out[0] if kind == "flat"
                          else tree_map(lambda v: v[0], out))
            norms_dev[s].append(nrm[0])
        if kind == "flat":
            store.put_round(RoundPayload.from_flat(
                g, plan.shard_clients, payload, row_spec))
        else:
            store.put_round(RoundPayload.from_stacked(
                g, plan.shard_clients, payload))
    store.flush()
    for s in shards:
        round_globals[s].append(ws[s])
    # ONE host sync for every stored-update norm of the stage; shards may
    # hold different client counts (a dropout-ragged stage), so each
    # shard's (G, M_s) block is cut from one flat copy
    flat = torch.cat([torch.stack(norms_dev[s]).reshape(-1)
                      for s in shards]).cpu().numpy()
    norms, off = {}, 0
    for s in shards:
        m = len(plan.shard_clients[s])
        arr = flat[off:off + g_rounds * m].reshape(g_rounds, m)
        off += g_rounds * m
        for g in range(g_rounds):
            for j, c in enumerate(plan.shard_clients[s]):
                norms[(s, g, c)] = float(arr[g, j])
    return StageRecord(plan, dict(ws), round_globals, store,
                       history_norms=norms)


def _train_stage_legacy(sim, plan, w0, store_kind: str, g_rounds: int):
    """The reference's seed per-client round loop (unstack, one host pull
    per update norm, per-round tree flatten and encode), for A/B."""
    from repro_torch.core import unlearning
    from repro_torch.fl.simulator import StageRecord, _broadcast, _lift

    fl = sim.fl
    store = sim._make_store(store_kind, plan)
    ws = {s: w0 for s in plan.shard_clients}
    data = {s: sim._stack_client_data(cs)
            for s, cs in plan.shard_clients.items()}
    round_globals = {s: [] for s in plan.shard_clients}
    norms = {}
    for g in range(g_rounds):
        all_params = {}
        for s, clients in plan.shard_clients.items():
            round_globals[s].append(ws[s])
            xs, ys = data[s]
            p0 = _broadcast(_lift(ws[s]), (len(clients),))
            locals_ = sim.local_train(p0, xs, ys, fl.local_epochs)
            per_client = [tree_map(lambda v, i=i: v[i], locals_)
                          for i in range(len(clients))]
            all_params.update(dict(zip(clients, per_client)))
            for i, c in enumerate(clients):
                d = unlearning.tree_sub(per_client[i], ws[s])
                norms[(s, g, c)] = float(unlearning.tree_norm(d))
            ws[s] = unlearning.tree_mean(per_client)
        store.put_round(RoundPayload.from_clients(g, plan.shard_clients,
                                                  all_params))
    for s in plan.shard_clients:
        round_globals[s].append(ws[s])
    return StageRecord(plan, dict(ws), round_globals, store,
                       history_norms=norms)
