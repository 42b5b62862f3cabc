"""Capture/restore a ``FederatedSession``'s durable state
(``repro.durability.session_state`` on torch).

``capture_session`` turns the session's live state into a plain object
graph the snapshot format can serialize exactly: the shard manager's RNG
state and stage plans, every completed ``StageRecord`` (plan, shard models,
materialized round globals, history norms, and the parameter store's
contents — coded slices + specs + layouts, the tier table, or per-client
trees), the ``SessionReport`` (including per-request ``UnlearnResult``
models), and the set of served request ids.

``restore_session`` rebuilds that state onto a *freshly constructed* session
of the same configuration (same simulator seed / store kind / engine), its
tensors on the restoring session's device: a snapshot taken on the card
restores on the CPU, and the other way round, with the same bytes.

The port's only state that lives from one stage to the next is the shard
manager's numpy generator (``core/sharding.py``, ``ShardManager._rng``),
which the snapshot carries.  A stage's initial model is drawn from a
``torch.Generator`` seeded ``seed + salt`` (salt = the stage's index), or
from the session's ``init_fn(salt)``; neither carries state across stages.
So a resumed ``run`` re-trains post-snapshot stages bit-identically, the
durability contract's whole premise.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.durability.snapshot import dtype_name, torch_dtype
from repro_torch.stores.store import (CodedStore, FullStore,
                                      UncodedShardStore, _StackedRow)
from repro_torch.tiering.budget import MemoryBudget
from repro_torch.tiering.store import TieredStore
from repro_torch.tiering.tiers import TierEntry, cold_file_crc

STATE_VERSION = 1


def _materialize(tree):
    return tree.materialize() if isinstance(tree, _StackedRow) else tree


def _place(obj, dev: torch.device):
    """``obj`` with every tensor inside its dicts, lists and tuples moved to
    ``dev`` (a tensor already there is kept as is)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _place(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_place(v, dev) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_place(v, dev) for v in obj)
    return obj


def _slice_dtype(store):
    return dtype_name(store.slice_dtype) if store.slice_dtype is not None \
        else None


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

def _capture_store(store) -> dict:
    if isinstance(store, TieredStore):      # before CodedStore: a subclass
        with store._lock:
            store.flush()
            entries = {}
            for rnd, e in store._slices.entries().items():
                ent = {"tier": e.tier, "hits": int(e.hits),
                       "last_access": int(e.last_access),
                       "stage": int(e.stage), "lossy": bool(e.lossy),
                       "shape": (int(e.shape[0]), int(e.shape[1])),
                       "dtype": dtype_name(e.dtype),
                       "scales": e.scales,
                       # cold pointer: basename + crc — the file itself is
                       # NOT copied into the snapshot; resume revalidates it
                       # in place
                       "path": (os.path.basename(e.path) if e.path
                                else None),
                       "file_crc": e.file_crc}
                if e.tier == "hot":
                    ent["device"] = e.device
                if e.q is not None and e.path is None:
                    ent["q"] = e.q          # RAM-only lossy payload
                entries[rnd] = ent
            return {"kind": "tiered",
                    "scheme": store.scheme,
                    "shard_clients": store.shard_clients,
                    "slice_dtype": _slice_dtype(store),
                    "group_rounds": int(store.group_rounds),
                    "budget": store.budget.to_dict(),
                    "eviction": store.eviction,
                    "promote_on_read": bool(store.promote_on_read),
                    "offload_dir": store.offload_dir,
                    "cold_dir": store._cold_dir,
                    "seq": int(store._slices._seq),
                    "births": int(store._slices._births),
                    "entries": entries,
                    "specs": dict(store._specs),
                    "layouts": dict(store._layouts),
                    "stats": store.stats}
    if isinstance(store, CodedStore):
        store.flush()                       # materialize deferred encodes
        return {"kind": "coded",
                "scheme": store.scheme,
                "shard_clients": store.shard_clients,
                "slice_dtype": _slice_dtype(store),
                "group_rounds": int(store.group_rounds),
                "slices": dict(store._slices),
                "specs": dict(store._specs),
                "layouts": dict(store._layouts),
                "stats": store.stats}
    if isinstance(store, UncodedShardStore):
        return {"kind": "uncoded",
                "data": {k: _materialize(v) for k, v in store._data.items()},
                "shards": store._shards,
                "shard_of": store.shard_of,
                "per_shard": store._per_shard,
                "stats": store.stats}
    if isinstance(store, FullStore):
        return {"kind": "full",
                "data": {k: _materialize(v) for k, v in store._data.items()},
                "shards": store._shards,
                "stats": store.stats}
    raise TypeError(f"cannot capture store of type {type(store).__name__}; "
                    f"durable sessions support full/uncoded/coded/tiered")


def _restore_store(st: dict, device=None):
    """The store ``st`` describes, its tensors on ``device`` (where the
    snapshot put them when None)."""
    dev = torch.device(device) if device is not None else None

    def place(obj):
        return _place(obj, dev) if dev is not None else obj

    kind = st["kind"]
    if kind == "tiered":
        store = TieredStore(st["scheme"], st["shard_clients"],
                            slice_dtype=st["slice_dtype"],
                            group_rounds=st["group_rounds"],
                            budget=MemoryBudget(**st["budget"]),
                            eviction=st["eviction"],
                            offload_dir=st["offload_dir"],
                            promote_on_read=st["promote_on_read"])
        store._cold_dir = st["cold_dir"]
        table = store._slices
        for rnd, ent in st["entries"].items():
            path = None
            if ent["path"] is not None:
                path = os.path.join(st["cold_dir"], ent["path"])
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"cold-tier file missing on resume: {path}")
                if ent["file_crc"] is not None \
                        and cold_file_crc(path) != ent["file_crc"]:
                    raise IOError(f"cold-tier file corrupted: {path} "
                                  f"(crc mismatch)")
            hot = place(ent.get("device"))
            scales = ent["scales"]
            table._entries[rnd] = TierEntry(
                key=rnd, shape=tuple(ent["shape"]),
                dtype=torch_dtype(ent["dtype"]), tier=ent["tier"],
                device=hot,
                q=(np.asarray(ent["q"], np.int8).reshape(ent["shape"])
                   if "q" in ent else None),
                scales=(np.asarray(scales, np.float32)
                        if scales is not None else None),
                path=path, file_crc=ent["file_crc"], lossy=ent["lossy"],
                hits=ent["hits"], last_access=ent["last_access"],
                stage=ent["stage"],
                home=(dev if dev is not None else
                      hot.device if hot is not None else
                      torch.device("cpu")))
        table._seq = st["seq"]
        table._births = st["births"]
        store._specs = dict(st["specs"])
        store._layouts = dict(st["layouts"])
        store.stats = st["stats"]
        return store
    if kind == "coded":
        store = CodedStore(st["scheme"], st["shard_clients"],
                           slice_dtype=st["slice_dtype"],
                           group_rounds=st["group_rounds"])
        store._slices = place(dict(st["slices"]))
        store._specs = dict(st["specs"])
        store._layouts = dict(st["layouts"])
        store.stats = st["stats"]
        return store
    if kind == "uncoded":
        store = UncodedShardStore(st["shard_of"])
        store._per_shard = dict(st["per_shard"])
    elif kind == "full":
        store = FullStore()
    else:
        raise ValueError(f"unknown store kind {kind!r} in snapshot")
    store._data = place(dict(st["data"]))
    store._shards = dict(st["shards"])
    store.stats = st["stats"]
    return store


# ---------------------------------------------------------------------------
# Records + report
# ---------------------------------------------------------------------------

def _capture_record(record) -> dict:
    return {"plan": record.plan,
            "shard_models": dict(record.shard_models),
            # materialize lazy StackedRoundGlobals views into plain lists
            "round_globals": {s: list(v)
                              for s, v in record.round_globals.items()},
            "history_norms": dict(record.history_norms),
            "store": _capture_store(record.store)}


def _restore_record(st: dict, dev: torch.device):
    from repro_torch.fl.simulator import StageRecord
    return StageRecord(plan=st["plan"],
                       shard_models=_place(st["shard_models"], dev),
                       round_globals=_place(st["round_globals"], dev),
                       store=_restore_store(st["store"], dev),
                       history_norms=st["history_norms"])


def _capture_result(res, live_stats) -> dict:
    # the serving paths hand UnlearnResult the record store's LIVE StoreStats
    # object, so later reads mutate already-recorded results; a restored
    # report must re-alias (not copy) to stay bit-identical with the
    # uninterrupted run
    return {"framework": res.framework, "models": dict(res.models),
            "wall_time": float(res.wall_time),
            "cost_units": float(res.cost_units),
            "store_stats": res.store_stats,
            "stats_live": res.store_stats is live_stats,
            "impacted_shards": [int(s) for s in res.impacted_shards],
            "request_id": getattr(res, "request_id", "")}


def _restore_result(st: dict, dev: torch.device):
    from repro_torch.fl.simulator import UnlearnResult
    return UnlearnResult(framework=st["framework"],
                         models=_place(st["models"], dev),
                         wall_time=st["wall_time"],
                         cost_units=st["cost_units"],
                         store_stats=st["store_stats"],
                         impacted_shards=st["impacted_shards"],
                         request_id=st.get("request_id", ""))


def _capture_report(report, records) -> dict:
    return {"store_kind": report.store_kind,
            "stages": [{"stage": s.stage, "plan_stage": s.plan_stage,
                        "train_wall": float(s.train_wall),
                        "num_shards": int(s.num_shards),
                        "clients": [int(c) for c in s.clients],
                        "store_stats": s.store_stats,
                        "unlearn": [_capture_result(
                            u, records[s.stage].store.stats)
                            for u in s.unlearn]}
                       for s in report.stages]}


def _restore_report(st: dict, records, dev: torch.device):
    from repro_torch.fl.experiment.session import SessionReport, StageReport
    report = SessionReport(store_kind=st["store_kind"])
    for s in st["stages"]:
        unlearn = []
        for u in s["unlearn"]:
            res = _restore_result(u, dev)
            if u.get("stats_live"):
                res.store_stats = records[s["stage"]].store.stats
            unlearn.append(res)
        report.stages.append(StageReport(
            stage=s["stage"], plan_stage=s["plan_stage"],
            train_wall=s["train_wall"], num_shards=s["num_shards"],
            clients=s["clients"], store_stats=s["store_stats"],
            unlearn=unlearn))
    return report


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

def capture_session(session) -> dict:
    sim = session.sim
    return {
        "version": STATE_VERSION,
        "store_kind": session.store_kind,
        "engine": session.engine,
        "seed": int(sim.seed),
        "num_stages": len(session.records),
        "rng_state": sim.mgr._rng.bit_generator.state,
        "mgr_stages": list(sim.mgr.stages),
        "records": [_capture_record(r) for r in session.records],
        "report": _capture_report(session.report, session.records),
        "served": sorted(session._served),
    }


def restore_session(session, state: dict) -> int:
    """Load ``state`` (from ``capture_session``) into ``session``, its
    tensors on the session's device; returns the number of completed stages
    restored.  The session must be freshly built with the same
    configuration the snapshot was taken under."""
    if state.get("version") != STATE_VERSION:
        raise ValueError(f"snapshot state version {state.get('version')!r} "
                         f"!= supported {STATE_VERSION}")
    for knob in ("store_kind", "engine"):
        if state[knob] != getattr(session, knob):
            raise ValueError(
                f"snapshot was taken with {knob}={state[knob]!r} but this "
                f"session has {knob}={getattr(session, knob)!r}; resume "
                f"needs an identically configured session")
    if state["seed"] != session.sim.seed:
        raise ValueError(f"snapshot seed {state['seed']} != simulator seed "
                         f"{session.sim.seed}; resumed training would "
                         f"diverge from the original run")
    dev = session.sim.device
    session.sim.mgr._rng.bit_generator.state = state["rng_state"]
    session.sim.mgr.stages = list(state["mgr_stages"])
    session.records = [_restore_record(r, dev) for r in state["records"]]
    session.report = _restore_report(state["report"], session.records, dev)
    session._served = set(state["served"])
    return int(state["num_stages"])
