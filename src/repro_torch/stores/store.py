"""Intermediate-parameter stores — the storage substrate the paper optimizes.

``FullStore``         — FedEraser: the central server keeps every
                        participating client's parameters for every round.
``UncodedShardStore`` — isolated sharding: each shard's server keeps only
                        its own clients' parameters (still uncoded).
``CodedStore``        — coded sharding: per round, the S shard-stacked
                        parameter vectors are Lagrange-encoded into C slices
                        held by clients; retrieval reconstructs from any >= S
                        intact slices and tolerates up to (C-S)/2 corrupted.

Every store implements ``put_round(RoundPayload)`` and reports exact
integer byte/FLOP accounting (``StoreStats``), as ``repro.stores.store``
does.  On the card, ``CodedStore``'s encode and decode run through the
``coded_matmul`` kernel; ``put_stage_encoded`` registers slices the stage
engine already encoded with ``coded_matmul_rounds``.  With a
``repro_torch.faults.FaultPlan`` attached (``attach_faults``), reads run in
quorum mode around the plan's injected erasures and corruptions, and the
store's spans (``store.read``, ``store.encode``, ``store.put_stage``) go
to the current tracer.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import coding
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.faults.events import RecoveryEvent
from repro_torch.telemetry import get_tracer


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


@dataclass
class _StackedRow:
    """Lazy reference to row ``idx`` of a stacked (M, ...) parameter tree."""
    stacked: object
    idx: int

    def materialize(self):
        return tree_map(lambda v: v[self.idx], self.stacked)

    def stacked_rows(self) -> int:
        return tree_leaves(self.stacked)[0].shape[0]

    def nbytes(self) -> int:
        """This row's share of the stacked batch's bytes."""
        return tree_bytes(self.stacked) // max(self.stacked_rows(), 1)


@dataclass
class StoreStats:
    server_bytes: int = 0
    client_bytes: int = 0
    encode_flops: int = 0
    decode_flops: int = 0
    comm_bytes_store: int = 0     # bytes moved client->server (or client<->client)
    comm_bytes_retrieve: int = 0
    # quorum-read recovery accounting (CodedStore fault path)
    reads: int = 0                # shard reads served
    recovered_reads: int = 0      # reads that had to decode around a fault
    erased_slices: int = 0        # unreachable slices tolerated across reads
    corrupted_slices: int = 0     # corrupted slices localized + excluded
    failed_reads: int = 0         # reads aborted: faults exceeded the budget
    # tiered-store accounting, keyed by tier name (``repro_torch.tiering``)
    tier_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    tier_hits: Dict[str, int] = dataclasses.field(default_factory=dict)
    tier_misses: Dict[str, int] = dataclasses.field(default_factory=dict)
    tier_evictions: Dict[str, int] = dataclasses.field(default_factory=dict)
    tier_promotions: Dict[str, int] = dataclasses.field(default_factory=dict)

    def merge(self, other: "StoreStats") -> "StoreStats":
        """Field-wise accumulate ``other`` into self (returns self)."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(other, f.name)
            if isinstance(mine, dict):
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0) + v
            else:
                setattr(self, f.name, mine + theirs)
        return self

    def __iadd__(self, other: "StoreStats") -> "StoreStats":
        return self.merge(other)

    def __add__(self, other: "StoreStats") -> "StoreStats":
        return self.snapshot().merge(other)

    def snapshot(self) -> "StoreStats":
        out = dataclasses.replace(self)
        for f in dataclasses.fields(out):     # don't alias the dict fields
            v = getattr(out, f.name)
            if isinstance(v, dict):
                setattr(out, f.name, dict(v))
        return out

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Round payload + store protocol
# ---------------------------------------------------------------------------

@dataclass
class RoundPayload:
    """One FedAvg round's parameters, in producer-native form: exactly one
    of ``client_params`` ({client: tree}, the legacy engine's per-client
    form), ``stacked`` ({shard: (M, ...) tree}, rows in ``shard_clients``
    order) or ``flat`` ({shard: (M, P) matrix} + ``row_spec``)."""
    rnd: int
    shard_clients: Dict[int, List[int]]
    client_params: Optional[Dict[int, object]] = None
    stacked: Optional[Dict[int, object]] = None
    flat: Optional[Dict[int, torch.Tensor]] = None
    row_spec: object = None

    def __post_init__(self):
        forms = [x is not None for x in
                 (self.client_params, self.stacked, self.flat)]
        if sum(forms) != 1:
            raise ValueError("RoundPayload needs exactly one of "
                             "client_params / stacked / flat")
        if self.flat is not None and self.row_spec is None:
            raise ValueError("flat payload requires row_spec")

    @classmethod
    def from_clients(cls, rnd: int, shard_clients: Dict[int, List[int]],
                     client_params: Dict[int, object]) -> "RoundPayload":
        return cls(rnd, {s: list(cs) for s, cs in shard_clients.items()},
                   client_params=client_params)

    @classmethod
    def from_stacked(cls, rnd: int, shard_clients: Dict[int, List[int]],
                     stacked: Dict[int, object]) -> "RoundPayload":
        return cls(rnd, {s: list(cs) for s, cs in shard_clients.items()},
                   stacked=stacked)

    @classmethod
    def from_flat(cls, rnd: int, shard_clients: Dict[int, List[int]],
                  flat: Dict[int, torch.Tensor], row_spec) -> "RoundPayload":
        return cls(rnd, {s: list(cs) for s, cs in shard_clients.items()},
                   flat=flat, row_spec=row_spec)

    def iter_client_trees(self):
        """Yield (shard, client, tree or lazy row) for every client."""
        if self.client_params is not None:
            for s, cs in self.shard_clients.items():
                for c in cs:
                    if c in self.client_params:
                        yield s, c, self.client_params[c]
        elif self.stacked is not None:
            for s, cs in self.shard_clients.items():
                for i, c in enumerate(cs):
                    yield s, c, _StackedRow(self.stacked[s], i)
        else:
            raise ValueError("flat payload carries no per-client trees; "
                             "use a 'stacked' or 'client_params' payload")


@runtime_checkable
class ParameterStore(Protocol):
    """The single store interface the round engines and the session use."""

    stats: StoreStats
    wants: str        # preferred payload form: "flat" | "stacked"

    def put_round(self, payload: RoundPayload) -> None: ...

    def flush(self) -> None: ...

    def get(self, rnd: int, client: int): ...

    def get_shard(self, rnd: int, shard: int,
                  available: Optional[Sequence[int]] = None,
                  corrupt: Optional[np.ndarray] = None) -> Dict[int, object]: ...

    def clients_at(self, rnd: int) -> List[int]: ...


STORES: Dict[str, Callable[..., "ParameterStore"]] = {}


def register_store(name: str):
    """Register a store factory, called as ``factory(shard_clients,
    **options)`` (factories ignore the options they do not use)."""
    def deco(fn):
        STORES[name] = fn
        return fn
    return deco


def make_store(kind: str, shard_clients: Dict[int, List[int]],
               **options) -> "ParameterStore":
    try:
        factory = STORES[kind]
    except KeyError:
        raise KeyError(f"unknown store {kind!r}; registered: "
                       f"{sorted(STORES)}") from None
    return factory(shard_clients, **options)


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

class FullStore:
    """{(round, client_id): params} on the central server."""

    wants = "stacked"

    def __init__(self):
        self._data: Dict[Tuple[int, int], object] = {}
        self._shards: Dict[int, Dict[int, List[int]]] = {}  # rnd -> layout
        self.stats = StoreStats()
        self._lock = threading.RLock()

    def put_round(self, payload: RoundPayload) -> None:
        self._shards[payload.rnd] = payload.shard_clients
        for _s, c, p in payload.iter_client_trees():
            self._data[(payload.rnd, c)] = p
            b = p.nbytes() if isinstance(p, _StackedRow) else tree_bytes(p)
            self.stats.server_bytes += b
            self.stats.comm_bytes_store += b

    def flush(self) -> None:
        pass

    def get(self, rnd: int, client: int):
        with self._lock:
            p = self._data[(rnd, client)]
            if isinstance(p, _StackedRow):
                p = p.materialize()
                self._data[(rnd, client)] = p
            self.stats.comm_bytes_retrieve += tree_bytes(p)
        return p

    def get_shard(self, rnd: int, shard: int,
                  available: Optional[Sequence[int]] = None,
                  corrupt: Optional[np.ndarray] = None) -> Dict[int, object]:
        """Uncoded stores hold plaintext params: ``available``/``corrupt``
        model slice loss and do not apply here (ignored)."""
        return {c: self.get(rnd, c) for c in self._shards[rnd][shard]}

    def clients_at(self, rnd: int) -> List[int]:
        return sorted(c for (r, c) in self._data if r == rnd)


class UncodedShardStore(FullStore):
    """Same layout, but bytes are attributed per shard server
    (server_bytes tracks the largest shard)."""

    def __init__(self, shard_of: Dict[int, int]):
        super().__init__()
        self.shard_of = shard_of
        self._per_shard: Dict[int, int] = {}

    def put_round(self, payload: RoundPayload) -> None:
        self._shards[payload.rnd] = payload.shard_clients
        for s, c, p in payload.iter_client_trees():
            self._data[(payload.rnd, c)] = p
            b = p.nbytes() if isinstance(p, _StackedRow) else tree_bytes(p)
            self._per_shard[s] = self._per_shard.get(s, 0) + b
            self.stats.comm_bytes_store += b
        self.stats.server_bytes = max(self._per_shard.values(), default=0)


class CodedStore:
    """Lagrange-coded distributed store (paper Sec 3.3).  Per round the S
    shard parameter vectors (concat of their clients' params) are encoded
    to C slices; the server keeps only the CodingScheme (keys).  Decode
    returns {client_id: params} for one shard."""

    wants = "flat"

    def __init__(self, scheme: coding.CodingScheme,
                 shard_clients: Dict[int, List[int]], slice_dtype=None,
                 group_rounds: int = 1):
        self.scheme = scheme
        self.shard_clients = {s: list(cs) for s, cs in shard_clients.items()}
        self.slice_dtype = coding.as_dtype(slice_dtype)
        self.group_rounds = max(int(group_rounds), 1)
        self._slices: Dict[int, torch.Tensor] = {}    # round -> (C, P)
        self._specs: Dict[int, tuple] = {}
        self._layouts: Dict[int, list] = {}          # round -> client order
        self._pending: List[Tuple[int, torch.Tensor]] = []   # deferred rounds
        self._row_layout = None               # cached flat-path geometry
        self.faults = None                    # optional attached FaultPlan
        self.stats = StoreStats()
        self.stats.server_bytes = 16 * scheme.num_clients  # the keys
        # get_shard may flush and always updates stats: serialize readers
        self._lock = threading.RLock()

    def put_round(self, payload: RoundPayload) -> None:
        if payload.flat is not None:
            self._put_flat(payload.rnd, payload.flat, payload.row_spec)
        elif payload.client_params is not None:
            self._put_trees(payload.rnd, payload.client_params)
        else:
            flat, row_spec = {}, None
            for s, _cs in sorted(payload.shard_clients.items()):
                flat[s], row_spec = coding.tree_to_flat_stacked(
                    payload.stacked[s])
            self._put_flat(payload.rnd, flat, row_spec)

    def _put_trees(self, rnd: int, client_params: Dict[int, object]):
        """Encode this round's per-shard parameter sets ({client: tree},
        flattened in client order) into client slices, at once."""
        shard_trees, layout = [], []
        for s in sorted(self.shard_clients):
            cs = [c for c in self.shard_clients[s] if c in client_params]
            layout.append((s, cs))
            shard_trees.append({c: client_params[c] for c in cs})
        slices, specs = coding.encode_pytrees(self.scheme, shard_trees)
        with self._lock:
            self._slices[rnd] = slices
            self._specs[rnd] = specs
            self._layouts[rnd] = layout
            self._account_stored(slices)

    def _put_flat(self, rnd: int, shard_flats: Dict[int, torch.Tensor],
                  row_spec):
        """Per-shard stacked, already flat (M_s, P) client matrices.  The
        shard vector is the client-major ``reshape(-1)``; the encode is
        deferred and batched ``group_rounds`` rounds at a time (``flush``)."""
        with self._lock:
            if self._row_layout is None:
                layout, specs, lens = [], [], []
                for s in sorted(self.shard_clients):
                    cs = list(self.shard_clients[s])
                    f = shard_flats[s]
                    if f.shape[0] != len(cs):
                        raise ValueError(f"shard {s}: {f.shape[0]} rows for "
                                         f"{len(cs)} clients")
                    layout.append((s, cs))
                    specs.append(coding.StackedRowSpec(tuple(cs),
                                                       int(f.shape[1]),
                                                       row_spec))
                    lens.append(int(f.shape[0]) * int(f.shape[1]))
                self._row_layout = (layout, tuple(specs), max(lens))
            layout, specs, pmax = self._row_layout
            rows = [shard_flats[s].reshape(-1) for s, _ in layout]
            w = torch.stack([r if r.shape[0] == pmax
                             else F.pad(r, (0, pmax - r.shape[0]))
                             for r in rows])
            self._layouts[rnd] = layout
            self._specs[rnd] = specs
            self._pending.append((rnd, w))
            if len(self._pending) >= self.group_rounds:
                self.flush()

    def put_stage_encoded(self, coded: torch.Tensor, row_spec,
                          row_len: int) -> None:
        """Whole-stage write for the stage engine: ``coded`` is the
        ``(G, C, Pmax)`` slice tensor already encoded by
        ``coded_matmul_rounds``; the store only registers per-round views
        and accounts bytes/FLOPs exactly like ``_put_flat`` + ``flush``."""
        layout, specs = [], []
        for s in sorted(self.shard_clients):
            cs = list(self.shard_clients[s])
            layout.append((s, cs))
            specs.append(coding.StackedRowSpec(tuple(cs), row_len, row_spec))
        specs = tuple(specs)
        with self._lock, get_tracer().span("store.put_stage",
                                           rounds=int(coded.shape[0])):
            for g in range(int(coded.shape[0])):
                self._slices[g] = coded[g]
                self._layouts[g] = layout
                self._specs[g] = specs
                self._account_stored(coded[g])

    def flush(self):
        """Encode all deferred rounds in one batched coded matmul."""
        with self._lock:
            if not self._pending:
                return
            rounds = [r for r, _ in self._pending]
            mats = [w for _, w in self._pending]
            self._pending = []
            # ``kernel``: whether the encode ran the CUDA kernel (the plain
            # version on the CPU), the reference's ``use_kernel`` label
            with get_tracer().span("store.encode", rounds=len(rounds),
                                   kernel=bool(mats[0].is_cuda)):
                coded = coding.encode_batched(self.scheme, mats,
                                              out_dtype=self.slice_dtype)
            for rnd, slices in zip(rounds, coded):
                self._slices[rnd] = slices
                self._account_stored(slices)

    def _account_stored(self, slices: torch.Tensor):
        p = slices.shape[1]
        nbytes = int(slices.numel() * slices.element_size())
        self.stats.client_bytes += nbytes
        # distribution traffic: every client receives its slice
        self.stats.comm_bytes_store += nbytes
        self.stats.encode_flops += (2 * self.scheme.num_clients
                                    * self.scheme.num_shards * p)

    def attach_faults(self, plan) -> None:
        """Attach a ``repro_torch.faults.FaultPlan``: its slice injectors
        fire on every later ``get_shard`` (keyed per round — every reader of
        a round observes the same fault) and reads route through the
        quorum-read recovery path.  ``None`` detaches."""
        self.faults = plan

    def _injected_faults(self, rnd: int, slices: torch.Tensor):
        """Ask the attached ``FaultPlan`` (if any) for this round's slice
        faults: ``(lost_ids, {row: noise})``.  The noise scale is the mean
        |slice|, summed in float64 where the slices lie: one scalar moves
        to the host, not the (C, P) tensor."""
        if self.faults is None:
            return [], {}
        return self.faults.slice_faults(rnd, self.scheme,
                                        int(slices.shape[1]),
                                        scale_ref=self._scale_ref(slices))

    @staticmethod
    def _scale_ref(slices: torch.Tensor) -> float:
        """The injected noise's scale, mean |slice|: summed in float64 on
        the slices' device, one scalar moved to the host."""
        return float(slices.detach().abs().sum(dtype=torch.float64)
                     ) / max(slices.numel(), 1)

    def _decode_tol(self, rnd: int, slices: torch.Tensor) -> float:
        """Corruption-detection tolerance for ``decode_robust``: bf16 slices
        round-trip with ~4e-3 relative residual, so the tolerance scales
        with the storage dtype."""
        return 1e-3 if slices.element_size() >= 4 else 3e-2

    def get(self, rnd: int, client: int):
        """Single-client retrieval decodes the client's shard and indexes it."""
        for s, cs in self.shard_clients.items():
            if client in cs:
                return self.get_shard(rnd, s)[client]
        raise KeyError(client)

    def get_shard(self, rnd: int, shard: int,
                  available: Optional[Sequence[int]] = None,
                  corrupt: Optional[np.ndarray] = None) -> Dict[int, object]:
        """Reconstruct shard ``shard``'s stored params at round ``rnd``.

        ``available``: client ids whose slices are reachable (default all).
        ``corrupt``: optional (C, P) noise modelling erroneous slices.  With
        either, or with an attached ``FaultPlan`` that injects faults into
        this round, the read runs in quorum mode (``coding.decode_robust``)
        with per-read recovery accounting; faults beyond eq. 11's budget
        raise ``coding.CodingBudgetExceeded``.
        """
        with get_tracer().span("store.read", round=rnd, shard=shard) as sp:
            with self._lock:
                if rnd not in self._slices:
                    self.flush()              # materialize deferred encodes
                slices = self._slices[rnd]
                layout = self._layouts[rnd]
                specs = self._specs[rnd]
                self.stats.reads += 1
                self.stats.comm_bytes_retrieve += int(
                    self.scheme.num_shards * slices.shape[1]
                    * slices.element_size())
                self.stats.decode_flops += (2 * self.scheme.num_shards ** 2
                                            * slices.shape[1])
            # decode outside the lock: a pure function of the slices, so
            # interleaved serves decode different shards concurrently
            c = self.scheme.num_clients
            inj_lost, inj_noise = self._injected_faults(rnd, slices)
            if corrupt is None and available is None \
                    and not inj_lost and not inj_noise:
                w = coding.decode_erasure(self.scheme, slices, list(range(c)))
            else:
                if inj_noise:
                    rows = sorted(inj_noise)
                    noise = np.stack([inj_noise[r] for r in rows])
                    slices = slices.index_add(
                        0, torch.tensor(rows, device=slices.device),
                        torch.as_tensor(noise, dtype=slices.dtype,
                                        device=slices.device))
                if corrupt is not None:
                    slices = slices + torch.as_tensor(
                        corrupt, dtype=slices.dtype, device=slices.device)
                avail = (set(available) if available is not None
                         else set(range(c)))
                avail -= set(inj_lost)
                try:
                    w, lost, bad = coding.decode_robust(
                        self.scheme, slices, available=sorted(avail),
                        tol=self._decode_tol(rnd, slices))
                except coding.CodingBudgetExceeded:
                    with self._lock:
                        self.stats.failed_reads += 1
                    sp.annotate(failed=True)
                    raise
                if lost or bad:
                    with self._lock:
                        self.stats.recovered_reads += 1
                        self.stats.erased_slices += len(lost)
                        self.stats.corrupted_slices += len(bad)
                    sp.annotate(recovered=True, erased=len(lost),
                                corrupted=len(bad))
                    if self.faults is not None:
                        self.faults.ledger.record(RecoveryEvent(
                            "quorum_read",
                            site=("round", rnd, "shard", shard),
                            detail=(tuple(lost), tuple(bad))))
            for idx, (s, _cs) in enumerate(layout):
                if s == shard:
                    spec = specs[idx]
                    if isinstance(spec, coding.StackedRowSpec):
                        return coding.flat_to_client_trees(w[idx], spec)
                    return coding.flat_to_tree(w[idx], spec)
            raise KeyError(f"shard {shard} not stored at round {rnd}")

    def clients_at(self, rnd: int) -> List[int]:
        return sorted(c for _, cs in self._layouts[rnd] for c in cs)


# ---------------------------------------------------------------------------
# Registered factories (the names FLSimulator / ScenarioConfig use)
# ---------------------------------------------------------------------------

@register_store("full")
def _make_full(shard_clients, **_options) -> FullStore:
    return FullStore()


@register_store("uncoded")
def _make_uncoded(shard_clients, **_options) -> UncodedShardStore:
    return UncodedShardStore({c: s for s, cs in shard_clients.items()
                              for c in cs})


@register_store("coded")
def _make_coded(shard_clients, *, num_shards: int, num_clients: int,
                group_rounds: int = 1, slice_dtype=None,
                **_options) -> CodedStore:
    # ``use_kernel`` lands in _options and is ignored: the tensor's device
    # decides between the CUDA kernel and its plain version.
    scheme = coding.CodingScheme(num_shards=num_shards,
                                 num_clients=num_clients)
    return CodedStore(scheme, shard_clients, group_rounds=group_rounds,
                      slice_dtype=slice_dtype)
