"""``TieredStore`` — the coded store on a hot/warm/cold tier ladder
(``repro.tiering.store`` on torch).

Drop-in ``CodedStore`` subclass registered as ``"tiered"`` in ``STORES``:
the only structural change is that the round→slices dict is replaced by a
``TierTable``, a ``MutableMapping`` whose ``__setitem__`` admits rounds to
the hot tier and enforces the ``MemoryBudget`` by demoting victims down the
ladder (hot → warm int8 → cold disk), and whose ``__getitem__`` serves the
round back from whatever tier it lives in (dequantizing / mmap-reading as
needed, then one upload to the round's device) with per-tier
hit/miss/byte accounting in ``StoreStats`` and ``tier.decode`` /
``tier.promote`` / ``tier.demote`` spans in the tracer.

With the default unlimited budget nothing ever demotes and every read is the
device tensor itself — bit-identical to ``CodedStore``, byte-for-byte in the
shared ``StoreStats`` fields.  Under pressure the store trades bytes for a
bounded decode error: warm/cold rounds reconstruct within the int8
quantization bound (``quant_error_bound``), and the robust-decode tolerance
widens accordingly so quantization residue is never mistaken for
corruption.

Threads and streams: the table is only touched inside ``CodedStore``'s
read/write paths, which hold ``self._lock`` (re-entrant) around every
``_slices`` access, so the service's slots promote and demote safely.  On
the card each slot runs on a CUDA stream of its own, so (1) a tensor enters
the table only once the stream that made it has finished (an admitted
round is synchronized, an upload synchronizes in ``dequantize_int8``), and
(2) every hot read marks the tensor ``record_stream`` for the reading
stream, so a demotion that drops the table's reference cannot hand its
memory to another allocation while that stream still reads it.  A round
admitted as a view of a larger tensor (the stage engine's (G, C, P)
encode) is copied, so demoting it frees its bytes.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Iterator, MutableMapping, Optional

import torch

from repro_torch.core import coding
from repro_torch.stores.store import CodedStore, register_store
from repro_torch.telemetry import get_tracer
from repro_torch.tiering.budget import UNLIMITED, MemoryBudget, make_eviction
from repro_torch.tiering.tiers import TIER_ORDER, TIERS, TierEntry, next_tier


def _admit(slices: torch.Tensor) -> torch.Tensor:
    """The tensor the hot tier holds for a round being admitted: complete
    on every stream, and owning its storage."""
    if slices.is_cuda:
        torch.cuda.current_stream(slices.device).synchronize()
    if slices.untyped_storage().nbytes() != \
            slices.numel() * slices.element_size():
        slices = slices.clone()
        if slices.is_cuda:
            torch.cuda.current_stream(slices.device).synchronize()
    return slices


class TierTable(MutableMapping):
    """round id → slice tensor, tier-managed.

    Callers must hold the owning store's ``_lock`` (true for every
    ``CodedStore`` path that touches ``_slices``)."""

    def __init__(self, store: "TieredStore"):
        self._store = store
        self._entries: Dict[int, TierEntry] = {}
        self._seq = 0                       # access clock (LRU order)
        self._births = 0                    # insert clock (stage-age order)
        self.last_served: Dict[int, str] = {}   # rnd -> tier of latest read

    # ------------------------------------------------------------ mapping
    def __setitem__(self, rnd: int, slices: torch.Tensor) -> None:
        slices = _admit(slices)
        e = self._entries.get(rnd)
        if e is None:
            e = TierEntry(key=rnd,
                          shape=(int(slices.shape[0]), int(slices.shape[1])),
                          dtype=slices.dtype, stage=self._births)
            self._births += 1
            self._entries[rnd] = e
        else:
            self._drop_bytes(e)
        e.home = slices.device
        self._seq += 1
        e.last_access = self._seq
        TIERS["hot"].place(e, array=slices)
        self._add_bytes(e)
        self._enforce()

    def __getitem__(self, rnd: int) -> torch.Tensor:
        e = self._entries[rnd]
        self._seq += 1
        e.last_access = self._seq
        e.hits += 1
        served = e.tier
        self.last_served[rnd] = served
        stats = self._store.stats
        stats.tier_hits[served] = stats.tier_hits.get(served, 0) + 1
        for t in TIER_ORDER:             # tiers above the serving one missed
            if t == served:
                break
            stats.tier_misses[t] = stats.tier_misses.get(t, 0) + 1
        if served == "hot":
            arr = e.device
            if arr.is_cuda:
                arr.record_stream(torch.cuda.current_stream(arr.device))
            return arr
        with get_tracer().span("tier.decode", round=rnd, tier=served):
            arr = TIERS[served].read(e)
        if (self._store.promote_on_read
                and self._store.budget.admits_hot(e.hot_nbytes())):
            with get_tracer().span("tier.promote", round=rnd, src=served):
                self._drop_bytes(e)
                TIERS["hot"].place(e, array=arr)
                self._add_bytes(e)
                stats.tier_promotions["hot"] = \
                    stats.tier_promotions.get("hot", 0) + 1
            self._enforce(pin=rnd)
        return arr

    def __delitem__(self, rnd: int) -> None:
        e = self._entries.pop(rnd)
        self._drop_bytes(e)
        self.last_served.pop(rnd, None)

    def __iter__(self) -> Iterator[int]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rnd) -> bool:     # MutableMapping's default would
        return rnd in self._entries          # decode via __getitem__

    # ------------------------------------------------------------- tiering
    def entry(self, rnd: int) -> Optional[TierEntry]:
        return self._entries.get(rnd)

    def entries(self) -> Dict[int, TierEntry]:
        return dict(self._entries)

    def _enforce(self, pin: Optional[int] = None) -> None:
        """Demote victims one rung at a time until every capped tier fits.
        ``pin`` protects the round just promoted by the in-flight read from
        being demoted back before it is even returned."""
        budget = self._store.budget
        for tier in ("hot", "warm"):
            limit = budget.limit(tier)
            if limit is None:
                continue
            while self._store.stats.tier_bytes.get(tier, 0) > limit:
                cands = [e for e in self._entries.values()
                         if e.tier == tier and e.key != pin]
                if not cands:
                    break
                self._demote(self._store.evict(cands))

    def _demote(self, e: TierEntry) -> None:
        src, dst = e.tier, next_tier(e.tier)
        with get_tracer().span("tier.demote", round=e.key, src=src, dst=dst):
            self._drop_bytes(e)
            TIERS[dst].place(e, cold_dir=self._store.cold_dir)
            self._add_bytes(e)
        stats = self._store.stats
        stats.tier_evictions[src] = stats.tier_evictions.get(src, 0) + 1

    def _add_bytes(self, e: TierEntry) -> None:
        tb = self._store.stats.tier_bytes
        tb[e.tier] = tb.get(e.tier, 0) + e.nbytes()

    def _drop_bytes(self, e: TierEntry) -> None:
        tb = self._store.stats.tier_bytes
        tb[e.tier] = tb.get(e.tier, 0) - e.nbytes()


class TieredStore(CodedStore):
    """Coded store whose slice tensors live on the hot/warm/cold ladder."""

    def __init__(self, scheme: coding.CodingScheme, shard_clients,
                 slice_dtype=None, group_rounds: int = 1,
                 budget: Optional[MemoryBudget] = None,
                 eviction: str = "lru",
                 offload_dir: Optional[str] = None,
                 promote_on_read: bool = True):
        super().__init__(scheme, shard_clients, slice_dtype=slice_dtype,
                         group_rounds=group_rounds)
        self.budget = budget if budget is not None else UNLIMITED
        self.eviction = eviction
        self.evict = make_eviction(eviction)
        self.promote_on_read = bool(promote_on_read)
        self.offload_dir = offload_dir
        self._cold_dir: Optional[str] = None
        self._slices = TierTable(self)       # type: ignore[assignment]

    # ------------------------------------------------------------ cold dir
    @property
    def cold_dir(self) -> str:
        """Lazy per-store offload directory — unique even when several stage
        stores share one ``offload_dir``, so cold files never collide."""
        if self._cold_dir is None:
            if self.offload_dir is not None:
                os.makedirs(self.offload_dir, exist_ok=True)
                self._cold_dir = tempfile.mkdtemp(prefix="cold-",
                                                  dir=self.offload_dir)
            else:
                self._cold_dir = tempfile.mkdtemp(prefix="repro-cold-")
        return self._cold_dir

    # ------------------------------------------------------- decode hooks
    def _injected_faults(self, rnd: int, slices: torch.Tensor):
        """Base slice faults, plus ``cold_corrupt`` noise when this read was
        served from the cold tier (bit-rot lives on the offloaded medium).
        The noise scale is the base's: summed in float64 where the slices
        lie, one scalar to the host."""
        lost, noise = super()._injected_faults(rnd, slices)
        with self._lock:
            cold = self._slices.last_served.get(rnd) == "cold"
        if self.faults is not None and cold:
            got = self.faults.cold_faults(rnd, self.scheme,
                                          int(slices.shape[1]),
                                          scale_ref=self._scale_ref(slices))
            for row, vec in got.items():
                noise[row] = noise[row] + vec if row in noise else vec
        return lost, noise

    def _decode_tol(self, rnd: int, slices: torch.Tensor) -> float:
        """Rounds that passed through the int8 tier carry ~0.4% relative
        quantization residue (same order as bf16 round-trip): widen the
        corruption-detection tolerance so lossy-but-honest slices are never
        flagged as corrupted."""
        with self._lock:
            e = self._slices.entry(rnd)
            lossy = e is not None and e.lossy
        if lossy:
            return 3e-2
        return super()._decode_tol(rnd, slices)

    # -------------------------------------------------------------- misc
    def tier_of(self, rnd: int) -> Optional[str]:
        e = self._slices.entry(rnd)
        return e.tier if e is not None else None

    def demote_all(self, to: str = "cold") -> None:
        """Force every resident round down to ``to`` (test/benchmark helper:
        'serve this session entirely from warm+cold')."""
        if to not in TIER_ORDER:
            raise ValueError(f"unknown tier {to!r}")
        with self._lock:
            self.flush()
            depth = TIER_ORDER.index(to)
            for e in self._slices.entries().values():
                while TIER_ORDER.index(e.tier) < depth:
                    self._slices._demote(e)


@register_store("tiered")
def _make_tiered(shard_clients, *, num_shards: int, num_clients: int,
                 group_rounds: int = 1, slice_dtype=None,
                 hot_bytes: Optional[int] = None,
                 warm_bytes: Optional[int] = None,
                 eviction: str = "lru",
                 offload_dir: Optional[str] = None,
                 promote_on_read: bool = True, **_options) -> TieredStore:
    # ``use_kernel`` lands in _options and is ignored, as for "coded"
    scheme = coding.CodingScheme(num_shards=num_shards,
                                 num_clients=num_clients)
    return TieredStore(scheme, shard_clients, group_rounds=group_rounds,
                       slice_dtype=slice_dtype,
                       budget=MemoryBudget(hot_bytes=hot_bytes,
                                           warm_bytes=warm_bytes),
                       eviction=eviction, offload_dir=offload_dir,
                       promote_on_read=promote_on_read)
