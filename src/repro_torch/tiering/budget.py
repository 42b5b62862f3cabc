"""Memory budgets and the ``EVICTION`` policy registry
(``repro.tiering.budget`` on torch; host-side code, carried over as is).

A ``MemoryBudget`` caps the bytes resident in the hot (device) and warm
(host-RAM) tiers; ``None`` means unlimited — the default budget keeps every
round hot, which is exactly ``CodedStore``'s behavior (and what the
bit-identity tests assert).  The cold tier is disk and unbounded.

Eviction policies are victim selectors: given the candidate entries of an
over-budget tier, pick the one to demote a rung down.  Registered like every
other pluggable in this package (``STORES``/``POLICIES``/``INJECTORS``):

* ``lru``       — demote the least-recently-accessed round.
* ``stage_age`` — demote the oldest round (training history cools front to
  back: early rounds are only re-read when an unlearning request reaches
  back to them).
* ``heat``      — Zipf-aware: demote the *coldest* round by service access
  count (ties broken by recency).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.tiering.tiers import TierEntry


@dataclass(frozen=True)
class MemoryBudget:
    """Byte caps per capped tier (``None`` = unlimited)."""
    hot_bytes: Optional[int] = None
    warm_bytes: Optional[int] = None

    def limit(self, tier: str) -> Optional[int]:
        return {"hot": self.hot_bytes, "warm": self.warm_bytes}.get(tier)

    def admits_hot(self, nbytes: int) -> bool:
        """Can an entry of this size ever be hot-resident at all?  (Promotion
        is skipped entirely when it can't — avoids promote/demote churn when
        ``hot_bytes`` is below one round.)"""
        return self.hot_bytes is None or nbytes <= self.hot_bytes

    def to_dict(self) -> dict:
        return {"hot_bytes": self.hot_bytes, "warm_bytes": self.warm_bytes}


UNLIMITED = MemoryBudget()


EVICTION: Dict[str, Callable[[List[TierEntry]], TierEntry]] = {}


def register_eviction(name: str):
    def deco(fn):
        EVICTION[name] = fn
        return fn
    return deco


def make_eviction(name: str) -> Callable[[List[TierEntry]], TierEntry]:
    try:
        return EVICTION[name]
    except KeyError:
        raise KeyError(f"unknown eviction policy {name!r}; registered: "
                       f"{sorted(EVICTION)}") from None


@register_eviction("lru")
def _lru(entries: List[TierEntry]) -> TierEntry:
    return min(entries, key=lambda e: (e.last_access, e.key))


@register_eviction("stage_age")
def _stage_age(entries: List[TierEntry]) -> TierEntry:
    return min(entries, key=lambda e: (e.stage, e.key))


@register_eviction("heat")
def _heat(entries: List[TierEntry]) -> TierEntry:
    return min(entries, key=lambda e: (e.hits, e.last_access, e.key))
