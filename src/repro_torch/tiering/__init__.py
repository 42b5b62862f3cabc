"""Tiered coded parameter storage — hot / warm / cold under a memory budget
(``repro.tiering`` on torch).

Coded rounds demote through ``TIERS`` (hot device tensor → warm host int8 →
cold mmap'd disk file) under a ``MemoryBudget`` with pluggable ``EVICTION``
policies.  ``TieredStore`` registers as ``"tiered"`` in
``repro_torch.stores.STORES``, so every scenario, framework and the
unlearning service run on it unchanged (``ScenarioConfig(store="tiered",
store_options={...})``).
"""
from repro_torch.tiering.budget import (EVICTION, UNLIMITED, MemoryBudget,
                                        make_eviction, register_eviction)
from repro_torch.tiering.quant import (dequantize_int8, quant_error_bound,
                                       quantize_int8)
from repro_torch.tiering.store import TierTable, TieredStore
from repro_torch.tiering.tiers import (TIER_ORDER, TIERS, TierEntry,
                                       register_tier)

__all__ = [
    "EVICTION", "MemoryBudget", "TIERS", "TIER_ORDER", "TierEntry",
    "TierTable", "TieredStore", "UNLIMITED", "dequantize_int8",
    "make_eviction", "quant_error_bound", "quantize_int8",
    "register_eviction", "register_tier",
]
