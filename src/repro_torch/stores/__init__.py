"""Parameter stores (``repro.stores`` on torch): ``full`` / ``uncoded`` /
``coded`` behind ``ParameterStore.put_round(RoundPayload)`` and the
``STORES`` registry, plus ``tiered`` from ``repro_torch.tiering``.
"""
from repro_torch.stores.store import (CodedStore, FullStore,  # noqa: F401
                                      ParameterStore, RoundPayload, STORES,
                                      StoreStats, UncodedShardStore,
                                      make_store, register_store, tree_bytes)

# registration side-effect: makes store="tiered" resolvable everywhere the
# STORES registry is consulted (ScenarioConfig, FLSimulator)
import repro_torch.tiering.store  # noqa: E402,F401
