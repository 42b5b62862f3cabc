"""Deprecated alias for :mod:`repro_torch.stores` (``repro.checkpoint``).

``checkpoint`` always held the paper's *parameter stores* (full / uncoded /
coded), not training checkpoints.  This shim keeps old imports working;
the re-exported objects are the same classes as ``repro_torch.stores``
(identity, not copies), so registries and isinstance checks are unaffected.
"""
import warnings

warnings.warn(
    "repro_torch.checkpoint is deprecated; it holds parameter stores, not "
    "checkpoints — import repro_torch.stores instead (crash-recovery "
    "checkpointing lives in repro_torch.durability)",
    DeprecationWarning,
    stacklevel=2,
)

from repro_torch.stores.store import (CodedStore, FullStore,  # noqa: F401,E402
                                      ParameterStore, RoundPayload, STORES,
                                      StoreStats, UncodedShardStore,
                                      make_store, register_store, tree_bytes)
