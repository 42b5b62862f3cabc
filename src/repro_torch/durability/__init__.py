"""Crash-consistent durability (``repro.durability`` on torch): snapshots,
write-ahead journal, recovery.

* ``snapshot``     — versioned, checksummed snapshot format for parameter
  trees + store state (coded slices incl. bf16, coding keys, ``StoreStats``)
  with atomic rename-commit; tensors are stored as their raw bytes.
* ``journal``      — append-only, per-record-checksummed write-ahead log of
  session and service events (stage completions, request dispatch/commit).
* ``checkpointer`` — ``CheckpointManager``: snapshot rotation with
  corrupt-snapshot fallback, paired with the journal.
* ``session_state`` — capture/restore of ``FederatedSession`` state (the
  resume path; imported lazily to avoid a cycle with the session module).

Wired through ``FederatedSession(checkpoint_every=, checkpoint_dir=)`` /
``ScenarioConfig`` and ``UnlearningService(journal=)``; crash injection
lives in ``repro_torch.faults`` (``process_kill`` / ``torn_write``).
"""
from repro_torch.durability.checkpointer import CheckpointManager
from repro_torch.durability.journal import Journal, replay
from repro_torch.durability.snapshot import (SnapshotCorruption,
                                             load_snapshot, save_snapshot)

__all__ = [
    "CheckpointManager", "Journal", "replay",
    "SnapshotCorruption", "load_snapshot", "save_snapshot",
    "capture_session", "restore_session",
]


def __getattr__(name):
    # session_state pulls in the tiered store and the session's classes;
    # load lazily so importing this package from the session is cycle-free
    if name in ("capture_session", "restore_session"):
        from repro_torch.durability import session_state
        return getattr(session_state, name)
    raise AttributeError(name)
