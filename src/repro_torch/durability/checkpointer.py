"""Snapshot rotation + journal pairing: the durable face of a session
(``repro.durability.checkpointer`` on torch).

A ``CheckpointManager`` owns one directory::

    <dir>/snap-000003.ckpt     # versioned, checksummed snapshots
    <dir>/journal.wal          # write-ahead journal (append-only)

``save`` commits a snapshot atomically (``repro_torch.durability.snapshot``),
fires the fault plan's ``post_snapshot`` hook (the torn-write injector's
site), and prunes old snapshots, always keeping at least the two most
recent, so a snapshot corrupted *after* commit still has a good predecessor
to fall back to.  ``load_latest`` walks snapshots newest-first and skips any
that fail checksum validation (recording them in ``skipped``), returning the
newest *good* state, its tensors on ``device`` (the CPU when None).
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from repro_torch.durability.journal import Journal
from repro_torch.durability.snapshot import (SnapshotCorruption,
                                             load_snapshot, save_snapshot)
from repro_torch.telemetry import get_tracer

_SNAP_RE = re.compile(r"^snap-(\d{6})\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2, faults=None):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.keep = max(int(keep), 2)
        self.faults = faults                       # optional FaultPlan
        self.journal = Journal(os.path.join(directory, "journal.wal"))
        self.skipped: List[str] = []               # corrupt snaps last load
        self.last_save_bytes = 0

    def snapshot_path(self, step: int) -> str:
        return os.path.join(self.directory, f"snap-{step:06d}.ckpt")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _SNAP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, state, step: int) -> str:
        path = self.snapshot_path(step)
        with get_tracer().span("durability.snapshot", step=step) as sp:
            self.last_save_bytes = save_snapshot(path, state)
            sp.annotate(bytes=self.last_save_bytes)
            if self.faults is not None and hasattr(self.faults,
                                                   "post_snapshot"):
                self.faults.post_snapshot(path, step)
            self._prune()
        return path

    def load_latest(self, device=None
                    ) -> Optional[Tuple[object, int, str]]:
        """Newest good ``(state, step, path)``; corrupt snapshots are skipped
        (collected in ``self.skipped``), the torn-write fallback path."""
        self.skipped = []
        with get_tracer().span("durability.restore") as sp:
            for step in reversed(self.steps()):
                path = self.snapshot_path(step)
                try:
                    state = load_snapshot(path, device=device)
                    sp.annotate(step=step, skipped=len(self.skipped))
                    return state, step, path
                except SnapshotCorruption:
                    self.skipped.append(path)
        return None

    def _prune(self) -> None:
        for step in self.steps()[:-self.keep]:
            try:
                os.remove(self.snapshot_path(step))
            except OSError:
                pass
