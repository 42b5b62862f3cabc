"""Crash-consistent durability (``repro.durability`` on torch).

Only the write-ahead journal is ported so far: ``Journal`` (append-only,
per-record-checksummed JSONL, fsynced per record) and ``replay``.  The
online service journals ``svc_dispatch``/``svc_commit`` through it and
``UnlearningService.serve(resume=True)`` replays from it; an ``AuditLog``
on a journal splices onto the chain already there.  Snapshots, the
checkpointer and the session's capture/restore are not ported yet.
"""
from repro_torch.durability.journal import Journal, replay

__all__ = ["Journal", "replay"]
