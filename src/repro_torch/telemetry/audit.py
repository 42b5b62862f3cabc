"""Append-only, hash-chained audit log of unlearning lifecycle events.

Unlearning is a compliance operation: "client 7's data was erased" needs an
auditable, tamper-evident record, not just a ledger row (Blockchain-enabled
Trustworthy Federated Unlearning, arXiv 2401.15917, makes the case; this is
the lightweight, chain-without-the-blockchain version).  Every lifecycle
event — request received → scheduled → shards retrained → committed — is
appended as a record carrying the SHA-256 of its predecessor::

    hash_n = sha256(hash_{n-1} || canonical_json(event_n))

so truncating, reordering, or editing any record breaks every later hash
(``verify_chain`` walks the chain and raises ``AuditChainError`` at the
first break).

Durability layers on the write-ahead journal: with a
``repro_torch.durability.Journal`` attached, every audit record is ALSO journaled
(``{"ev": "audit", "event": ..., "prev": ..., "hash": ...}``, fsynced,
CRC-per-line), and a fresh ``AuditLog`` on the same journal **splices**:
it replays the journaled chain, verifies it, and continues appending from
its head — so a ``serve(resume=True)`` after a crash extends the original
chain into one verifiable history instead of starting a second one.

Determinism contract: callers record only deterministic fields (request
ids, client ids, shard sets, batch ids, virtual times — never measured
walls), so two seeded runs of the same workload produce bit-identical
chain heads (asserted in ``tests/test_torch_telemetry.py``).
"""
from __future__ import annotations

import hashlib
import json
from typing import List, Optional

GENESIS = "0" * 64


class AuditChainError(RuntimeError):
    """The audit chain failed verification: a record was altered, dropped,
    reordered, or spliced from a different history."""


def canonical(event: dict) -> str:
    """The byte-stable form a record's hash covers."""
    return json.dumps(event, sort_keys=True, separators=(",", ":"))


def chain_hash(prev_hash: str, event: dict) -> str:
    return hashlib.sha256((prev_hash + canonical(event)).encode()).hexdigest()


def verify_chain(records: List[dict], genesis: str = GENESIS) -> str:
    """Walk ``[{"event", "prev", "hash"}, ...]`` from ``genesis``; returns
    the verified head hash, raises ``AuditChainError`` at the first break."""
    head = genesis
    for i, rec in enumerate(records):
        if rec["prev"] != head:
            raise AuditChainError(
                f"record {i} ({rec['event'].get('kind')!r}): prev hash "
                f"{rec['prev'][:12]}... does not extend head "
                f"{head[:12]}...")
        expect = chain_hash(head, rec["event"])
        if rec["hash"] != expect:
            raise AuditChainError(
                f"record {i} ({rec['event'].get('kind')!r}): stored hash "
                f"{rec['hash'][:12]}... != recomputed {expect[:12]}... "
                f"(record tampered)")
        head = rec["hash"]
    return head


def journal_chain(journal) -> List[dict]:
    """Extract the audit records from a ``repro_torch.durability.Journal`` (or
    anything with ``events()``), in append order — the on-disk chain a
    verifier checks end-to-end with ``verify_chain``."""
    return [{"event": ev["event"], "prev": ev["prev"], "hash": ev["hash"]}
            for ev in journal.events() if ev.get("ev") == "audit"]


class AuditLog:
    """The writer: in-memory chain, optionally journal-backed.

    >>> audit = AuditLog(journal=service.journal)
    >>> audit.record("received", request_id="svc-3", clients=[7])
    >>> audit.verify()    # head hash; raises on tampering
    """

    def __init__(self, journal=None):
        self.journal = journal
        self.records: List[dict] = []
        self.head = GENESIS
        if journal is not None:
            self._splice()

    def _splice(self) -> None:
        """Adopt (and verify) the chain already in the journal — the resume
        path: a crashed run's audit history becomes this log's prefix."""
        self.records = journal_chain(self.journal)
        self.head = verify_chain(self.records)

    def record(self, kind: str, **fields) -> str:
        """Append one lifecycle event; returns the new head hash.  Callers
        pass deterministic fields only (ids, shards, virtual times)."""
        event = {"kind": kind, **fields}
        h = chain_hash(self.head, event)
        rec = {"event": event, "prev": self.head, "hash": h}
        self.records.append(rec)
        self.head = h
        if self.journal is not None:
            self.journal.append({"ev": "audit", **rec})
        return h

    def verify(self) -> str:
        """Re-verify the whole in-memory chain; returns the head hash."""
        head = verify_chain(self.records)
        if head != self.head:
            raise AuditChainError(
                f"head mismatch: chain verifies to {head[:12]}... but log "
                f"head is {self.head[:12]}...")
        return head

    def kinds(self) -> List[str]:
        return [r["event"]["kind"] for r in self.records]

    def events_of(self, request_id: str) -> List[dict]:
        """This request's lifecycle, in chain order."""
        return [r["event"] for r in self.records
                if r["event"].get("request_id") == request_id]

    def __len__(self) -> int:
        return len(self.records)

    def to_dict(self) -> dict:
        return {"head": self.head, "num_records": len(self.records),
                "kinds": self.kinds()}


def verify_journal(journal, genesis: str = GENESIS) -> Optional[str]:
    """End-to-end check of a journal's audit chain: extract, verify, return
    the head hash (``None`` when the journal holds no audit records)."""
    records = journal_chain(journal)
    if not records:
        return None
    return verify_chain(records, genesis=genesis)
