"""Write-ahead journal of session/service events.

An append-only, per-line-checksummed JSONL file: each record is
``<crc32 hex> <json {"seq": n, "ev": {...}}>``, fsynced on append so a
committed record survives a process kill.  ``replay`` tolerates a torn
tail — the one partially-written record a crash mid-append can leave —
by stopping at the first line that fails its checksum or fails to parse;
everything before it is trusted (each line carries its own crc).

Sequence numbers continue across reopens, so a resumed session appends to
the same journal and replay yields one totally-ordered event history.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional


def replay(path: str) -> List[dict]:
    """Parse the journal at ``path`` into ``[{"seq": n, "ev": {...}}, ...]``,
    stopping at the first corrupt or truncated record (torn tail)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "rb") as f:
        data = f.read()
    for raw in data.split(b"\n"):
        if not raw:
            continue
        try:
            crc_hex, rec = raw.split(b" ", 1)
            if int(crc_hex, 16) != zlib.crc32(rec):
                break
            row = json.loads(rec)
        except ValueError:
            break
        out.append(row)
    return out


class Journal:
    """Append-only write-ahead log.  ``append`` is durable (fsync per
    record); ``events`` replays the on-disk history (prior runs included)."""

    def __init__(self, path: str):
        self.path = path
        existing = replay(path)
        self._seq = existing[-1]["seq"] + 1 if existing else 0
        self._f: Optional[object] = None

    def append(self, event: dict) -> int:
        """Durably append one event; returns its sequence number."""
        rec = json.dumps({"seq": self._seq, "ev": event}, sort_keys=True)
        if self._f is None:
            self._f = open(self.path, "a")
        from repro_torch.telemetry import get_tracer
        tr = get_tracer()
        with tr.span("durability.journal_append",
                     kind=str(event.get("ev", "?"))[:24]):
            self._f.write(f"{zlib.crc32(rec.encode()):08x} {rec}\n")
            self._f.flush()
            os.fsync(self._f.fileno())
        tr.metrics.counter("durability.journal_appends").inc()
        seq, self._seq = self._seq, self._seq + 1
        return seq

    def events(self) -> List[dict]:
        """The full replayed event history (``ev`` payloads, in order)."""
        return [row["ev"] for row in replay(self.path)]

    def records(self) -> List[dict]:
        """Replayed records including sequence numbers."""
        return replay(self.path)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
