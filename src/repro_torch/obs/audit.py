"""Append-only, SHA-256 hash-chained security audit log.

The paper-side schemes make *data* tampering detectable; this module
is the software analogue for the *event record*: every
security-relevant action in the serving stack (integrity verdicts and
failures, key rotations, eager reseals, secure migrations, prefix
cache inserts / cross-tenant shares, copy-on-write privatizations) is
appended as a record whose hash covers both its own canonical JSON
payload and the previous record's hash.  Truncating, reordering,
editing, or injecting records therefore breaks
:meth:`AuditLog.verify_chain` — tampering with the log is itself
detectable, in the GuardNN/SEALing minimal-trust-verification sense.

Records are plain dicts (JSON-able by construction); the chain hash is
computed over the canonical serialization (sorted keys, no
whitespace), so a log round-tripped through JSON still verifies.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Optional

__all__ = ["AuditLog"]

GENESIS = "0" * 64


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


class AuditLog:
    """Hash-chained, append-only event log.

    ``append`` stamps each record with a sequence number, a UTC
    timestamp, the previous record's hash, and its own chain hash;
    ``verify_chain`` recomputes the whole chain and fails on any
    mutation.  ``records`` returns deep-ish copies so callers cannot
    accidentally corrupt the chain (tests tamper via the ``_records``
    internals on purpose).
    """

    def __init__(self):
        self._records: list = []

    def __len__(self) -> int:
        return len(self._records)

    @property
    def head(self) -> str:
        """The chain head hash (GENESIS when empty)."""
        return self._records[-1]["hash"] if self._records else GENESIS

    def append(self, event: str, **fields) -> dict:
        """Append one event; returns the sealed record."""
        payload = {"seq": len(self._records), "event": str(event),
                   "ts": time.time(), "prev": self.head}
        for k, v in fields.items():
            if k in payload or k == "hash":
                raise ValueError(f"audit field {k!r} is reserved")
            payload[k] = v
        record = dict(payload)
        record["hash"] = hashlib.sha256(_canonical(payload)).hexdigest()
        self._records.append(record)
        return dict(record)

    def records(self) -> list:
        return [dict(r) for r in self._records]

    def verify_chain(self) -> bool:
        """True iff every record's hash and back-link still hold."""
        prev = GENESIS
        for i, record in enumerate(self._records):
            payload = {k: v for k, v in record.items() if k != "hash"}
            if payload.get("seq") != i or payload.get("prev") != prev:
                return False
            if record.get("hash") != \
                    hashlib.sha256(_canonical(payload)).hexdigest():
                return False
            prev = record["hash"]
        return True

    def events(self, event: Optional[str] = None) -> list:
        """Records filtered by event type (all when ``None``)."""
        return [dict(r) for r in self._records
                if event is None or r["event"] == event]

    def dump(self, path: str) -> None:
        """Write the log as JSON lines (one record per line)."""
        with open(path, "w") as f:
            for record in self._records:
                f.write(json.dumps(record, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str) -> "AuditLog":
        """Load a dumped log (callers should ``verify_chain`` it)."""
        log = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    log._records.append(json.loads(line))
        return log
