"""Crash-safe job journal: the durable half of the CheckerService.

Counterpart of ``stateright_tpu/service/journal.py``, with the same
records, digests and rotations: a journal written by either package replays
in the other (``tests/test_torch_service_journal.py``). It is the
append-only record the service replays on restart, one JSONL line per
typed job event:

- **self-verifying appends** -- every record embeds a SHA-256 over its own
  canonical serialization (``sha256`` field, digest computed with the
  field absent). A crash mid-append leaves a torn last line that fails
  JSON parse or digest; :func:`read_journal` reports it as a typed,
  recoverable condition (the record is dropped, everything before it
  replays).
- **keep-K snapshot compaction** -- :meth:`Journal.compact` rewrites the
  log as ONE ``snapshot`` record of the service's state (same-directory
  temp + ``os.replace``), rotating the previous log to ``<path>.1`` ...
  ``<path>.K-1`` as checkpoints rotate. Recovery always compacts, which
  also amputates a torn tail: appends never land after torn bytes.

Record shape (one JSON object per line)::

    {"v": 1, "seq": N, "ts": <unix>, "event": "<type>", ...payload,
     "sha256": <hex over the record without this field>}

Event types and their payloads are the service's (``service/core.py``
``_jlog``/``_snapshot_payload``): ``submitted`` / ``admitted`` /
``started`` / ``checkpointed`` / ``budget_charged`` / ``quarantined`` /
``completed`` / ``breaker_tripped`` / ``breaker_closed`` / ``snapshot`` /
``recovered`` (and the reference fleet's ``evacuated``, which replay
honours).

Fault injection (``chaos.py``): the writer honours ``journal.torn`` (append
the first ``at`` bytes, then SIGKILL) and ``journal.die`` (append fully,
then SIGKILL). Both are no-ops unless an ``STPU_CHAOS`` plan names them.

Everything here is stdlib; importing it imports no torch.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import chaos

FORMAT_VERSION = 1


class JournalTorn(Exception):
    """A journal whose tail (or a mid-file record) cannot be trusted.
    Raised only by ``read_journal(strict=True)``; the default replay path
    returns the torn reason alongside the clean prefix instead — torn is
    a *recoverable condition* for a restarting service, not an error."""


@dataclass
class JournalReplay:
    """``read_journal``'s result: the verified records in order, plus the
    torn-tail description (None when the file read clean)."""

    path: str
    records: List[Dict[str, Any]] = field(default_factory=list)
    torn: Optional[str] = None


def _digest(record: Dict[str, Any]) -> str:
    """SHA-256 over the record's canonical JSON, ``sha256`` field absent
    — recomputed on read, like checkpoint.py's payload digest."""
    body = {k: v for k, v in record.items() if k != "sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


class Journal:
    """Writer side. All appends happen under the owning service's lock —
    this class adds durability discipline, not thread coordination. The
    file handle opens lazily (service construction stays cheap) and in
    append mode (a restart that chose not to compact keeps history)."""

    def __init__(self, path: str, *, keep: int = 3,
                 compact_every: int = 256):
        if keep < 1:
            raise ValueError(f"journal keep must be >= 1, got {keep}")
        if compact_every < 2:
            raise ValueError(
                f"journal compact_every must be >= 2, got {compact_every}"
            )
        self.path = path
        self.keep = keep
        self.compact_every = compact_every
        self.seq = 0
        #: Appends since the last compaction (compaction is the SERVICE's
        #: call — it owns the snapshot payload; the journal only reports
        #: when one is due).
        self.since_compact = 0
        self._fh = None
        #: A torn-append injection simulates a crash; if the process
        #: somehow survives (tests driving the writer directly), the
        #: writer plays dead — a real crashed writer appends nothing
        #: more, and bytes after a torn tail would corrupt mid-file.
        self._dead = False

    # -- append ------------------------------------------------------------

    def _handle(self):
        if self._fh is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def append(self, event: str, *, ts: float, **payload: Any) -> Optional[dict]:
        """One durable record; returns it (None from a dead writer).
        ``ts`` is wall-clock (recovery charges budgets from these)."""
        if self._dead:
            return None
        self.seq += 1
        record: Dict[str, Any] = {
            "v": FORMAT_VERSION, "seq": self.seq, "ts": ts, "event": event,
        }
        record.update(payload)
        record["sha256"] = _digest(record)
        data = json.dumps(record, sort_keys=True, separators=(",", ":")) + "\n"
        fh = self._handle()
        inj = chaos.fire("journal.torn", size=len(data))
        if inj is not None:
            # Crash mid-append: some prefix of the record reaches disk,
            # then the process dies (chaos.py).
            fh.write(data[: max(1, min(int(inj.get("at", 1)), len(data) - 1))])
            fh.flush()
            chaos.kill_self()
            self._dead = True  # pragma: no cover - unreachable after kill
            return None  # pragma: no cover
        fh.write(data)
        fh.flush()
        if chaos.fire("journal.die") is not None:
            # Crash AT a deterministic journal position: the record is
            # durable, nothing after it happens.
            chaos.kill_self()
        self.since_compact += 1
        return record

    @property
    def compaction_due(self) -> bool:
        return self.since_compact >= self.compact_every

    # -- compaction --------------------------------------------------------

    def compact(self, snapshot: Dict[str, Any], *, ts: float) -> dict:
        """Atomically rewrite the log as one ``snapshot`` record (payload
        = the service's full recoverable state), rotating the previous
        log to ``<path>.1``.. like checkpoint rotations. A kill anywhere
        inside leaves either the old log or the new one — never a mix."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self.seq += 1
        record: Dict[str, Any] = {
            "v": FORMAT_VERSION, "seq": self.seq, "ts": ts,
            "event": "snapshot", "state": snapshot,
        }
        record["sha256"] = _digest(record)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(
                json.dumps(record, sort_keys=True, separators=(",", ":"))
                + "\n"
            )
        if self.keep > 1 and os.path.exists(self.path):
            for i in range(self.keep - 1, 1, -1):
                older = f"{self.path}.{i - 1}"
                if os.path.exists(older):
                    os.replace(older, f"{self.path}.{i}")
            os.replace(self.path, f"{self.path}.1")
        os.replace(tmp, self.path)
        self.since_compact = 0
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_journal(path: str, *, strict: bool = False) -> JournalReplay:
    """Replay side: every record that parses AND verifies, in order,
    stopping at the first one that does not (a torn tail from a crash
    mid-append — or, defensively, a tampered mid-file record; nothing
    after an untrusted record can be ordered against it). The torn
    description rides back on the result; ``strict=True`` raises
    :class:`JournalTorn` instead. A missing file stays
    ``FileNotFoundError`` — "no journal yet" and "journal destroyed" are
    different verdicts to a supervisor, exactly like checkpoints."""
    out = JournalReplay(path=path)
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            reason = None
            try:
                record = json.loads(line)
            except json.JSONDecodeError as e:
                reason = f"line {i}: unparseable ({e.msg})"
            else:
                if not isinstance(record, dict):
                    reason = f"line {i}: not a record object"
                elif record.get("sha256") != _digest(record):
                    reason = f"line {i}: record digest mismatch — torn or tampered"
                elif record.get("v") != FORMAT_VERSION:
                    reason = (
                        f"line {i}: unsupported journal format {record.get('v')!r}"
                    )
            if reason is not None:
                out.torn = reason
                if strict:
                    raise JournalTorn(f"{path}: {reason}")
                break
            out.records.append(record)
    return out
