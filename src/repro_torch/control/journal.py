"""Replayable topology journal (DESIGN.md §10).

The control plane's topology state — reshard commits and health
transitions — used to live only in process memory: a broker restart lost
the journaled layout and the ledger. ``TopologyJournal`` persists that
state as an append-only ``journal.jsonl`` *inside the index artifact the
plane serves from*, so the topology travels with the index it describes.

Record schema (one JSON object per line):

    {"seq": N, "fingerprint": "<index fp>", "kind": "reshard",
     "cuts": [0, ...], "reason": "planner" | "operator"}
    {"seq": N, "fingerprint": "<index fp>", "kind": "health",
     "event": "down" | "up", "shard": S, "replica": R | null}

Every record is stamped with the fingerprint of the live (materialized)
index, so replay can refuse a journal that belongs to a different index —
the same staleness stance ``ShardedEngine.from_artifact`` takes for shard
artifacts. Appends are flushed and fsynced per record; a torn final line
from a crash mid-append is ignored on read (the record it described never
committed anywhere else either, so dropping it is consistent).

``ControlPlane.from_artifact(path, ..., replay=True)`` reads the journal
back and reconstructs the cuts + ledger state across a process boundary.
"""

from __future__ import annotations

import json
import os

__all__ = ["JOURNAL_NAME", "TopologyJournal"]

JOURNAL_NAME = "journal.jsonl"


class TopologyJournal:
    """Append-only JSONL journal with crash-tolerant reads."""

    def __init__(self, path: str):
        self.path = path
        # Cached next sequence number: the journal is appended by exactly
        # one process, so after the first read every append is O(1) instead
        # of re-parsing the whole file.
        self._next_seq: int | None = None
        self._tail_repaired = False

    def __repr__(self) -> str:  # pragma: no cover — debugging nicety
        return f"TopologyJournal({self.path!r})"

    @property
    def exists(self) -> bool:
        return os.path.exists(self.path)

    def next_seq(self) -> int:
        if self._next_seq is None:
            records = self.records()
            self._next_seq = records[-1]["seq"] + 1 if records else 0
        return self._next_seq

    def _repair_torn_tail(self) -> None:
        """Truncate a crash-torn final line before the first append.

        ``records()`` merely *skips* a torn tail, but an append must not
        concatenate onto it (the merged line would corrupt the journal or
        silently swallow the new record). The torn fragment was never
        committed, so truncating it is consistent with what readers saw.
        Checked once per process: this writer always leaves a trailing
        newline behind.
        """
        if self._tail_repaired:
            return
        self._tail_repaired = True
        try:
            with open(self.path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(size - 1)
                if f.read(1) == b"\n":
                    return
                f.seek(0)
                data = f.read()
                f.truncate(data.rfind(b"\n") + 1)
        except FileNotFoundError:
            return

    def append(self, record: dict) -> dict:
        """Durably append one record; fills in ``seq``, returns the record.

        The parent directory must exist (the journal lives inside a
        published artifact directory).
        """
        self._repair_torn_tail()
        record = dict(record)
        record.setdefault("seq", self.next_seq())
        line = json.dumps(record, sort_keys=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._next_seq = int(record["seq"]) + 1
        return record

    def records(self) -> list[dict]:
        """All committed records, oldest first.

        A torn final line (crash mid-append) is skipped; a torn or foreign
        line anywhere *else* means the file is not our journal and raises
        ``ValueError`` rather than silently replaying half a history.
        """
        if not os.path.exists(self.path):
            return []
        with open(self.path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        out: list[dict] = []
        for i, line in enumerate(lines):
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise ValueError(f"record {i} is not an object")
            except ValueError as e:
                if i == len(lines) - 1:
                    break  # torn tail from a crashed append — never committed
                raise ValueError(
                    f"{self.path}: corrupt journal record {i}: {e}"
                ) from e
            out.append(rec)
        return out
