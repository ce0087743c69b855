"""Per-query tracing: spans, sampling, ring buffer, durable JSONL sink.

A ``QueryTrace`` is the life of one query through the serving stack as a
list of named spans (DESIGN.md §13 has the schema table):

    enqueue -> plan/bucket -> budget -> dispatch quanta -> shard merge
    -> retire

Spans carry wall-clock timestamps from the *injected* clock (the same one
the server and budgeter read — ``repro_torch.obs.clock``) plus free-form numeric
attributes: admission budget, device step time, quanta count, per-shard
exit reasons, fidelity bound. Device-step attribution rides in span attrs
(``device_ms``) because the device timeline is only observable from the
host at dispatch granularity.

``Tracer`` owns the policy:

  * **sampling** — ``sample_rate`` in [0, 1]; the decision is a
    deterministic hash of the query's rid (Knuth multiplicative), so a
    given rid samples identically across runs and across processes —
    nothing about tracing consults an RNG, which keeps instrumented runs
    bit-reproducible;
  * **bounded memory** — finished traces land in a ring buffer
    (``maxlen=ring``) so a long-lived server holds a sliding window, not
    an unbounded log;
  * **durability** — with a ``sink`` attached, every finished trace is
    appended to a JSONL file with the same torn-tail discipline as
    ``control/journal.py``: a crash mid-append leaves at most one torn
    final line, which readers skip and the next append truncates.
    Traces are higher-volume than topology records, so fsync is amortised
    (every ``fsync_every`` records and on ``close``) instead of per record
    — a lost tail of *recent* traces is acceptable where a lost topology
    record is not.
"""

from __future__ import annotations

import json
import os
from collections import deque

__all__ = ["Span", "QueryTrace", "TraceSink", "Tracer", "read_traces"]

_KNUTH = 2654435761  # Knuth's multiplicative hash constant (mod 2^32)


def sampled(rid: int, rate: float) -> bool:
    """Deterministic per-rid sampling decision (no RNG, run-stable)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((rid * _KNUTH) & 0xFFFFFFFF) / 2.0**32 < rate


class Span:
    """One named interval inside a trace."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict | None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "t0_ms": round(self.t0 * 1e3, 4),
            "dur_ms": round((self.t1 - self.t0) * 1e3, 4),
        }
        if self.attrs:
            d.update(self.attrs)
        return d


class QueryTrace:
    """Spans + attributes for one query, keyed by rid."""

    __slots__ = ("rid", "spans", "attrs")

    def __init__(self, rid: int):
        self.rid = rid
        self.spans: list[Span] = []
        self.attrs: dict = {}

    def span(self, name: str, t0: float, t1: float, **attrs) -> None:
        self.spans.append(Span(name, t0, t1, attrs or None))

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            **self.attrs,
            "spans": [s.to_dict() for s in self.spans],
        }


class TraceSink:
    """Append-only JSONL trace file with crash-tolerant appends.

    Same stance as ``control.journal.TopologyJournal``: before the first
    append the writer truncates a crash-torn final line (readers only ever
    skip it, but appending onto it would merge two records); every write is
    flushed, and fsync happens every ``fsync_every`` records and on
    ``close`` — traces trade per-record durability for throughput.
    """

    def __init__(self, path: str, fsync_every: int = 64):
        self.path = path
        self.fsync_every = max(1, int(fsync_every))
        self._since_sync = 0
        self._file = None
        self.written = 0

    def _open(self):
        if self._file is None:
            _repair_torn_tail(self.path)
            self._file = open(self.path, "a", encoding="utf-8")
        return self._file

    def append(self, record: dict) -> None:
        f = self._open()
        f.write(json.dumps(record, sort_keys=True) + "\n")
        f.flush()
        self.written += 1
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            os.fsync(f.fileno())
            self._since_sync = 0

    def close(self) -> None:
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._file = None
            self._since_sync = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _repair_torn_tail(path: str) -> None:
    try:
        with open(path, "r+b") as f:
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


def read_traces(path: str) -> list[dict]:
    """All committed trace records, oldest first; a torn tail is skipped.

    A malformed line anywhere *else* raises — half a trace file should not
    silently summarize as the whole story (mirrors journal semantics).
    """
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
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
                break  # torn tail from a crashed append
            raise ValueError(f"{path}: corrupt trace record {i}: {e}") from e
        out.append(rec)
    return out


class Tracer:
    """Sampling trace collector with a bounded ring and optional sink."""

    def __init__(
        self,
        sample_rate: float = 1.0,
        ring: int = 1024,
        sink: TraceSink | None = None,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate {sample_rate} not in [0, 1]")
        self.sample_rate = float(sample_rate)
        self.ring: deque = deque(maxlen=max(1, int(ring)))
        self.sink = sink
        self._live: dict[int, QueryTrace] = {}
        self.started = 0
        self.finished = 0
        self.dropped = 0  # rids not sampled

    def begin(self, rid: int) -> QueryTrace | None:
        """Open a trace for ``rid`` if sampled; None means 'not tracing'."""
        if not sampled(rid, self.sample_rate):
            self.dropped += 1
            return None
        tr = QueryTrace(rid)
        self._live[rid] = tr
        self.started += 1
        return tr

    def get(self, rid: int) -> QueryTrace | None:
        return self._live.get(rid)

    def end(self, rid: int) -> QueryTrace | None:
        """Finish ``rid``'s trace: ring-buffer it and append to the sink."""
        tr = self._live.pop(rid, None)
        if tr is None:
            return None
        self.ring.append(tr)
        self.finished += 1
        if self.sink is not None:
            self.sink.append(tr.to_dict())
        return tr

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
