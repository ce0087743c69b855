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

``SpanLog`` is the process's side of the same clock: the spans of the
serving loop itself (a micro-batch drain, the launches and host work
inside it, an index load) and counts by name, for laying host work on a
device trace taken over the same window.
"""

from __future__ import annotations

import json
import os
from collections import deque

__all__ = ["Span", "QueryTrace", "SpanLog", "TraceSink", "Tracer", "read_traces"]

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


class SpanLog:
    """Spans of the process and counts by name, held in memory.

    A span has a name, a start and an end on the injected clock, its parent
    (the span open when it was recorded, which caused it) and its root (the
    outermost span open then: the drain or load it belongs to; a root
    is its own). Sites stamp the times themselves from ``obs.clock``, so the
    log reads no clock. ``open``/``close`` bracket a span that has children;
    ``add`` records a finished one under the span that is open. A span that
    an exception leaves open keeps no end and stays the parent of what comes
    after it until the span around it closes. Names are interned and the columns are append-only lists, so a
    span costs a few appends; nothing is written until ``records()``.
    """

    def __init__(self):
        self.names: list[str] = []  # name id -> name
        self._ids: dict[str, int] = {}
        self._name: list[int] = []
        self._t0: list[float] = []
        self._t1: list[float | None] = []
        self._parent: list[int] = []  # -1: none
        self._root: list[int] = []
        self._open: list[int] = []
        self.counts: dict[str, int] = {}

    def _append(self, name: str, t0: float, t1: float | None) -> int:
        nid = self._ids.get(name)
        if nid is None:
            nid = self._ids[name] = len(self.names)
            self.names.append(name)
        i = len(self._t0)
        stack = self._open
        self._name.append(nid)
        self._t0.append(t0)
        self._t1.append(t1)
        self._parent.append(stack[-1] if stack else -1)
        self._root.append(stack[0] if stack else i)
        return i

    def open(self, name: str, t0: float) -> int:
        """Start a span whose children follow; returns its index."""
        i = self._append(name, t0, None)
        self._open.append(i)
        return i

    def close(self, i: int, t1: float) -> None:
        """End span ``i`` (and forget any span opened after it)."""
        self._t1[i] = t1
        del self._open[self._open.index(i):]

    def add(self, name: str, t0: float, t1: float) -> int:
        """Record a finished span under the open one; returns its index."""
        return self._append(name, t0, t1)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    # ------------------------------------------------------------- reading
    def _select(self, name: str | None, parent: str | None) -> list[int]:
        nid = self._ids.get(name) if name is not None else None
        pid = self._ids.get(parent) if parent is not None else None
        if (name is not None and nid is None) or (parent is not None and pid is None):
            return []
        out = []
        for i, (n, p, t1) in enumerate(zip(self._name, self._parent, self._t1)):
            if t1 is None or (nid is not None and n != nid):
                continue
            if pid is not None and (p < 0 or self._name[p] != pid):
                continue
            out.append(i)
        return out

    def intervals(self, name: str | None = None, parent: str | None = None):
        """(starts, ends) of the finished spans named ``name`` (any name when
        None) whose parent is named ``parent`` (any parent when None)."""
        sel = self._select(name, parent)
        return [self._t0[i] for i in sel], [self._t1[i] for i in sel]

    def records(self) -> list[dict]:
        """Every span as a JSON-able dict, in the order recorded: ``name``,
        ``t0``, ``t1`` (None while open), ``parent`` (an index, None for a
        root) and ``root``."""
        names = self.names
        return [
            {"name": names[n], "t0": t0, "t1": t1,
             "parent": p if p >= 0 else None, "root": r}
            for n, t0, t1, p, r in zip(self._name, self._t0, self._t1,
                                       self._parent, self._root)
        ]

    def trim(self, t: float, keep=()) -> None:
        """Drop what came before ``t``: every span whose root started before
        it (but roots named in ``keep``) and every count. A serving window
        drops its warm-up this way and keeps the set-up that it follows.
        Indices change, so no span may be open."""
        if self._open:
            raise ValueError(f"{len(self._open)} span(s) still open")
        keep_ids = {self._ids[n] for n in keep if n in self._ids}
        roots = {r for r in set(self._root)
                 if self._t0[r] >= t or self._name[r] in keep_ids}
        kept = [i for i, r in enumerate(self._root) if r in roots]
        new = {old: j for j, old in enumerate(kept)}
        self._name = [self._name[i] for i in kept]
        self._t0 = [self._t0[i] for i in kept]
        self._t1 = [self._t1[i] for i in kept]
        self._parent = [new[self._parent[i]] if self._parent[i] >= 0 else -1
                        for i in kept]
        self._root = [new[self._root[i]] for i in kept]
        self.counts = {}
