"""Drive a server through a window: open-loop arrivals or a standing backlog.

The harness owns the clock. An open-loop query is timed from when it was
*due*, so a stall delays every query behind it and shows in their latencies;
the loop submits what is due, lets the server take one step, and waits for the
next arrival only when the server is idle. A backlog keeps the server's queue
at a fixed depth. After the window closes nothing more is submitted, and what
is in flight is served for at most ``drain_limit_s`` more; a query that still
has no answer then is unanswered.

With a ``Spans`` recorder (``--trace 1``) the loop also records host spans: a
server step, the wait for an arrival, the port's planning entry and an
in-flight admission, each wrapped from here on the server object, as
``chip_smoke.py`` wraps the port's functions.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np

__all__ = ["Spans", "Window", "drive_backlog", "drive_open_loop", "wrap_server"]

clock = time.perf_counter


class Spans:
    """Host spans by name (seconds on ``time.perf_counter``) and counts."""

    def __init__(self):
        self.spans: dict[str, list] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)
        self.marks: dict = {}

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans[name].append((t0, t1))

    def arrays(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        a = np.asarray(self.spans.get(name, []), np.float64).reshape(-1, 2)
        return a[:, 0], a[:, 1]

    def total_s(self, name: str) -> float:
        s, e = self.arrays(name)
        return float((e - s).sum())


@dataclasses.dataclass
class Window:
    """What one window served: per query of the window (submission order)."""

    t0: float  # window start on ``clock``
    seconds: float
    due: np.ndarray | None  # [n] s from t0 (open loop)
    qidx: np.ndarray  # [n] pool rows
    submit: np.ndarray  # [n] s from t0
    done: np.ndarray  # [n] s from t0, nan: unanswered
    results: list  # [n] served results (None: unanswered)
    rids: np.ndarray  # [n] the server's request ids
    end: float = 0.0  # s from t0 when the drain ended
    lag_s: float = 0.0  # largest submission delay after the due time
    max_step_s: float = 0.0  # the longest server step


def wrap_server(server, bengine, spans: Spans, sync=None):
    """Record planning, admissions and micro-batch dispatches into ``spans``:
    instance attributes that shadow the methods the servers call, and the
    batch engine's module-level launch for the device wait. ``sync`` (the
    card's synchronize) ends a launch's wait; returns the undo."""
    from repro_torch.serving import batch_engine

    plan, plan_many = bengine.plan, bengine.plan_many

    def timed_plan(q):
        t0 = clock()
        out = plan(q)
        spans.add("plan", t0, clock())
        spans.counts["planned"] += 1
        return out

    def timed_plan_many(qs):
        t0 = clock()
        out = plan_many(qs)
        spans.add("plan", t0, clock())
        spans.counts["planned"] += len(qs)
        return out

    bengine.plan, bengine.plan_many = timed_plan, timed_plan_many
    if hasattr(server, "_admit"):
        admit = server._admit
        admitted = spans.marks.setdefault("admitted", {})

        def timed_admit(lane, rid, plan, t_enq):
            admitted[rid] = clock()
            return admit(lane, rid, plan, t_enq)

        server._admit = timed_admit
        return lambda: None

    # Micro-batches: a dispatch is run_batch's host time less the waits for
    # its launches, which end at a synchronize.
    run_batch, launch = bengine.run_batch, batch_engine.traverse_lanes

    def timed_run_batch(*a, **kw):
        t0 = clock()
        out = run_batch(*a, **kw)
        spans.add("dispatch", t0, clock())
        return out

    def timed_launch(*a, **kw):
        out = launch(*a, **kw)
        t1 = clock()
        if sync is not None:
            sync()
        spans.add("device_wait", t1, clock())
        spans.counts["launches"] += 1
        return out

    bengine.run_batch, batch_engine.traverse_lanes = timed_run_batch, timed_launch

    def undo():
        batch_engine.traverse_lanes = launch

    return undo


def _record(win: Window, rid_to_j: dict, served, t: float) -> None:
    for sq in served:
        j = rid_to_j.pop(sq.rid, None)
        if j is not None:
            win.done[j] = t
            win.results[j] = sq.result


def _new_window(t0, seconds, due, qidx) -> Window:
    n = qidx.shape[0]
    return Window(t0=t0, seconds=seconds, due=due, qidx=qidx, submit=np.full(n, np.nan),
                  done=np.full(n, np.nan), results=[None] * n, rids=np.full(n, -1, np.int64))


def drive_open_loop(server, pool_terms, due, qidx, seconds: float,
                    drain_limit_s: float = 60.0, spans: Spans | None = None) -> Window:
    """Submit query j at ``due[j]`` s after the start, step the server
    whenever it holds work, and serve what is left after the window."""
    t0 = clock()
    win = _new_window(t0, seconds, due, qidx)
    n, j, rid_to_j = qidx.shape[0], 0, {}
    busy = lambda: server.pending or server.active  # noqa: E731
    while True:
        now = clock() - t0
        while j < n and due[j] <= now:
            rid = server.submit(pool_terms[qidx[j]])
            rid_to_j[rid] = j
            win.submit[j], win.rids[j] = now, rid
            j += 1
        if busy():
            s0 = clock()
            served = server.step()
            s1 = clock()
            win.max_step_s = max(win.max_step_s, s1 - s0)
            if spans is not None:
                spans.add("step", s0, s1)
            _record(win, rid_to_j, served, s1 - t0)
        elif j >= n:
            break
        else:
            s0 = clock()
            gap = due[j] - (s0 - t0)
            if gap > 2e-3:
                time.sleep(gap - 1e-3)
            while clock() - t0 < due[j]:
                pass
            if spans is not None:
                spans.add("wait", s0, clock())
        if now > seconds + drain_limit_s:
            break
    win.end = clock() - t0
    win.lag_s = float(np.nanmax(win.submit - due)) if n else 0.0
    return win


def drive_backlog(server, pool_terms, order, seconds: float, depth: int,
                  drain_limit_s: float = 60.0, spans: Spans | None = None) -> Window:
    """Keep ``depth`` queries queued for ``seconds``, serving a micro-batch
    at a time, then serve what is queued. ``order`` (pool rows) is cycled."""
    t0 = clock()
    sub, qs, rids, rid_to_j = [], [], [], {}
    done, results = {}, {}
    j, max_step = 0, 0.0
    while True:
        now = clock() - t0
        if now < seconds:
            while server.pending < depth:
                q = int(order[j % order.shape[0]])
                rid = server.submit(pool_terms[q])
                rid_to_j[rid] = j
                rids.append(rid)
                sub.append(now)
                qs.append(q)
                j += 1
        if not server.pending or now > seconds + drain_limit_s:
            break
        s0 = clock()
        served = server.drain_once()
        s1 = clock()
        max_step = max(max_step, s1 - s0)
        if spans is not None:
            spans.add("step", s0, s1)
        for sq in served:
            i = rid_to_j.pop(sq.rid, None)
            if i is not None:
                done[i], results[i] = s1 - t0, sq.result
    win = _new_window(t0, seconds, None, np.asarray(qs, np.int64))
    win.submit[:] = sub
    win.rids[:] = rids
    for i, t in done.items():
        win.done[i], win.results[i] = t, results[i]
    win.end = clock() - t0
    win.max_step_s = max_step
    return win
