"""The ``gov2-4r.safe-k10`` cell's shape at a tiny size on the CPU: the
``tiny`` configuration (8-bit impacts in int8, int32 docids, 4 ranges, k 10)
under micro-batch backlog traffic with no budget, so every query runs safe to
its exact top-10 over its ranges in BoundSum order; and the reader of
``traverse_us_per_range.qps``."""

from __future__ import annotations

import json
import os
import time

import pytest

from anytime_bench import harness
from anytime_bench.harness import Context, _reader, run_cell
from anytime_bench.tests.tiny import CONFIGS, POOL, tiny_bench
from anytime_bench.yardstick import DeviceTimeline

CELL = "tiny.safe-k10"
TRAFFIC = dict(server="microbatch", batch=8, sla_ms=None, k=10,
               arrivals={"process": "backlog", "depth": 16}, warmup_s=0.3, pool=POOL)
READER = "traverse_us_per_range.qps"


def _bench(root: str) -> dict:
    """The tiny benchmark with this cell beside its own, reporting what the
    real cell reports."""
    bench = tiny_bench(root)
    with open(os.path.join(root, "traffic", f"{CELL}.json"), "w") as f:
        json.dump(TRAFFIC, f)
    bench["workloads"].append(dict(name=CELL, config="tiny", traffic="safe-k10", chips=1))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("qps", "plan_ms.qps", "dispatch_ms.qps"):
            m["workloads"].append(CELL)
    for name, unit in (("traverse_roofline.qps", "%"), ("idle_share.qps", "%"), (READER, "us")):
        bench["per_layer"].append(dict(name=name, unit=unit, workloads=[CELL]))
    return bench


def _run(root: str, trace: bool, seed: int):
    """One run of the cell: (result, checks, the run's ``Context``)."""
    seen = []

    class Recorded(Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "Context", Recorded)
        result, checks = run_cell(_bench(root), CELL, seed, 1.5, trace, root=root,
                                  t_start=time.perf_counter(), device="cpu",
                                  cache_dir=os.path.join(root, "cache"),
                                  traffic_dir=os.path.join(root, "traffic"), workers=1,
                                  drain_limit_s=2.0)
    return result, checks, seen[0]


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    return _run(str(tmp_path_factory.mktemp("safe_k10")), False, 2**31 + 29)


def _served(ctx):
    return [r for r in ctx.window.results if r is not None]


def test_a_run_is_correct_and_scores_several_ranges(untraced):
    result, checks, ctx = untraced
    assert result["correct"] is True and result["failed"] == 0
    assert all(v == 0 for v, _ in checks.values())
    assert set(result["metrics"]) == {"setup_s", "qps"}
    served = _served(ctx)
    assert served and all(not r.exit_budget for r in served)
    assert max(int(r.ranges_processed) for r in served) > 1


def test_a_query_stops_safe_before_its_last_range(untraced):
    """The range loop's safe stop skips ranges that are left: some query
    exits safe with fewer than R ranges scored."""
    _, _, ctx = untraced
    R = CONFIGS["tiny"]["n_ranges"]
    early = [r for r in _served(ctx) if r.exit_safe and int(r.ranges_processed) < R]
    assert early and all(int(r.ranges_processed) >= 1 for r in early)


def test_reader_is_none_without_a_timeline(tmp_path):
    """A traced run on the CPU has no device timeline: the device metrics are
    left out of its line, the host ones read."""
    result, _, ctx = _run(str(tmp_path), True, 7)
    assert ctx.timeline is None and _reader(READER)(ctx) is None
    assert set(result["metrics"]) == {"plan_ms.qps", "dispatch_ms.qps"}


def test_reader_by_hand():
    """2.5 ms of ``traverse_kernel`` over 1 + 3 + 4 ranges is 312.5 µs a
    range; other operations and unanswered queries count for nothing."""
    served = lambda n: type("R", (), dict(ranges_processed=n))  # noqa: E731
    ops = [("void traverse_kernel<false, true, false, true>", 0.010, 0.011),
           ("Memcpy HtoD (Pageable -> Device)", 0.011, 0.0115),
           ("void traverse_kernel<false, true, false, true>", 0.012, 0.0135)]
    tl = DeviceTimeline(ops, marker_s=0.0, marker_host_s=100.0, end_host_s=101.0)
    win = type("W", (), dict(results=[served(1), None, served(3), served(4)]))
    assert _reader(READER)(Context(window=win, timeline=tl)) == pytest.approx(312.5)
    idle = type("W", (), dict(results=[None, served(0)]))
    assert _reader(READER)(Context(window=idle, timeline=tl)) is None
    assert _reader(READER)(Context(window=win, timeline=None)) is None
    empty = DeviceTimeline([], 0.0, 100.0, 101.0)
    assert _reader(READER)(Context(window=win, timeline=empty)) is None
