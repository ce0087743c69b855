"""One run of one cell: set up the port, drive the window, judge, read metrics.

``run_cell`` is the whole run behind ``run.py``; the tests drive it on the
CPU at a tiny size with the kernels' plain versions. What belongs to one
configuration, traffic or metric lives in files of its own, found by the names
in ``BENCHMARK.json``: ``configs/<config>.json`` (through the workload's
``file``), ``traffic/<workload>.json`` and ``metrics/<metric>.py``, a reader
with ``read(ctx) -> float | None`` over a ``Context``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

from anytime_bench import drive, traffic as traffic_mod
from anytime_bench.collection import Collection
from anytime_bench.reference.judge import LIMITS, judge

__all__ = ["BENCH_DIR", "Context", "FORBIDDEN", "load_cell", "run_cell"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(bench: dict, workload: str, root: str,
              traffic_dir: str | None = None) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of ``workload``; the
    configuration's ``file`` is relative to ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"workload {workload!r} not in {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(traffic_dir or os.path.join(BENCH_DIR, "traffic"),
                           f"{workload}.json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def _metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def _reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"anytime_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a metric reader may read about one run.

    ``window`` (``drive.Window``), ``setup_s``, ``latency_ms`` (from due to
    answer, inf if none; open loop only), ``traj`` (the reference's
    trajectories of the pool),
    ``bytes_needed`` (the byte model summed over the window's answered
    queries), and in a traced run ``spans`` (``drive.Spans``) and
    ``timeline`` (``yardstick.DeviceTimeline``, or None without a card).
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _bytes_needed(win, traj: dict, k: int) -> int:
    """Bytes the answered queries' traversals need by the byte model: each
    scored range's step, its order entry and range start, each exit decision's
    bound, and one carry in and out with the two caps per query (the carry
    width of the kernels: 2k + 5 int32)."""
    R = traj["bound"].shape[1]
    total = 0
    for p, res in zip(win.qidx, win.results):
        if res is None:
            continue
        n = int(res.ranges_processed)
        decisions = n + (1 if n < R else 0)
        total += (2 * (2 * k + 5) * 4 + 8 + 4 * decisions + 8 * n
                  + int(traj["bytes"][p, :n].sum()))
    return total


def _make_server(traffic: dict, bengine):
    from repro_torch.core.anytime import Reactive
    from repro_torch.serving import InflightServer, MicroBatchServer, SlaBudgeter

    sla = traffic.get("sla_ms")
    policy = Reactive(**traffic["policy"]) if "policy" in traffic else Reactive()
    budgeter = SlaBudgeter(sla_ms=float("inf") if sla is None else float(sla), policy=policy)
    if traffic["server"] == "inflight":
        return InflightServer(bengine, budgeter, n_slots=traffic["slots"],
                              quantum=traffic["quantum"])
    if traffic["server"] == "microbatch":
        return MicroBatchServer(bengine, budgeter, max_batch=traffic["batch"])
    raise ValueError(f"server {traffic['server']!r} not in ('inflight', 'microbatch')")


def _drive(server, traffic, terms, stream, seconds, drain_limit_s, spans=None):
    arr = traffic["arrivals"]
    if arr["process"] == "backlog":
        return drive.drive_backlog(server, terms, stream.qidx, seconds, int(arr["depth"]),
                                   drain_limit_s, spans)
    return drive.drive_open_loop(server, terms, stream.due, stream.qidx, seconds,
                                 drain_limit_s, spans)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may hold, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             root: str, t_start: float, device: str = "cuda", cache_dir: str | None = None,
             traffic_dir: str | None = None, drain_limit_s: float = 60.0, workers: int = 6,
             program_cfg: dict | None = None, log=None) -> tuple[dict, dict]:
    """One run: (the result line's object, the checks {name: (value, limit)}).

    ``program_cfg`` replaces keys of the configuration for the program's
    index only (the control: the port's own lower-precision impacts); the
    reference always follows the configuration as stated.
    """
    import torch

    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BatchEngine, BucketSpec

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, cfg, traffic = load_cell(bench, workload, root, traffic_dir)
    k = int(traffic.get("k") or cfg["k"])
    on_card = torch.device(device).type == "cuda"
    coll = Collection(cfg, cache_dir, workers)
    prog = Collection({**cfg, **program_cfg}, cache_dir, workers) if program_cfg else coll
    # The first run in a checkout builds the collection, the index and the
    # pool, as a deployment builds its index offline: that build is logged
    # apart and left out of setup_s, which counts from the process's start to
    # the window's first query what every restart pays.
    t_build = time.perf_counter()
    built = coll.prepare(traffic["pool"], artifact=prog is coll)
    if prog is not coll:
        built = prog.prepare(None)
    build_s = time.perf_counter() - t_build if built else 0.0
    if built:
        log(f"first build of {prog.cfg['name']} in {build_s:.3f} s (not in setup_s): "
            + json.dumps(prog.build_seconds()))
    terms, widths = coll.pool(traffic["pool"])

    engine = Engine.from_artifact(prog.artifact, k=k, device=device)
    # One host thread for the port's CPU work from here on: a serving
    # process shares its host, and a pool of threads spinning beside the
    # planning loop makes the host's speed swing from run to run.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lanes = traffic.get("slots") or traffic.get("batch")
    bengine = BatchEngine(engine, BucketSpec(max_batch=lanes))
    server = _make_server(traffic, bengine)
    arr = traffic["arrivals"]

    # Warm-up: the widest query first (the staged tables reach their widest
    # shape), then the cell's own traffic from an independent stream. Its
    # answers are judged with the window's.
    warm = traffic_mod.make_stream(arr, seed, float(traffic["warmup_s"]), terms.shape[0],
                                   stream=1)
    warm = traffic_mod.Stream(due=None if warm.due is None else np.r_[0.0, warm.due],
                              qidx=np.r_[int(np.argmax(widths)), warm.qidx])
    warm_win = _drive(server, traffic, terms, warm, float(traffic["warmup_s"]), drain_limit_s)
    if on_card:
        torch.cuda.synchronize()
    # What set-up made stays out of the collector's way during the window,
    # as a long-lived server freezes its start-up heap; the window's own
    # objects are collected as usual.
    gc.collect()
    gc.freeze()
    stream = traffic_mod.make_stream(arr, seed, seconds, terms.shape[0])

    spans = tracer = undo = None
    if trace:
        spans = drive.Spans()
        undo = drive.wrap_server(server, bengine, spans,
                                 torch.cuda.synchronize if on_card else None)
        if on_card:
            from anytime_bench.devtrace import DeviceTrace

            tracer = DeviceTrace(torch.device(device))
            tracer.start()
    setup_s = time.perf_counter() - t_start - build_s
    win = _drive(server, traffic, terms, stream, seconds, drain_limit_s, spans)
    if tracer is not None:
        tracer.stop()
    if undo is not None:
        undo()
    torch.set_num_threads(threads)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    del server, bengine, engine
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # The reference, once the window has closed and the program is freed.
    traj = coll.reference(traffic["pool"], k)
    counts = judge(np.r_[warm_win.qidx, win.qidx], warm_win.results + win.results, traj,
                   bounded=traffic.get("sla_ms") is not None)
    answered = np.asarray([r is not None for r in win.results], bool)
    latency = None
    if win.due is not None:
        latency = np.where(answered, (win.done - win.due) * 1e3, np.inf)
    ctx = Context(window=win, setup_s=setup_s, latency_ms=latency, traj=traj,
                  bytes_needed=_bytes_needed(win, traj, k), spans=spans,
                  timeline=tracer.timeline() if tracer is not None else None)

    metrics = {}
    for m in _metrics_for(bench, workload, trace):
        value = _reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": int(cell["chips"]),
           "memory_peak_bytes": peak}
    result = {"correct": all(counts[c] <= LIMITS[c] for c in LIMITS),
              "attempted": len(warm_win.results) + len(win.results),
              "failed": int(counts["failed"]),
              "metrics": metrics, "device": dev}
    if ctx.timeline is not None:
        dev["busy_s"] = ctx.timeline.busy_s
        dev["window_s"] = ctx.timeline.window_s
        result["breakdown"] = {
            "device_ops": ctx.timeline.top_ops(10),
            "idle_gaps": ctx.timeline.idle_by(
                {"plan": spans.arrays("plan"), "step": spans.arrays("step"),
                 "wait_arrivals": spans.arrays("wait")}, {"step": ["plan"]})[:10]}
    log(f"setup {setup_s:.3f} s; window: {len(win.results)} queries, {int(answered.sum())} answered, "
        f"{int(np.sum(win.done < seconds))} in the window, drain to {win.end:.3f} s, "
        f"submission lag up to {win.lag_s * 1e3:.3f} ms, longest step {win.max_step_s * 1e3:.3f} ms")
    checks = {c: (int(counts[c]), LIMITS[c]) for c in LIMITS}
    return result, checks

