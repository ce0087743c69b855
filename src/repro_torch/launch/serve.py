"""Serving launcher of the port: anytime IR under an SLA, on the card.

``python -m repro_torch.launch.serve [--mode host|batch|inflight|sharded|control]
[--sla-ms B] [--policy reactive] [--batch-size 16] [--quantum 1]
[--shards 4] [--replicas 1] [--queries N] [--n-docs N] [--n-terms V]
[--strategy S] [--device cuda] [--trace out.jsonl] [--metrics snap.json]``

Builds a clustered index over the planted-topic benchmark corpus (the JAX
package's benchmark preset: 24,000 docs, 12,000 terms, 24 topics, 32
ranges, mean length 220, ``clustered_bp``) and serves a query stream in
one of five modes, reporting q/s, percentile latencies, SLA compliance and
RBO against the exhaustive oracle:

  * ``--mode host`` (default) — the host-driven anytime loop under the
    chosen §6 termination policy, one ``range_step`` per range;
  * ``--mode batch`` — the production path: ``MicroBatchServer`` over
    ``BatchEngine``, one ``traverse`` launch per micro-batch, the SLA
    compiled into per-query postings budgets by ``SlaBudgeter`` (the
    counterpart of the reference's ``examples/serve_anytime.py --mode
    batch``);
  * ``--mode inflight`` — ``InflightServer``: ``--batch-size`` slots, one
    ``traverse`` launch per step of ``--quantum`` ranges, a finished
    query's slot refilled on the next step (``--mode inflight``);
  * ``--mode sharded`` — ``MicroBatchServer`` over ``ShardedBatchEngine``
    with ``--shards`` range shards stacked on one card, one ``traverse``
    launch per micro-batch over every (query, shard) pair, budgets from
    ``ShardedSlaBudgeter`` (``--mode sharded``);
  * ``--mode control`` — the control plane (``control.ControlPlane``)
    over ``--shards`` range shards and ``--replicas`` replica groups (one
    card: the groups serve through the sharded engine), BoundSum budgets,
    one stream through a healthy window, an outage of shard 0 (served
    degraded through the fidelity bound), its recovery and a live reshard
    (the planner's proposal, or the first boundary nudged one range) with
    serving uninterrupted: the counterpart of the reference's
    ``examples/serve_anytime.py --mode control``. With ``--trace`` or
    ``--metrics`` the operations loop (SLO tracker, drift monitor) runs
    every drain, its alerts fed back into the plane, and the metrics
    snapshot is rewritten after every drain.

``--trace out.jsonl`` records a per-query trace of the timed window (any
mode, sample rate 1.0, DESIGN.md §13) for ``python -m repro_torch.obs
report out.jsonl`` / ``... slo out.jsonl``; ``--metrics snap.json``
exports the metrics registry with the dispatch profiler's split, the SLO
burn-rate report and the drift detectors' alerts for ``python -m
repro_torch.obs watch snap.json``, as the reference's
``examples/serve_anytime.py`` does. Serving with either is bitwise the
serving without.

The index is built on the host each run; a saved index is served through
``repro_torch.index_io`` and ``Engine.from_artifact``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.control import ControlPlane
from repro_torch.core.anytime import (
    Fixed, Overshoot, Policy, Predictive, Reactive, Undershoot, run_query_anytime,
)
from repro_torch.core.clustered_index import ClusteredIndex, build_index
from repro_torch.core.metrics import rbo
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.core.range_daat import Engine
from repro_torch.data.synth import Corpus, make_corpus, make_query_log
from repro_torch.obs import NOOP, Instrumentation, write_snapshot
from repro_torch.obs.detect import DriftMonitor, default_serving_detectors
from repro_torch.obs.slo import SloTracker, default_serving_slos
from repro_torch.serving import (
    BatchEngine,
    BucketSpec,
    InflightServer,
    MicroBatchServer,
    ShardedBatchEngine,
    ShardedEngine,
    ShardedSlaBudgeter,
    SlaBudgeter,
)

__all__ = [
    "Operations", "POLICIES", "PRESET", "build_preset", "calibrate", "format_report",
    "main", "serve", "serve_batch", "serve_control", "serve_inflight",
]

PRESET = dict(
    n_docs=24_000, n_terms=12_000, n_topics=24, n_ranges=32, mean_doc_len=220,
    strategy="clustered_bp",
)

POLICIES = {
    "none": lambda a: None,
    "fixed": lambda a: Fixed(10),
    "overshoot": lambda a: Overshoot(),
    "undershoot": lambda a: Undershoot(2.0),
    "predictive": lambda a: Predictive(a),
    "reactive": lambda a: Reactive(alpha=a, beta=1.2, q=0.01),
}


def build_preset(
    n_docs: int = PRESET["n_docs"],
    n_terms: int = PRESET["n_terms"],
    strategy: str = PRESET["strategy"],
    n_topics: int = PRESET["n_topics"],
    n_ranges: int = PRESET["n_ranges"],
    mean_doc_len: int = PRESET["mean_doc_len"],
    bits: int = 8,
    seed: int = 0,
) -> tuple[Corpus, ClusteredIndex]:
    """The planted-topic corpus and its clustered index (host numpy)."""
    corpus = make_corpus(
        n_docs=n_docs, n_terms=n_terms, n_topics=n_topics,
        mean_doc_len=mean_doc_len, seed=seed,
    )
    index = build_index(corpus, n_ranges=n_ranges, strategy=strategy, bits=bits,
                        seed=seed)
    return corpus, index


def calibrate(engine: Engine, queries: list, n: int = 64) -> dict:
    """Unbudgeted anytime runs of the first ``n`` queries.

    They warm the engine and give the exhaustive latency distribution (its
    P99), the median postings scored per ms (the batch budgeter's first
    rate), the oracle top-k that RBO is measured against, and the range
    steps they took.
    """
    base, rates, oracle, ranges = [], [], {}, 0
    for i, q in enumerate(queries[:n]):
        res = run_query_anytime(engine, engine.plan(q), policy=None)
        ranges += res.ranges_processed
        base.append(res.elapsed_ms)
        if res.elapsed_ms > 0:
            rates.append(res.postings / res.elapsed_ms)
        oracle[i] = exhaustive_topk(engine.index, q, engine.k)[0].tolist()
    return dict(exhaustive_p99_ms=float(np.percentile(base, 99)), oracle=oracle,
                rate=float(np.median(rates)), ranges=ranges)


def _latency_stats(times, quality, budget: float, wall: float, n: int) -> dict:
    t = np.asarray(times)
    return {
        "queries": n,
        "sla_ms": budget,
        "wall_s": wall,
        "qps": n / wall,
        "p50_ms": float(np.percentile(t, 50)),
        "p95_ms": float(np.percentile(t, 95)),
        "p99_ms": float(np.percentile(t, 99)),
        "miss_pct": float((t > budget).mean() * 100),
        "rbo": float(np.mean(quality)),
        "sla_met": bool(np.percentile(t, 99) <= budget),
    }


class Operations:
    """The reference example's operations loop over an ``obs`` handle: SLO
    burn-rate accounting (``SloTracker`` over the default serving SLOs)
    and the default drift detectors (``DriftMonitor``), sampled at the
    start and the end of a timed window."""

    def __init__(self, obs, sla_ms: float, server: str, n_shards: int | None = None):
        self.tracker = SloTracker(obs, default_serving_slos(
            sla_ms=sla_ms, fidelity_ceiling=None))
        self.monitor = default_serving_detectors(
            DriftMonitor(obs), n_shards=n_shards, server=server)
        self.alerts: list = []
        self.monitor.subscribe(lambda ev: self.alerts.append(ev.to_dict()))
        self.tracker.sample()

    def close(self) -> dict:
        """Sample the window's end, poll the detectors; the SLO report and
        the alerts, for the metrics snapshot."""
        self.tracker.sample()
        self.monitor.poll()
        return {"slo": self.tracker.evaluate(), "alerts": self.alerts}


def serve(
    engine: Engine,
    queries: list,
    policy: Policy | None,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
    obs=NOOP,
) -> dict:
    """Serve ``queries`` through the anytime loop; latency and quality stats.

    Three whole-query traversals (``Engine.traverse``) warm the engine
    first; then the first ``n_calibrate`` queries run unbudgeted through
    the anytime loop (``calibrate``; the default SLA is a quarter of their
    P99). ``runs`` counts every query run; ``ranges`` the range steps of
    the anytime loop (calibration and serving), ``traversals`` the
    warm-up's whole-query traversals and ``traverse_ranges`` their ranges.
    An enabled ``obs`` gets one service span per timed query (the host
    loop has no server in front of it) and the operations report.
    """
    warm = queries[:3]
    traverse_ranges = 0
    for q in warm:  # first launches, allocator, kernel load
        traverse_ranges += engine.traverse(engine.plan(q)).ranges_processed
    engine.synchronize()

    cal = calibrate(engine, queries, n_calibrate)
    oracle, ranges = cal["oracle"], cal["ranges"]
    budget = sla_ms or cal["exhaustive_p99_ms"] * 0.25

    ops = Operations(obs, budget, "host") if obs.enabled else None
    times, vals = [], []
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        plan = engine.plan(q)
        t_q = obs.clock() if obs.enabled else 0.0
        res = run_query_anytime(engine, plan, policy=policy, budget_ms=budget)
        ranges += res.ranges_processed
        times.append(res.elapsed_ms)
        if obs.enabled:
            obs.trace_begin(i)
            obs.trace_span(i, "service", t_q, obs.clock())
            obs.trace_attr(i, server="host", latency_ms=res.elapsed_ms,
                           exit_reason=res.exit_reason, sla_ms=budget)
            obs.trace_end(i)
        if i in oracle:
            vals.append(rbo(res.doc_ids.tolist(), oracle[i], phi=0.8))
    wall = time.perf_counter() - t0
    return {
        **(ops.close() if ops is not None else {}),
        **_latency_stats(times, vals, budget, wall, len(queries)),
        "runs": len(warm) + len(oracle) + len(queries),
        "ranges": ranges,
        "traversals": len(warm),
        "traverse_ranges": traverse_ranges,
        "exhaustive_p99_ms": cal["exhaustive_p99_ms"],
    }


def _rbo_to_oracle(served, oracle: dict, rid0: int = 0) -> list:
    """RBO of each served result (sorted by score desc, id asc) against the
    exhaustive top-k of its query, for the queries the oracle holds."""
    vals = []
    for s in served:
        qi = s.rid - rid0
        if qi in oracle:
            ids = s.result.doc_ids[np.lexsort((s.result.doc_ids, -s.result.scores))]
            vals.append(rbo(ids.tolist(), oracle[qi], phi=0.8))
    return vals


def serve_batch(
    engine: Engine,
    queries: list,
    batch_size: int = 16,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
    n_shards: int | None = None,
    obs=NOOP,
) -> dict:
    """Serve ``queries`` through ``MicroBatchServer`` over ``BatchEngine``,
    or with ``n_shards`` over ``ShardedBatchEngine`` (range shards stacked
    on the engine's card, budgets from ``ShardedSlaBudgeter``).

    The reference's ``serve_batch``: calibrate (oracle, exhaustive P99 and
    the budgeter's first rate), run every (batch, width) shape once, probe
    4 x ``batch_size`` queries unbudgeted (the default SLA is half their
    P99: one dispatch serves a whole batch, so the single-query
    distribution understates it), let a ``Reactive(1.0, 1.5, 0.01)``
    budgeter see one warm batch, then time the replay of every query in
    micro-batches. RBO compares each result, sorted by (score desc, id
    asc), with the exhaustive top-k. ``batches`` counts the dispatches
    (``traverse`` launches under ``impl="cuda"``), ``ranges`` the
    calibration's range steps. ``obs`` instruments the timed window only:
    the budgeter, the server and the engine that dispatches (the profiler
    sites ``batch_engine`` or ``sharded``), and the operations report.
    """
    spec = BucketSpec(max_batch=batch_size)
    extra = {}
    if n_shards:
        seng = ShardedEngine(engine, n_shards)
        beng = ShardedBatchEngine(seng, spec)
        extra = dict(shards=seng.n_shards, mass=seng.mass.tolist())

        def mk_budgeter(**kw):
            return ShardedSlaBudgeter(n_shards=seng.n_shards, **kw)
    else:
        beng = BatchEngine(engine, spec)
        mk_budgeter = SlaBudgeter
    cal = calibrate(engine, queries, n_calibrate)
    oracle = cal["oracle"]
    widths = {spec.width_bucket(engine.plan(q).blk_tab_host.shape[1]) for q in queries}
    beng.warmup(sorted(widths))

    probe = MicroBatchServer(
        beng, mk_budgeter(sla_ms=float("inf"), rate=cal["rate"]), max_batch=batch_size
    )
    lat = [s.latency_ms for s in probe.replay(queries[: 4 * batch_size],
                                              batch_size=batch_size)]
    probe_p99 = float(np.percentile(lat, 99))
    budget = sla_ms or probe_p99 * 0.5

    budgeter = mk_budgeter(sla_ms=budget, policy=Reactive(alpha=1.0, beta=1.5, q=0.01),
                           rate=cal["rate"])
    server = MicroBatchServer(beng, budgeter, max_batch=batch_size)
    server.replay(queries[:batch_size])  # the budgeter sees one real batch
    rid0 = server._next_rid
    if obs.enabled:
        budgeter.obs = server.obs = obs
        server.clock = obs.clock
        (seng if n_shards else beng).obs = obs
        ops = Operations(obs, budget, "micro", n_shards)

    t0 = time.perf_counter()
    served = server.replay(queries, batch_size=batch_size)
    wall = time.perf_counter() - t0
    if obs.enabled:
        extra.update(ops.close())
    times = [s.latency_ms for s in served]
    vals = _rbo_to_oracle(served, oracle, rid0)
    return {
        **_latency_stats(times, vals, budget, wall, len(queries)),
        **extra,
        "batch_size": batch_size,
        "batches": beng.batches_run,
        "ranges": cal["ranges"],
        "shapes": sorted(beng.compiled_shapes),
        "probe_p99_ms": probe_p99,
        "exhaustive_p99_ms": cal["exhaustive_p99_ms"],
        "final_alpha": budgeter.policy.alpha,
    }


def serve_inflight(
    engine: Engine,
    queries: list,
    n_slots: int = 16,
    quantum: int = 1,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
    obs=NOOP,
) -> dict:
    """Serve ``queries`` through ``InflightServer`` at saturating load.

    The reference's ``serve_inflight``: calibrate (oracle, exhaustive P99
    and the budgeter's first rate), replay 4 x ``n_slots`` queries through
    an unbudgeted server (its P99 halved is the default SLA), then time
    the replay of every query through a server whose ``SlaBudgeter``
    (``Reactive(1.0, 1.5, 0.01)``) fixes each query's budget at admission.
    ``steps`` counts both servers' steps (``traverse`` launches under
    ``impl="cuda"``), ``ranges`` the calibration's range steps. ``obs``
    instruments the timed server and its budgeter (the profiler site
    ``inflight``), and the operations report.
    """
    beng = BatchEngine(engine, BucketSpec(max_batch=n_slots))
    cal = calibrate(engine, queries, n_calibrate)
    oracle = cal["oracle"]

    warm = InflightServer(beng, SlaBudgeter(sla_ms=float("inf"), rate=cal["rate"]),
                          n_slots=n_slots, quantum=quantum)
    lat = [s.latency_ms for s in warm.replay(queries[: 4 * n_slots])]
    probe_p99 = float(np.percentile(lat, 99))
    budget = sla_ms or probe_p99 * 0.5

    budgeter = SlaBudgeter(sla_ms=budget, policy=Reactive(alpha=1.0, beta=1.5, q=0.01),
                           rate=cal["rate"], obs=obs)
    server = InflightServer(beng, budgeter, n_slots=n_slots, quantum=quantum, obs=obs)
    ops = Operations(obs, budget, "inflight") if obs.enabled else None
    t0 = time.perf_counter()
    served = server.replay(queries)
    wall = time.perf_counter() - t0
    times = [s.latency_ms for s in served]
    vals = _rbo_to_oracle(served, oracle)
    return {
        **(ops.close() if ops is not None else {}),
        **_latency_stats(times, vals, budget, wall, len(queries)),
        "slots": n_slots,
        "quantum": quantum,
        "steps": warm.steps_run + server.steps_run,
        "window_steps": server.steps_run,
        "ranges": cal["ranges"],
        "shapes": sorted(warm.compiled_shapes | server.compiled_shapes),
        "probe_p99_ms": probe_p99,
        "exhaustive_p99_ms": cal["exhaustive_p99_ms"],
        "final_alpha": budgeter.policy.alpha,
    }


def serve_control(
    engine: Engine,
    queries: list,
    n_shards: int = 4,
    n_replicas: int = 1,
    batch_size: int = 16,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
    obs=NOOP,
    metrics_path: str | None = None,
) -> dict:
    """Serve ``queries`` through a ``ControlPlane``: healthy, shard 0 down,
    recovered, then a live reshard, one stream.

    The reference's ``serve_control`` (``examples/serve_anytime.py``): the
    plane (``sla_ms`` None serves unbudgeted) runs every (batch, width)
    shape once, then the first
    third of the log healthy, the second third with shard 0 marked down
    (every query answers, degraded), and the rest while a reshard to the
    planner's proposal (or, when the planner is not armed, the first
    boundary moved by one range) cuts over between drains. With an enabled
    ``obs`` the plane's operations loop (``SloTracker``, ``DriftMonitor``
    with the default detectors) polls every drain and ``metrics_path`` is
    rewritten after each drain of the reshard window. ``batches`` counts
    the dispatches of every batch engine the plane served through, the
    successor's warm-up included (``traverse`` launches under
    ``impl="cuda"``); ``ranges`` the calibration's range steps.
    """
    plane = ControlPlane(
        engine, n_shards=n_shards, n_replicas=n_replicas,
        sla_ms=sla_ms or float("inf"), spec=BucketSpec(max_batch=batch_size), obs=obs,
    )
    tracker = monitor = None
    alerts: list = []
    if obs.enabled:
        tracker = SloTracker(obs, default_serving_slos(sla_ms=sla_ms, fidelity_ceiling=None))
        monitor = DriftMonitor(obs)
        default_serving_detectors(monitor, n_shards=n_shards, server="control")
        monitor.subscribe(lambda ev: alerts.append(ev.to_dict()))
        plane.enable_operations(slos=tracker, monitor=monitor)
    first = plane.stats()
    cal = calibrate(engine, queries, n_calibrate)
    oracle = cal["oracle"]
    widths = {plane.bengine.spec.width_bucket(engine.plan(q).blk_tab_host.shape[1])
              for q in queries}
    plane.bengine.warmup(sorted(widths))
    engines = {}  # every batch engine the plane dispatched through

    def track():
        task = plane.reshard_task
        for beng in (plane.bengine, plane.bengine_single,
                     task.bengine if task is not None else None):
            if beng is not None:
                engines[id(beng)] = beng

    times, vals, degraded = [], [], 0

    def consume(served):
        nonlocal degraded
        track()
        for s in served:
            times.append(s.latency_ms)
            r = s.result
            if "down" in r.shard_exit_reasons and not r.exact:
                degraded += 1
        vals.extend(_rbo_to_oracle(served, oracle))

    def refresh_metrics():
        if metrics_path and obs.enabled:
            write_snapshot(
                metrics_path, obs.metrics,
                slo=tracker.evaluate() if tracker is not None else None,
                alerts=alerts[-32:],
                profiler=obs.profiler.snapshot() if obs.profiler is not None else None,
                t=obs.clock(),
            )

    third = max(batch_size, len(queries) // 3)
    track()
    t0 = time.perf_counter()
    consume(plane.replay(queries[:third], batch_size=batch_size))
    plane.mark_down(0)
    consume(plane.replay(queries[third:2 * third], batch_size=batch_size))
    plane.mark_up(0)
    task = (plane.start_reshard(plane.planner.propose())
            if plane.planner.should_reshard() else None)
    if task is None and n_shards > 1:
        # Nudge the first boundary by one range (a single shard has no
        # interior boundary to move).
        cuts = plane.cuts.copy()
        cuts[1] = cuts[1] - 1 if cuts[1] > 1 else cuts[1] + 1
        if cuts[1] < cuts[2] and not np.array_equal(cuts, plane.cuts):
            task = plane.start_reshard(cuts)
    qi = 2 * third
    while qi < len(queries) or plane.reshard_task is not None:
        for q in queries[qi:qi + batch_size]:
            plane.submit(q)
        qi += batch_size
        consume(plane.drain_once())
        refresh_metrics()
    while plane.pending:
        consume(plane.drain_once())
        refresh_metrics()
    wall = time.perf_counter() - t0
    budget = sla_ms or float("inf")
    st = plane.stats()
    return {
        **({"slo": tracker.evaluate(), "alerts": alerts} if obs.enabled else {}),
        **_latency_stats(times, vals, budget, wall, len(times)),
        "shards": n_shards,
        "replicas": n_replicas,
        "first_cuts": first["cuts"],
        "cuts": st["cuts"],
        "replica_mesh": st["replica_mesh"],
        "budget_mode": plane.budgeter.mode,
        "degraded": degraded,
        "reshard_steps": task.steps_done if task is not None else 0,
        "reshards": plane.reshards_completed,
        "served_during_reshard": plane.queries_served_during_reshard,
        "degraded_slo": st["degraded_slo"],
        "batches": sum(b.batches_run for b in engines.values()),
        "ranges": cal["ranges"],
        "exhaustive_p99_ms": cal["exhaustive_p99_ms"],
    }


def format_report(policy_name: str, s: dict) -> str:
    probe = (f"unbudgeted {policy_name} P99 {s['probe_p99_ms']:.2f} ms, "
             if "probe_p99_ms" in s else "")
    return (
        f"policy={policy_name} SLA: P99 <= {s['sla_ms']:.2f} ms "
        f"({probe}exhaustive P99 {s['exhaustive_p99_ms']:.2f} ms)\n"
        f"{s['queries']} queries in {s['wall_s']:.1f}s ({s['qps']:.1f} q/s)\n"
        f"P50/P95/P99: {s['p50_ms']:.2f} / {s['p95_ms']:.2f} / {s['p99_ms']:.2f} ms"
        f" | miss {s['miss_pct']:.2f}% | RBO {s['rbo']:.4f} | SLA "
        f"{'MET' if s['sla_met'] else 'MISSED'}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="host",
                    choices=("host", "batch", "inflight", "sharded", "control"))
    ap.add_argument("--batch-size", type=int, default=16,
                    help="micro-batch (batch, sharded) or slots (inflight)")
    ap.add_argument("--quantum", type=int, default=1,
                    help="ranges per in-flight step (--mode inflight)")
    ap.add_argument("--shards", type=int, default=4,
                    help="range shards on the card (--mode sharded, control)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica groups (--mode control; on one card they serve "
                         "through the sharded engine)")
    ap.add_argument("--sla-ms", type=float, default=None)
    ap.add_argument("--policy", default="reactive", choices=sorted(POLICIES))
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-docs", type=int, default=PRESET["n_docs"])
    ap.add_argument("--n-terms", type=int, default=PRESET["n_terms"])
    ap.add_argument("--strategy", default=PRESET["strategy"],
                    choices=("random", "bp", "clustered", "clustered_bp",
                             "clustered_random"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a per-query JSONL trace (sample rate 1.0) "
                         "for `python -m repro_torch.obs report PATH`")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a metrics/SLO/alerts/profiler snapshot "
                         "for `python -m repro_torch.obs watch PATH`")
    args = ap.parse_args(argv)
    obs = (Instrumentation.make(sample_rate=1.0, trace_path=args.trace,
                                profile=bool(args.metrics))
           if args.trace or args.metrics else NOOP)
    stats = _serve_mode(args, obs)
    if obs.enabled:
        if args.metrics:
            write_snapshot(
                args.metrics, obs.metrics, slo=stats.get("slo"),
                alerts=stats.get("alerts"),
                profiler=(obs.profiler.snapshot()
                          if obs.profiler is not None else None),
                t=obs.clock(),
            )
            print(f"metrics snapshot -> {args.metrics}  "
                  f"(view: python -m repro_torch.obs watch {args.metrics} --once)")
        obs.close()
        if args.trace:
            print(f"trace: {obs.tracer.finished} records -> {args.trace}  "
                  f"(summarize: python -m repro_torch.obs report {args.trace})")


def _serve_mode(args, obs) -> dict:
    """Build the preset, serve it in ``args.mode``, print the report."""
    corpus, index = build_preset(args.n_docs, args.n_terms, args.strategy)
    log = make_query_log(corpus, n_queries=args.queries, seed=42)
    engine = Engine(index, k=args.k, device=args.device)
    queries = [log.terms[i] for i in range(log.n_queries)]
    print(f"device={engine.device} impl={engine.impl} mode={args.mode}")
    if args.mode in ("batch", "sharded"):
        stats = serve_batch(engine, queries, args.batch_size, sla_ms=args.sla_ms,
                            n_shards=args.shards if args.mode == "sharded" else None,
                            obs=obs)
        if args.mode == "sharded":
            print(f"sharded: {stats['shards']} range shards on {engine.device}, "
                  f"mass={stats['mass']}")
        print(format_report(args.mode, stats))
        print(f"batch={stats['batch_size']}, {stats['batches']} dispatches, shapes "
              f"{stats['shapes']}, final alpha {stats['final_alpha']:.2f}")
        return stats
    if args.mode == "inflight":
        stats = serve_inflight(engine, queries, args.batch_size, args.quantum,
                               sla_ms=args.sla_ms, obs=obs)
        print(format_report("inflight", stats))
        print(f"slots={stats['slots']}, quantum={stats['quantum']}, {stats['steps']} "
              f"steps, shapes {stats['shapes']}, final alpha {stats['final_alpha']:.2f}")
        return stats
    if args.mode == "control":
        stats = serve_control(engine, queries, args.shards, args.replicas, args.batch_size,
                              sla_ms=args.sla_ms, obs=obs, metrics_path=args.metrics)
        print(f"control plane: {stats['shards']} shards x {stats['replicas']} replicas, "
              f"cuts={stats['first_cuts']}, replica_mesh={stats['replica_mesh']}, "
              f"budget mode={stats['budget_mode']}")
        print(f"  outage window: shard 0 down, {stats['degraded']} queries served "
              "degraded (exact=False, bounded fidelity loss)")
        if stats["reshards"]:
            print(f"  live reshard -> cuts={stats['cuts']} in {stats['reshard_steps']} "
                  f"steps; {stats['served_during_reshard']} queries served mid-cutover "
                  "(serving never paused)")
        print(format_report("control", stats))
        print(f"degraded={stats['degraded']}, reshards={stats['reshards']}, "
              f"{stats['batches']} dispatches")
        if stats["degraded_slo"]:
            print("  SLO state: degraded (burn-rate alert firing)")
        return stats
    policy = POLICIES[args.policy](args.alpha)
    stats = serve(engine, queries, policy, sla_ms=args.sla_ms, obs=obs)
    print(format_report(args.policy, stats))
    return stats


if __name__ == "__main__":
    main()
