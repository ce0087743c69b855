"""Serving launcher of the port: anytime IR under an SLA, on the card.

``python -m repro_torch.launch.serve [--mode host|batch|inflight|sharded]
[--sla-ms B] [--policy reactive] [--batch-size 16] [--quantum 1]
[--shards 4] [--queries N] [--n-docs N] [--n-terms V] [--strategy S]
[--device cuda]``

Builds a clustered index over the planted-topic benchmark corpus (the JAX
package's benchmark preset: 24,000 docs, 12,000 terms, 24 topics, 32
ranges, mean length 220, ``clustered_bp``) and serves a query stream in
one of four modes, reporting q/s, percentile latencies, SLA compliance and
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
    ``ShardedSlaBudgeter`` (``--mode sharded``).

The index is built on the host each run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.anytime import (
    Fixed, Overshoot, Policy, Predictive, Reactive, Undershoot, run_query_anytime,
)
from repro_torch.core.clustered_index import ClusteredIndex, build_index
from repro_torch.core.metrics import rbo
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.core.range_daat import Engine
from repro_torch.data.synth import Corpus, make_corpus, make_query_log
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
    "POLICIES", "PRESET", "build_preset", "calibrate", "format_report", "main",
    "serve", "serve_batch", "serve_inflight",
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


def serve(
    engine: Engine,
    queries: list,
    policy: Policy | None,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
) -> dict:
    """Serve ``queries`` through the anytime loop; latency and quality stats.

    Three whole-query traversals (``Engine.traverse``) warm the engine
    first; then the first ``n_calibrate`` queries run unbudgeted through
    the anytime loop (``calibrate``; the default SLA is a quarter of their
    P99). ``runs`` counts every query run; ``ranges`` the range steps of
    the anytime loop (calibration and serving), ``traversals`` the
    warm-up's whole-query traversals and ``traverse_ranges`` their ranges.
    """
    warm = queries[:3]
    traverse_ranges = 0
    for q in warm:  # first launches, allocator, kernel load
        traverse_ranges += engine.traverse(engine.plan(q)).ranges_processed
    engine.synchronize()

    cal = calibrate(engine, queries, n_calibrate)
    oracle, ranges = cal["oracle"], cal["ranges"]
    budget = sla_ms or cal["exhaustive_p99_ms"] * 0.25

    times, vals = [], []
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        res = run_query_anytime(engine, engine.plan(q), policy=policy,
                                budget_ms=budget)
        ranges += res.ranges_processed
        times.append(res.elapsed_ms)
        if i in oracle:
            vals.append(rbo(res.doc_ids.tolist(), oracle[i], phi=0.8))
    wall = time.perf_counter() - t0
    return {
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
    calibration's range steps.
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

    t0 = time.perf_counter()
    served = server.replay(queries, batch_size=batch_size)
    wall = time.perf_counter() - t0
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
) -> dict:
    """Serve ``queries`` through ``InflightServer`` at saturating load.

    The reference's ``serve_inflight``: calibrate (oracle, exhaustive P99
    and the budgeter's first rate), replay 4 x ``n_slots`` queries through
    an unbudgeted server (its P99 halved is the default SLA), then time
    the replay of every query through a server whose ``SlaBudgeter``
    (``Reactive(1.0, 1.5, 0.01)``) fixes each query's budget at admission.
    ``steps`` counts both servers' steps (``traverse`` launches under
    ``impl="cuda"``), ``ranges`` the calibration's range steps.
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
                           rate=cal["rate"])
    server = InflightServer(beng, budgeter, n_slots=n_slots, quantum=quantum)
    t0 = time.perf_counter()
    served = server.replay(queries)
    wall = time.perf_counter() - t0
    times = [s.latency_ms for s in served]
    vals = _rbo_to_oracle(served, oracle)
    return {
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
                    choices=("host", "batch", "inflight", "sharded"))
    ap.add_argument("--batch-size", type=int, default=16,
                    help="micro-batch (batch, sharded) or slots (inflight)")
    ap.add_argument("--quantum", type=int, default=1,
                    help="ranges per in-flight step (--mode inflight)")
    ap.add_argument("--shards", type=int, default=4,
                    help="range shards on the card (--mode sharded)")
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
    args = ap.parse_args(argv)

    corpus, index = build_preset(args.n_docs, args.n_terms, args.strategy)
    log = make_query_log(corpus, n_queries=args.queries, seed=42)
    engine = Engine(index, k=args.k, device=args.device)
    queries = [log.terms[i] for i in range(log.n_queries)]
    print(f"device={engine.device} impl={engine.impl} mode={args.mode}")
    if args.mode in ("batch", "sharded"):
        stats = serve_batch(engine, queries, args.batch_size, sla_ms=args.sla_ms,
                            n_shards=args.shards if args.mode == "sharded" else None)
        if args.mode == "sharded":
            print(f"sharded: {stats['shards']} range shards on {engine.device}, "
                  f"mass={stats['mass']}")
        print(format_report(args.mode, stats))
        print(f"batch={stats['batch_size']}, {stats['batches']} dispatches, shapes "
              f"{stats['shapes']}, final alpha {stats['final_alpha']:.2f}")
        return
    if args.mode == "inflight":
        stats = serve_inflight(engine, queries, args.batch_size, args.quantum,
                               sla_ms=args.sla_ms)
        print(format_report("inflight", stats))
        print(f"slots={stats['slots']}, quantum={stats['quantum']}, {stats['steps']} "
              f"steps, shapes {stats['shapes']}, final alpha {stats['final_alpha']:.2f}")
        return
    policy = POLICIES[args.policy](args.alpha)
    stats = serve(engine, queries, policy, sla_ms=args.sla_ms)
    print(format_report(args.policy, stats))


if __name__ == "__main__":
    main()
