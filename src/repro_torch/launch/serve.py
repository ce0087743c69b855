"""Serving launcher of the port: anytime IR under an SLA, on the card.

``python -m repro_torch.launch.serve [--sla-ms B] [--policy reactive]
[--queries N] [--n-docs N] [--n-terms V] [--strategy S] [--device cuda]``

Builds a clustered index over the planted-topic benchmark corpus (the JAX
package's benchmark preset: 24,000 docs, 12,000 terms, 24 topics, 32
ranges, mean length 220, ``clustered_bp``) and serves a query stream
through the host-driven anytime loop under the chosen §6 termination
policy, reporting percentile latencies, SLA compliance and RBO against
the exhaustive oracle. The index is built on the host each run.
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

__all__ = ["POLICIES", "PRESET", "build_preset", "format_report", "main", "serve"]

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


def serve(
    engine: Engine,
    queries: list,
    policy: Policy | None,
    sla_ms: float | None = None,
    n_calibrate: int = 64,
) -> dict:
    """Serve ``queries`` through the anytime loop; latency and quality stats.

    The first ``n_calibrate`` queries run unbudgeted first: they warm the
    engine, give the exhaustive latency distribution (the default SLA is a
    quarter of its P99) and the oracle rankings RBO is measured against.
    ``runs`` counts every traversal made, warm-up and calibration included,
    and ``ranges`` the ranges they scored.
    """
    k = engine.k
    warm, calib = queries[:3], queries[:n_calibrate]
    ranges = 0
    for q in warm:  # first launches, allocator, kernel load
        ranges += engine.traverse(engine.plan(q)).ranges_processed
    engine.synchronize()

    base, oracle = [], {}
    for i, q in enumerate(calib):
        res = run_query_anytime(engine, engine.plan(q), policy=None)
        ranges += res.ranges_processed
        base.append(res.elapsed_ms)
        oracle[i] = exhaustive_topk(engine.index, q, k)[0].tolist()
    exh_p99 = float(np.percentile(base, 99))
    budget = sla_ms or exh_p99 * 0.25

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
    t = np.asarray(times)
    return {
        "queries": len(queries),
        "runs": len(warm) + len(calib) + len(queries),
        "ranges": ranges,
        "sla_ms": budget,
        "exhaustive_p99_ms": exh_p99,
        "wall_s": wall,
        "qps": len(queries) / wall,
        "p50_ms": float(np.percentile(t, 50)),
        "p95_ms": float(np.percentile(t, 95)),
        "p99_ms": float(np.percentile(t, 99)),
        "miss_pct": float((t > budget).mean() * 100),
        "rbo": float(np.mean(vals)),
        "sla_met": bool(np.percentile(t, 99) <= budget),
    }


def format_report(policy_name: str, s: dict) -> str:
    return (
        f"policy={policy_name} SLA: P99 <= {s['sla_ms']:.2f} ms "
        f"(exhaustive P99 {s['exhaustive_p99_ms']:.2f} ms)\n"
        f"{s['queries']} queries in {s['wall_s']:.1f}s ({s['qps']:.1f} q/s)\n"
        f"P50/P95/P99: {s['p50_ms']:.2f} / {s['p95_ms']:.2f} / {s['p99_ms']:.2f} ms"
        f" | miss {s['miss_pct']:.2f}% | RBO {s['rbo']:.4f} | SLA "
        f"{'MET' if s['sla_met'] else 'MISSED'}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
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
    policy = POLICIES[args.policy](args.alpha)
    stats = serve(engine, queries, policy, sla_ms=args.sla_ms)
    print(f"device={engine.device} impl={engine.impl}")
    print(format_report(args.policy, stats))


if __name__ == "__main__":
    main()
