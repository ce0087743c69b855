"""The knee sweep: open-loop Poisson rates through a cell's server, on the card.

    python3 anytime_bench/sweep.py --workload gov2-4r.poisson --seconds 6 \
        --rates 200,400,800 --out sweep.jsonl

Each point is a fresh server over one loaded engine, under the cell's own
budget: the cell's warm-up, then ``--seconds`` of Poisson arrivals at the
rate, drained. A point reports the P99 of the latency from due time to
answer, the queries still unanswered when the window closed (a growing queue
leaves many), the ratio of the P99 of the window's last quarter to its
first, and whether every answer was correct. A point whose queue grows
(``grows``: more than two slot tables' worth open at the close, or the last
quarter's P99 over twice the first's) ends the sweep once a second follows. The knee is the highest rate whose queue does not grow; it is
read from the output and written into the cell's traffic file as a number,
once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import numpy as np
    import torch

    from anytime_bench import harness, traffic as traffic_mod
    from anytime_bench.collection import Collection
    from anytime_bench.reference.judge import judge
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import BatchEngine, BucketSpec

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, traffic = harness.load_cell(bench, args.workload, ROOT)
    k = int(traffic.get("k") or cfg["k"])
    coll = Collection(cfg)
    coll.prepare(traffic["pool"])
    terms, widths = coll.pool(traffic["pool"])
    traj = coll.reference(traffic["pool"], k)
    engine = Engine.from_artifact(coll.artifact, k=k, device="cuda")
    torch.set_num_threads(1)  # as in a run's window (harness.run_cell)
    bengine = BatchEngine(engine, BucketSpec(max_batch=traffic["slots"]))
    rates = [float(r) for r in args.rates.split(",")]
    out = open(args.out, "a")

    def point(rate):
        t = dict(traffic, arrivals={"process": "poisson", "rate_qps": rate})
        server = harness._make_server(t, bengine)
        warm = traffic_mod.make_stream(t["arrivals"], args.seed, t["warmup_s"], len(terms), 1)
        server.submit(terms[int(np.argmax(widths))])
        harness._drive(server, t, terms, warm, t["warmup_s"], 60.0)
        torch.cuda.synchronize()
        s = traffic_mod.make_stream(t["arrivals"], args.seed, args.seconds, len(terms))
        win = harness._drive(server, t, terms, s, args.seconds, 20.0)
        lat = np.where(np.isnan(win.done), np.inf, (win.done - win.due) * 1e3)
        q = len(lat) // 4
        open_at_close = int(np.sum(~(win.done < args.seconds)))
        last_over_first = float(np.percentile(lat[-q:], 99) / np.percentile(lat[:q], 99))
        counts = judge(win.qidx, win.results, traj, bounded=t["sla_ms"] is not None)
        budget = sum(bool(r.exit_budget and not r.exit_safe) for r in win.results if r)
        rec = dict(workload=args.workload, sla_ms=t["sla_ms"], rate_qps=rate, n=len(lat),
                   p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
                   p99_last_over_first=last_over_first, open_at_close=open_at_close,
                   grows=bool(open_at_close > 2 * traffic["slots"] or last_over_first > 2.0),
                   budget_cut=budget / max(len(lat), 1), drain_s=win.end - args.seconds,
                   lag_ms=win.lag_s * 1e3, **counts, card=torch.cuda.get_device_name(0))
        out.write(json.dumps(rec) + "\n")
        out.flush()
        print(json.dumps(rec), flush=True)
        return rec

    grown = 0
    for rate in rates:
        t0 = time.perf_counter()
        grown += point(rate)["grows"]
        print(f"point took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        if grown >= 2:
            break
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
