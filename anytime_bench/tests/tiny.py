"""Two tiny cells for the CPU tests: an in-flight open-loop cell under an SLA
(8-bit impacts in int8, int32 docids, k 10) and a micro-batch backlog cell
(9-bit impacts, packed docids, k 50), in the shape of the real ones."""

from __future__ import annotations

import json
import os

POOL = {"size": 48, "seed": 1, "max_len": 8, "length_dist": [0.2, 0.2, 0.2, 0.2, 0.2]}
CONFIGS = {
    "tiny": dict(name="tiny", n_ranges=4, docs_per_range=600, n_docs=2400, n_terms=1500,
                 mean_doc_len=80, zipf_s=1.1, impact_bits=8, control_impact_bits=4,
                 impact_dtype="int8", docs_format="int32", bm25={"k1": 0.4, "b": 0.9}, k=10,
                 collection_seed=3),
    "tinyp": dict(name="tinyp", n_ranges=3, docs_per_range=800, n_docs=2400, n_terms=1500,
                  mean_doc_len=80, zipf_s=1.1, impact_bits=9, control_impact_bits=8,
                  impact_dtype="int32", docs_format="packed", bm25={"k1": 0.4, "b": 0.9},
                  k=50, collection_seed=5),
}
TRAFFIC = {
    "tiny.poisson": dict(server="inflight", slots=4, quantum=1, sla_ms=4.0,
                         policy={"alpha": 1.0, "beta": 1.5, "q": 0.01},
                         arrivals={"process": "poisson", "rate_qps": 80.0}, warmup_s=0.3,
                         pool=POOL),
    "tinyp.backlog": dict(server="microbatch", batch=8, sla_ms=None, k=50,
                          arrivals={"process": "backlog", "depth": 16}, warmup_s=0.3, pool=POOL),
}
CELLS = list(TRAFFIC)


def tiny_bench(root: str) -> dict:
    """Write the tiny cells' files under ``root``; their ``BENCHMARK.json``
    object, with the real benchmark's metrics where they apply."""
    os.makedirs(os.path.join(root, "traffic"), exist_ok=True)
    for name, cfg in CONFIGS.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    for name, t in TRAFFIC.items():
        with open(os.path.join(root, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    e2e = [("setup_s", "s", None), ("p99_ms", "ms", ["tiny.poisson"]),
           ("qps", "queries/s", ["tinyp.backlog"])]
    layer = [("plan_ms.p99", "ms", ["tiny.poisson"]), ("queue_ms.p99", "ms", ["tiny.poisson"]),
             ("plan_ms.qps", "ms", ["tinyp.backlog"]), ("dispatch_ms.qps", "ms", ["tinyp.backlog"])]

    def metric(name, unit, cells):
        return dict(name=name, unit=unit, **({"workloads": cells} if cells else {}))

    return dict(
        configs=[dict(name=n, file=f"{n}.json") for n in CONFIGS],
        workloads=[dict(name=c, config=c.split(".")[0], traffic=c.split(".")[1], chips=1)
                   for c in CELLS],
        end_to_end=[metric(*m) for m in e2e], per_layer=[metric(*m) for m in layer])


def run_tiny(root: str, cell: str, seed: int = 2**31 + 7, trace: bool = False,
             device: str = "cpu", **kw):
    """One run of a tiny cell on the CPU (the kernels' plain versions)."""
    import time

    from anytime_bench.harness import run_cell

    bench = tiny_bench(root)
    kw.setdefault("drain_limit_s", 2.0)
    return run_cell(bench, cell, seed, 1.5, trace, root=root, t_start=time.perf_counter(),
                    device=device, cache_dir=os.path.join(root, "cache"),
                    traffic_dir=os.path.join(root, "traffic"), workers=1, **kw)
