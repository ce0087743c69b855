"""The control of ``correct``: the port at the next precision down must fail it.

    python3 anytime_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

runs the cell as ``run.py`` does, but the port serves an index it built at
the configuration's ``control_impact_bits`` (8-bit impacts -> 4-bit, 9-bit ->
8-bit: the program's own lower-precision path) while the reference stays at
the stated precision. Each seed prints its checks; every seed has to come out
not correct. The benchmark's own runs never run it.

One process makes the collection once and builds from it the query pool, the
port's lower-precision index and the reference's index, and serves every
seed on one loaded engine, each seed through a fresh server (as
``sweep.py`` does), so that the control at a cell's own size costs about one
run's build and one load.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prebuild(cfg: dict, lower: dict, pool: dict) -> None:
    """Make the collection once and build from it, where the cache lacks
    them, the pool, the port's index at ``lower`` and the reference's index at
    the stated precision."""
    from anytime_bench import collection
    from anytime_bench.data import synth
    from anytime_bench.reference import engine as ref

    coll = collection.Collection(cfg)
    prog = collection.Collection({**cfg, **lower})
    prog._corpus = coll.corpus()
    coll._make_pool(pool)
    prog._build_artifact()
    path = coll._ref_index_path(cfg["impact_bits"])
    if not os.path.exists(path):
        corpus = coll.corpus()
        doc_order, range_ends = synth.topic_partition(corpus)
        ix = ref.build_reference_index(corpus, doc_order, range_ends, cfg["impact_bits"],
                                       cfg["bm25"]["k1"], cfg["bm25"]["b"])
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        ref.save_reference_index(ix, tmp)
        collection._publish(tmp, path)


def one_engine():
    """Make ``Engine.from_artifact`` load each artifact once in this process
    and hand the same engine to every later run; returns the undo."""
    from repro_torch.core.range_daat import Engine

    load, engines = Engine.from_artifact, {}

    def from_artifact(path, **kw):
        key = (path, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in engines:
            engines[key] = load(path, **kw)
        return engines[key]

    Engine.from_artifact = staticmethod(from_artifact)
    return lambda: setattr(Engine, "from_artifact", load)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from anytime_bench.harness import load_cell, run_cell

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg, traffic = load_cell(bench, args.workload, ROOT)
    lower = {"impact_bits": int(cfg["control_impact_bits"])}
    t0 = time.perf_counter()
    prebuild(cfg, lower, traffic["pool"])
    print(f"control build {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    undo = one_engine()
    failed_all = True
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            result, checks = run_cell(bench, args.workload, seed, args.seconds, False, root=ROOT,
                                      t_start=time.perf_counter(), program_cfg=lower)
            failed_all &= not result["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed, "control": lower,
                              "correct": result["correct"], "attempted": result["attempted"],
                              "checks": {k: v for k, (v, _) in checks.items()},
                              "metrics": result["metrics"]}), flush=True)
    finally:
        undo()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
