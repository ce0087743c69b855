"""The benchmark of the port: one run of one cell on the card(s) it is given.

    python3 anytime_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads ``BENCHMARK.json``, sets up the cell
(the first run in a checkout builds the configuration's collection and index
under ``anytime_bench/.cache/``), drives ``--seconds`` of its traffic through
the port (``src/repro_torch``), judges every answer against the plain
reference, and prints one JSON object as the last line of standard output.
With ``--trace 1`` the metrics are the cell's per-layer ones, read from host
spans and a device trace; with ``--trace 0`` its end-to-end ones. The numbers
compared, each beside its limit, are the last lines of standard error and the
result's last key, ``checks``. It exits non-zero, printing no result, without
the cards the cell asks for, when the port is missing, or when the process
holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from anytime_bench.harness import forbidden_modules, run_cell

    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), root=ROOT, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no run may hold JAX or the JAX package",
              file=sys.stderr)
        return 4
    for name, (v, lim) in checks.items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    print(result_line(result, checks), flush=True)
    return 0


def result_line(result: dict, checks: dict) -> str:
    """The last line: the result's keys, then ``checks`` (each number
    compared beside its limit) as the last key."""
    out = dict(result)
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return json.dumps(out)


if __name__ == "__main__":
    sys.exit(main())
