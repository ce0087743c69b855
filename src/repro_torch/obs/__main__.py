"""CLI: ``python -m repro_torch.obs {report,slo,watch} ...`` (DESIGN.md §13-§14).

* ``report <trace.jsonl>`` — latency/exit/fidelity summary of a trace;
* ``slo <trace.jsonl>`` — offline SLO burn-rate report over the same
  trace (windowed attainment, error budgets, alert-state per SLO);
* ``watch <snapshot.json>`` — live terminal dashboard over a snapshot
  file a serving process writes via ``export.write_snapshot``
  (``--once`` renders a single frame, for CI smokes).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.report import render, summarize
from repro_torch.obs.slo import DEFAULT_WINDOWS, render_slo, replay_trace
from repro_torch.obs.trace import read_traces
from repro_torch.obs.watch import watch_loop


def _parse_windows(spec: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, sec = part.split("=", 1)
            out[name.strip()] = float(sec)
        else:
            out[f"{part}s"] = float(part)
    if not out:
        raise argparse.ArgumentTypeError(f"no windows in {spec!r}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="summarize a JSONL query trace")
    rp.add_argument("trace", help="path to a TraceSink JSONL file")
    rp.add_argument(
        "--sla-ms",
        type=float,
        default=None,
        help="override the per-record SLA for compliance accounting",
    )
    rp.add_argument(
        "--json", action="store_true", help="emit the summary as JSON"
    )

    sp = sub.add_parser(
        "slo", help="SLO burn-rate report over a JSONL query trace"
    )
    sp.add_argument("trace", help="path to a TraceSink JSONL file")
    sp.add_argument(
        "--sla-ms",
        type=float,
        default=None,
        help="latency SLO threshold (default: max recorded sla_ms attr)",
    )
    sp.add_argument(
        "--fidelity-ceiling",
        type=float,
        default=None,
        help="fidelity-bound SLO ceiling (default: max recorded bound)",
    )
    sp.add_argument(
        "--windows",
        type=_parse_windows,
        default=None,
        metavar="NAME=SECONDS,...",
        help=f"burn windows (default {','.join(f'{k}={int(v)}' for k, v in DEFAULT_WINDOWS.items())})",
    )
    sp.add_argument(
        "--json", action="store_true", help="emit the report as JSON"
    )

    wp = sub.add_parser(
        "watch", help="terminal dashboard over a metrics snapshot file"
    )
    wp.add_argument(
        "snapshot", help="path written by repro_torch.obs.export.write_snapshot"
    )
    wp.add_argument(
        "--interval", type=float, default=2.0, help="refresh period seconds"
    )
    wp.add_argument(
        "--once",
        action="store_true",
        help="render one frame and exit (nonzero if the file is unreadable)",
    )

    args = ap.parse_args(argv)

    if args.cmd == "watch":
        return watch_loop(args.snapshot, interval=args.interval, once=args.once)

    records = read_traces(args.trace)
    if not records:
        print(f"{args.trace}: no trace records", file=sys.stderr)
        return 1
    if args.cmd == "report":
        summary = summarize(records, sla_ms=args.sla_ms)
        print(
            json.dumps(summary, indent=2, sort_keys=True)
            if args.json
            else render(summary)
        )
        return 0
    report = replay_trace(
        records,
        sla_ms=args.sla_ms,
        fidelity_ceiling=args.fidelity_ceiling,
        windows=args.windows,
    )
    print(
        json.dumps(report, indent=2, sort_keys=True)
        if args.json
        else render_slo(report)
    )
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. `... report t.jsonl | head`
        raise SystemExit(0)
