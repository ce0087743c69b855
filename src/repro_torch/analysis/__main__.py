"""CLI for the static-hazard analyzer (DESIGN.md §15).

    python -m repro_torch.analysis check [PATH ...] [--baseline FILE] [--json OUT]
    python -m repro_torch.analysis baseline [PATH ...] [--out FILE]
    python -m repro_torch.analysis explain [RULE]

``check`` exits nonzero on any finding outside the baseline *and* on any
stale baseline entry (the ratchet only tightens). ``baseline`` rewrites
the pin file from the current findings. ``explain`` prints the per-rule
help catalog.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.baseline import (
    diff_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.registry import RULES, help_for
from repro_torch.analysis.runner import analyze_paths

DEFAULT_PATHS = ["src/repro_torch"]
DEFAULT_BASELINE = "analysis_baseline_torch.json"


def _cmd_check(args) -> int:
    rep = analyze_paths(args.paths or DEFAULT_PATHS)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(rep.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")
    if args.baseline:
        baseline = load_baseline(args.baseline)
        new, stale = diff_baseline(rep.findings, baseline)
        for f in new:
            print(f"NEW     {f.render()}")
        for k in stale:
            ent = baseline[k]
            print(
                f"STALE   {ent.get('path')}: [{ent.get('rule')}] "
                f"{ent.get('scope')}: baseline entry no longer matches a "
                f"finding — the debt was paid; delete key {k}"
            )
        print(
            f"repro_torch.analysis: {len(rep.findings)} finding(s) "
            f"({len(rep.waived)} waived) across {rep.files} file(s); "
            f"{len(new)} new, {len(stale)} stale vs {args.baseline}"
        )
        return 1 if (new or stale) else 0
    for f in rep.findings:
        print(f.render())
    print(
        f"repro_torch.analysis: {len(rep.findings)} finding(s) "
        f"({len(rep.waived)} waived) across {rep.files} file(s)"
    )
    return 1 if rep.findings else 0


def _cmd_baseline(args) -> int:
    rep = analyze_paths(args.paths or DEFAULT_PATHS)
    write_baseline(args.out, rep.findings)
    print(
        f"repro_torch.analysis: pinned {len(rep.findings)} finding(s) "
        f"({len(rep.waived)} waived) into {args.out}"
    )
    return 0


def _cmd_explain(args) -> int:
    names = [args.rule.upper()] if args.rule else sorted(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        print(
            f"unknown rule(s): {', '.join(unknown)} — "
            f"registered: {', '.join(sorted(RULES))}",
            file=sys.stderr,
        )
        return 2
    for i, n in enumerate(names):
        if i:
            print()
        print(f"{n}\n{'-' * len(n)}")
        print(help_for(n))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("check", help="run the checkers, gate on findings")
    p.add_argument("paths", nargs="*", help=f"roots (default {DEFAULT_PATHS})")
    p.add_argument(
        "--baseline",
        help=f"ratchet file (e.g. {DEFAULT_BASELINE}); nonzero exit on "
        f"new or stale findings",
    )
    p.add_argument("--json", help="also write the full report as JSON")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("baseline", help="pin current findings as the baseline")
    p.add_argument("paths", nargs="*", help=f"roots (default {DEFAULT_PATHS})")
    p.add_argument("--out", default=DEFAULT_BASELINE)
    p.set_defaults(fn=_cmd_baseline)

    p = sub.add_parser("explain", help="print the rule help catalog")
    p.add_argument("rule", nargs="?", help="one rule (default: all)")
    p.set_defaults(fn=_cmd_explain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # `... | head` closed stdout; not an error
        raise SystemExit(0)
