"""Dependency-free terminal dashboard over a snapshot file (§14).

``python -m repro_torch.obs watch <snapshot.json>`` renders the registry state a
serving process exports via :func:`repro_torch.obs.export.write_snapshot` —
counters, gauges, histogram percentiles, the SLO burn-rate table, and the
alert tail — re-reading the file at an interval. Pure stdlib string
building (no curses, no rich): one ANSI home+clear escape per frame, so it
degrades to plain appended frames on a dumb terminal and stays usable over
``watch --once`` in CI.
"""

from __future__ import annotations

import json
import time

__all__ = ["render_dashboard", "watch_loop"]

_CLEAR = "\x1b[H\x1b[2J"
_STATE_MARK = {"ok": "ok", "slow_burn": "SLOW BURN", "fast_burn": "FAST BURN"}


def _fmt(v) -> str:
    if isinstance(v, float):
        if v != v:  # NaN
            return "nan"
        if abs(v) >= 1e6 or (0 < abs(v) < 1e-3):
            return f"{v:.3g}"
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return str(v)


def _rows(title: str, header: list[str], rows: list[list[str]]) -> list[str]:
    if not rows:
        return []
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows))
        for i in range(len(header))
    ]
    fmt_row = lambda r: "  ".join(  # noqa: E731
        c.ljust(w) for c, w in zip(r, widths)
    )
    return [f"-- {title}", fmt_row(header)] + [fmt_row(r) for r in rows] + [""]


def render_dashboard(snap: dict, max_alerts: int = 8) -> str:
    """One text frame from a ``write_snapshot`` document."""
    lines: list[str] = []
    t = snap.get("t")
    head = "repro_torch.obs watch"
    if t is not None:
        head += f"  ·  snapshot t={_fmt(float(t))}s"
    lines.append(head)
    lines.append("=" * len(head))
    lines.append("")

    slo = snap.get("slo") or {}
    rows = []
    for name, rep in sorted(slo.items()):
        burns = rep.get("windows", {})
        rows.append(
            [
                name,
                _fmt(rep.get("objective", "")),
                _fmt(rep.get("attainment", "")),
                " ".join(f"{w}={_fmt(burns[w]['burn'])}" for w in burns),
                _fmt(rep.get("budget_remaining", "")),
                _STATE_MARK.get(rep.get("state", ""), rep.get("state", "")),
            ]
        )
    lines += _rows(
        "slo", ["slo", "obj", "attain", "burn", "budget", "state"], rows
    )

    metrics = snap.get("metrics") or {}
    counters, gauges, hists = [], [], []
    for name, m in sorted(metrics.items()):
        kind = m.get("kind")
        samples = m.get("samples", {})
        if kind == "counter":
            for labels, v in sorted(samples.items()):
                counters.append([name, labels or "-", _fmt(v)])
        elif kind == "gauge":
            for labels, v in sorted(samples.items()):
                gauges.append([name, labels or "-", _fmt(v)])
        elif kind == "histogram":
            for labels, st in sorted(samples.items()):
                hists.append(
                    [
                        name,
                        labels or "-",
                        _fmt(st.get("count", 0)),
                        _fmt(st.get("p50", 0.0)),
                        _fmt(st.get("p95", 0.0)),
                        _fmt(st.get("p99", 0.0)),
                    ]
                )
    lines += _rows("counters", ["name", "labels", "value"], counters)
    lines += _rows("gauges", ["name", "labels", "value"], gauges)
    lines += _rows(
        "histograms", ["name", "labels", "count", "p50", "p95", "p99"], hists
    )

    prof = snap.get("profiler") or {}
    rows = [
        [
            site,
            _fmt(st.get("dispatches", 0)),
            _fmt(st.get("compiles", 0)),
            _fmt(st.get("recompiles", 0)),
            _fmt(st.get("device_ms", 0.0)),
            _fmt(st.get("hbm_total_bytes") or 0),
        ]
        for site, st in sorted(prof.items())
    ]
    lines += _rows(
        "profiler",
        ["site", "dispatches", "compiles", "recompiles", "device_ms", "hbm_B"],
        rows,
    )

    alerts = snap.get("alerts") or []
    rows = [
        [
            ev.get("state", "?"),
            ev.get("detector", "?"),
            _fmt(ev.get("value", "")),
            _fmt(ev.get("zscore", "")) if "zscore" in ev else "-",
        ]
        for ev in alerts[-max_alerts:]
    ]
    lines += _rows("alerts (tail)", ["state", "detector", "value", "z"], rows)
    if not (slo or metrics or prof or alerts):
        lines.append("(empty snapshot)")
    return "\n".join(lines).rstrip() + "\n"


def watch_loop(
    path: str,
    interval: float = 2.0,
    once: bool = False,
    out=None,
    sleep=time.sleep,
) -> int:
    """Render ``path`` every ``interval`` seconds (or once). Returns exit
    status: 1 if ``once`` and the snapshot is missing/unreadable."""
    import sys

    out = out if out is not None else sys.stdout
    while True:
        try:
            with open(path) as fh:
                snap = json.load(fh)
            frame = render_dashboard(snap)
        except (OSError, ValueError) as e:
            if once:
                print(f"{path}: {e}", file=sys.stderr)
                return 1
            frame = f"waiting for snapshot at {path} ({e})\n"
        if once:
            out.write(frame)
            return 0
        out.write(_CLEAR + frame)
        out.flush()
        try:
            sleep(interval)
        except KeyboardInterrupt:
            return 0
