"""Offline trace analysis: the `python -m repro_torch.obs report` backend.

Consumes a JSONL trace file written by ``TraceSink`` (schema: DESIGN.md
§13) and summarizes the operating story the paper cares about:

  * **SLA compliance** — fraction of queries whose end-to-end latency met
    the SLA the budgeter was holding (each trace records the ``sla_ms`` it
    was admitted under, so a mid-run SLA change still reports honestly;
    ``--sla-ms`` overrides for what-if analysis);
  * **queue wait vs service split** — where the latency actually went:
    time parked in the queue vs time holding a slot/dispatch. An SLA miss
    with a fat queue split is an admission problem, not a traversal
    problem — the distinction Eq. (7) feedback needs (DESIGN.md §11);
  * **exit-reason mix** — safe/budget/exhausted(/down) counts: how often
    the anytime knob actually bit;
  * **quanta per query** — in-flight path: dispatches a query spanned;
  * **fidelity-bound percentiles** — the effectiveness half of the
    anytime contract: what score mass the latency SLA cost.
"""

from __future__ import annotations

import numpy as np

__all__ = ["summarize", "render"]


def _pcts(xs, ps=(50, 95, 99)) -> dict:
    arr = np.asarray(xs, dtype=np.float64)
    if arr.size == 0:
        return {f"p{p}": 0.0 for p in ps}
    return {f"p{p}": round(float(np.percentile(arr, p)), 4) for p in ps}


def _span_durs(rec: dict, name: str) -> float:
    return sum(
        s.get("dur_ms", 0.0) for s in rec.get("spans", []) if s["name"] == name
    )


def summarize(records: list[dict], sla_ms: float | None = None) -> dict:
    """Aggregate a trace-record list into the report dict.

    ``sla_ms`` overrides the per-record ``sla_ms`` attribute; records with
    neither (unbudgeted runs) are excluded from compliance but counted
    everywhere else.
    """
    lat, queue, service, quanta, fidelity = [], [], [], [], []
    reasons: dict[str, int] = {}
    met = judged = 0
    inexact = 0
    alerts = 0
    queries: list[dict] = []
    for rec in records:
        # Drift-detector alert events share the trace stream (DESIGN.md
        # §14) — they are not queries.
        if rec.get("kind") == "alert":
            alerts += 1
            continue
        queries.append(rec)
    for rec in queries:
        latency = rec.get("latency_ms")
        if latency is not None:
            lat.append(float(latency))
            sla = sla_ms if sla_ms is not None else rec.get("sla_ms")
            if sla is not None and float(sla) != float("inf"):
                judged += 1
                if float(latency) <= float(sla):
                    met += 1
        q = _span_durs(rec, "queue")
        queue.append(q)
        service.append(_span_durs(rec, "service") or max(
            (rec.get("latency_ms") or 0.0) - q, 0.0
        ))
        if rec.get("quanta") is not None:
            quanta.append(int(rec["quanta"]))
        if rec.get("fidelity_bound") is not None:
            fidelity.append(int(rec["fidelity_bound"]))
        if rec.get("exact") is False:
            inexact += 1
        r = rec.get("exit_reason")
        if r is not None:
            reasons[r] = reasons.get(r, 0) + 1

    n = len(queries)
    qsum, ssum = float(np.sum(queue)), float(np.sum(service))
    total = qsum + ssum
    return {
        "queries": n,
        "alerts": alerts,
        "sla": {
            "judged": judged,
            "met": met,
            "compliance": round(met / judged, 4) if judged else None,
        },
        "latency_ms": _pcts(lat),
        "queue_wait_ms": _pcts(queue),
        "service_ms": _pcts(service),
        "queue_share": round(qsum / total, 4) if total > 0 else 0.0,
        "exit_reasons": dict(sorted(reasons.items())),
        "quanta": {
            "mean": round(float(np.mean(quanta)), 2) if quanta else None,
            **(_pcts(quanta) if quanta else {}),
        },
        "fidelity_bound": {
            "nonzero": int(np.count_nonzero(fidelity)) if fidelity else 0,
            **(_pcts(fidelity) if fidelity else {}),
        },
        "inexact": inexact,
    }


def render(summary: dict) -> str:
    """Human-readable rendering of ``summarize``'s output."""
    s = summary
    lines = [f"queries: {s['queries']}"]
    sla = s["sla"]
    if sla["judged"]:
        lines.append(
            f"SLA compliance: {sla['met']}/{sla['judged']} "
            f"({100.0 * sla['compliance']:.2f}%)"
        )
    else:
        lines.append("SLA compliance: n/a (no budgeted queries in trace)")
    lines.append(
        "latency ms   p50 {p50:>9.3f}  p95 {p95:>9.3f}  p99 {p99:>9.3f}".format(
            **s["latency_ms"]
        )
    )
    lines.append(
        "queue ms     p50 {p50:>9.3f}  p95 {p95:>9.3f}  p99 {p99:>9.3f}".format(
            **s["queue_wait_ms"]
        )
    )
    lines.append(
        "service ms   p50 {p50:>9.3f}  p95 {p95:>9.3f}  p99 {p99:>9.3f}".format(
            **s["service_ms"]
        )
    )
    lines.append(f"queue share of wall: {100.0 * s['queue_share']:.1f}%")
    if s["exit_reasons"]:
        mix = "  ".join(f"{k}={v}" for k, v in s["exit_reasons"].items())
        lines.append(f"exit reasons: {mix}")
    if s["quanta"].get("mean") is not None:
        lines.append(
            f"quanta/query: mean {s['quanta']['mean']} "
            f"p99 {s['quanta'].get('p99', 0)}"
        )
    fb = s["fidelity_bound"]
    if fb.get("p50") is not None:
        lines.append(
            f"fidelity bound: nonzero {fb['nonzero']}/{s['queries']}  "
            f"p50 {fb['p50']}  p95 {fb['p95']}  p99 {fb['p99']}"
        )
    if s["inexact"]:
        lines.append(f"inexact results: {s['inexact']}")
    if s.get("alerts"):
        lines.append(f"alert events in trace: {s['alerts']}")
    return "\n".join(lines)
