"""Exposition: Prometheus text format and a JSON snapshot (DESIGN.md §13).

``prometheus_text`` renders a ``MetricsRegistry`` in the Prometheus
text-based exposition format (version 0.0.4): counters as ``<name>_total``,
gauges verbatim, histograms as cumulative ``<name>_bucket{le="..."}``
series plus ``_sum``/``_count`` — so the process can be scraped by
anything Prometheus-shaped without taking a client-library dependency
(nothing to ``pip install``; the format is ~30 lines of string building).

``json_snapshot`` is the machine-readable sibling a benchmark attaches to
its result file so the perf trajectory carries internal counters
(exit-reason mix, quanta, occupancy), not just headline q/s.

``write_snapshot`` serializes the registry (plus optional SLO report and
alert tail) to a file atomically — the handoff surface between a serving
process and the ``python -m repro_torch.obs watch`` dashboard, which re-reads
the file at an interval from a separate process.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.metrics import (
    BUCKET_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = ["prometheus_text", "json_snapshot", "write_snapshot"]


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = [f'{k}="{v}"' for k, v in key] + [f'{k}="{v}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(metrics: MetricsRegistry) -> str:
    """Render every metric in Prometheus text exposition format."""
    lines: list[str] = []
    for name, metric in sorted(metrics.metrics().items()):
        if metric.help:
            lines.append(f"# HELP {name} {metric.help}")
        if isinstance(metric, Counter):
            lines.append(f"# TYPE {name} counter")
            for key in metric._samples:
                lines.append(
                    f"{name}_total{_fmt_labels(key)} "
                    f"{_fmt_value(metric._samples[key])}"
                )
        elif isinstance(metric, Gauge):
            lines.append(f"# TYPE {name} gauge")
            for key in metric._samples:
                lines.append(
                    f"{name}{_fmt_labels(key)} "
                    f"{_fmt_value(metric._samples[key])}"
                )
        elif isinstance(metric, Histogram):
            lines.append(f"# TYPE {name} histogram")
            for key, st in metric._samples.items():
                cum = 0
                for i, n in enumerate(st.buckets):
                    cum += n
                    if n == 0 and BUCKET_EDGES[i] != float("inf"):
                        continue  # sparse: emit touched buckets plus +Inf
                    le = _fmt_value(BUCKET_EDGES[i])
                    lines.append(
                        f"{name}_bucket{_fmt_labels(key, (('le', le),))} {cum}"
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(key)} {_fmt_value(st.sum)}"
                )
                lines.append(f"{name}_count{_fmt_labels(key)} {st.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(metrics: MetricsRegistry, indent: int | None = None) -> str:
    """The registry's full state as a JSON document."""
    return json.dumps(metrics.snapshot(), indent=indent, sort_keys=True)


def write_snapshot(
    path: str,
    metrics: MetricsRegistry,
    slo: dict | None = None,
    alerts: list | None = None,
    profiler: dict | None = None,
    t: float | None = None,
) -> None:
    """Atomically write a dashboard snapshot file (tmp + rename).

    The reader (``watch`` CLI) therefore always sees a complete JSON
    document, never a torn write. ``alerts`` is a list of alert-event
    dicts (newest last); ``slo`` is an ``SloTracker.evaluate()`` report;
    ``profiler`` a ``Profiler.snapshot()``.
    """
    doc = {"t": t, "metrics": metrics.snapshot()}
    if slo is not None:
        doc["slo"] = slo
    if alerts is not None:
        doc["alerts"] = list(alerts)
    if profiler is not None:
        doc["profiler"] = profiler
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, sort_keys=True)
    os.replace(tmp, path)
