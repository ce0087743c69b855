"""Declarative SLOs with error budgets and multi-window burn rates (§14).

The anytime contract the paper sells — "answer within the SLA, report the
fidelity you gave up" — becomes operable only once the raw telemetry of
DESIGN.md §13 is folded into *objectives*: what fraction of queries must
meet the SLA, how tight the fidelity bound must stay, how often results
must be exact, how available the plane must be. This module is that fold.

An :class:`SloSpec` names an objective (target good/total fraction) and a
*source* that reads cumulative ``(good, total)`` event counts out of the
live :class:`~repro_torch.obs.metrics.MetricsRegistry`:

  * :class:`HistogramBelow` — observations at or below a threshold, with
    linear interpolation inside the crossing log2 bucket (latency-SLA
    attainment over ``latency_ms``, fidelity-ceiling over
    ``fidelity_bound``);
  * :class:`CounterRatio` — one labeled counter subset over another
    (exactness rate over ``sharded_exact``);
  * :class:`GaugeTime` — time-weighted average of a 0..1 gauge, integrated
    between samples (availability over ``plane_available``, which the
    control plane drives from ``HealthLedger`` transitions).

The registry's histograms are cumulative and timestamp-free, so windowed
rates need an external time axis: :class:`SloTracker` keeps a ring of
clock-stamped source snapshots and differences them per window. Burn rate
follows the Google-SRE multi-window convention — with objective ``o`` and
windowed attainment ``a``, ``burn = (1 - a) / (1 - o)``; burn 1.0 spends
the error budget exactly at the objective boundary. Alerting state uses
two window pairs: *fast* (default 5m + 1h, both >= 14.4) and *slow*
(default 6h + 3d, both >= 6.0).

``evaluate()`` returns the full report **and** writes ``slo_*`` gauges
back into the registry, so the existing Prometheus/JSON exposition
(``repro_torch.obs.export``) carries SLO state with zero changes to its callers.
Offline, ``python -m repro_torch.obs slo trace.jsonl`` replays a recorded trace
through the same machinery (span timestamps are absolute clock readings).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.obs.metrics import (
    BUCKET_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "SloSpec",
    "SloTracker",
    "HistogramBelow",
    "CounterRatio",
    "GaugeTime",
    "cdf_below",
    "default_serving_slos",
    "replay_trace",
    "render_slo",
    "DEFAULT_WINDOWS",
    "FAST_BURN",
    "SLOW_BURN",
]

# Window name -> seconds. Ordered short to long; the first two form the
# fast-burn pair, the last two the slow-burn pair.
DEFAULT_WINDOWS: dict[str, float] = {
    "5m": 300.0,
    "1h": 3600.0,
    "6h": 21600.0,
    "3d": 259200.0,
}
FAST_BURN = 14.4  # both fast windows at/above -> page-grade ("fast_burn")
SLOW_BURN = 6.0  # both slow windows at/above -> ticket-grade ("slow_burn")

_STATE_CODE = {"ok": 0, "slow_burn": 1, "fast_burn": 2}


def cdf_below(buckets: list[int], threshold: float) -> float:
    """Observations <= ``threshold`` in a log2-bucket histogram.

    Buckets fully below the threshold count whole; the crossing bucket is
    linearly interpolated (same one-octave error model as the percentile
    reads). The overflow bucket only counts under an infinite threshold.
    Thresholds on a bucket edge are exact — tests pin that.
    """
    if threshold < 0:
        return 0.0
    good = 0.0
    for i, n in enumerate(buckets):
        if n == 0:
            continue
        lo = 0.0 if i == 0 else 2.0 ** (i - 1)
        hi = BUCKET_EDGES[i]
        if hi <= threshold:
            good += n
        elif lo <= threshold:
            if hi == float("inf"):
                continue  # overflow bucket: no interpolable mass
            good += n * (threshold - lo) / (hi - lo)
    return good


def _labels_match(key: tuple, want: dict | None) -> bool:
    if not want:
        return True
    have = dict(key)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


class HistogramBelow:
    """good = observations <= threshold; total = all observations."""

    def __init__(self, metric: str, threshold: float, labels: dict | None = None):
        self.metric = metric
        self.threshold = float(threshold)
        self.labels = labels

    def __call__(self, registry: MetricsRegistry, now: float):
        m = registry.metrics().get(self.metric)
        if not isinstance(m, Histogram):
            return 0.0, 0.0
        good = total = 0.0
        for key, st in m._samples.items():
            if not _labels_match(key, self.labels):
                continue
            good += cdf_below(st.buckets, self.threshold)
            total += st.count
        return good, total


class CounterRatio:
    """good = sum of one labeled counter subset; total = another."""

    def __init__(
        self,
        good_metric: str,
        total_metric: str,
        good_labels: dict | None = None,
        total_labels: dict | None = None,
    ):
        self.good_metric = good_metric
        self.total_metric = total_metric
        self.good_labels = good_labels
        self.total_labels = total_labels

    def _sum(self, registry: MetricsRegistry, metric: str, labels) -> float:
        m = registry.metrics().get(metric)
        if not isinstance(m, Counter):
            return 0.0
        return float(
            sum(
                v
                for key, v in m._samples.items()
                if _labels_match(key, labels)
            )
        )

    def __call__(self, registry: MetricsRegistry, now: float):
        return (
            self._sum(registry, self.good_metric, self.good_labels),
            self._sum(registry, self.total_metric, self.total_labels),
        )


class GaugeTime:
    """Time-weighted average of a 0..1 gauge (availability).

    Integrates between tracker samples: ``good`` accrues ``value * dt``
    seconds, ``total`` accrues ``dt``, using the gauge value held over the
    elapsed interval. Stateful — one instance per tracker.
    """

    def __init__(self, metric: str, labels: dict | None = None):
        self.metric = metric
        self.labels = labels
        self._last_t: float | None = None
        self._last_v = 1.0
        self._good = 0.0
        self._total = 0.0

    def _read(self, registry: MetricsRegistry) -> float:
        m = registry.metrics().get(self.metric)
        if not isinstance(m, Gauge):
            return 1.0  # unreported gauge -> assume up (no data, no burn)
        for key, v in m._samples.items():
            if _labels_match(key, self.labels):
                return float(v)
        return 1.0

    def __call__(self, registry: MetricsRegistry, now: float):
        if self._last_t is not None:
            dt = max(0.0, now - self._last_t)
            self._total += dt
            self._good += dt * min(max(self._last_v, 0.0), 1.0)
        self._last_t = now
        self._last_v = self._read(registry)
        return self._good, self._total


@dataclasses.dataclass
class SloSpec:
    """One objective: ``source`` must keep good/total >= ``objective``."""

    name: str
    objective: float  # target good/total fraction in (0, 1]
    source: object  # callable (registry, now) -> (good, total), cumulative
    description: str = ""


def _burn(attainment: float, objective: float) -> float:
    bad = 1.0 - attainment
    allowed = 1.0 - objective
    if allowed <= 0.0:
        return 0.0 if bad <= 0.0 else float("inf")
    return bad / allowed


class SloTracker:
    """Rings clock-stamped source snapshots; evaluates windowed burn rates.

    ``sample()`` reads every SLO source once and appends a snapshot;
    ``evaluate()`` differences the newest snapshot against the one at each
    window's horizon (falling back to the oldest available — early in a
    process the long windows degenerate to "since start", which is the
    conservative reading). Both are driven by the injected clock, so the
    whole pipeline is deterministic under ``FakeClock``.
    """

    def __init__(
        self,
        obs,
        slos: list[SloSpec],
        windows: dict[str, float] | None = None,
        fast_burn: float = FAST_BURN,
        slow_burn: float = SLOW_BURN,
        clock=None,
    ):
        if not slos:
            raise ValueError("SloTracker needs at least one SloSpec")
        self.obs = obs
        self.slos = list(slos)
        self.windows = dict(windows) if windows else dict(DEFAULT_WINDOWS)
        if not self.windows:
            raise ValueError("SloTracker needs at least one window")
        names = sorted(self.windows, key=self.windows.__getitem__)
        self._fast_pair = names[: min(2, len(names))]
        self._slow_pair = names[-min(2, len(names)) :]
        self._longest = names[-1]
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.clock = clock if clock is not None else obs.clock
        self._ring: deque = deque()
        self._horizon = max(self.windows.values()) * 1.25

    # ------------------------------------------------------------- samples
    def sample(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        registry = self.obs.metrics
        snap = {s.name: s.source(registry, now) for s in self.slos}
        self._ring.append((now, snap))
        while self._ring and self._ring[0][0] < now - self._horizon:
            self._ring.popleft()

    def _delta(self, name: str, window_s: float):
        t_cur, cur = self._ring[-1]
        base = self._ring[0]
        horizon = t_cur - window_s
        # Fast path: the window predates every snapshot (short process,
        # long window) — the oldest snapshot is the base, no scan. Keeps
        # evaluate() O(windows) instead of O(ring) per serving-loop poll.
        if base[0] > horizon:
            pass
        else:
            for t, snap in reversed(self._ring):
                if t <= horizon:
                    base = (t, snap)
                    break
        g0, n0 = base[1][name]
        g1, n1 = cur[name]
        return max(0.0, g1 - g0), max(0.0, n1 - n0)

    # ------------------------------------------------------------ evaluate
    def evaluate(self, now: float | None = None) -> dict:
        """Windowed attainment/burn per SLO; writes ``slo_*`` gauges."""
        if not self._ring:
            self.sample(now)
        report: dict = {}
        for spec in self.slos:
            windows = {}
            for wname, wsec in self.windows.items():
                good, total = self._delta(spec.name, wsec)
                attainment = good / total if total > 0 else 1.0
                windows[wname] = {
                    "good": round(good, 6),
                    "total": round(total, 6),
                    "attainment": round(attainment, 6),
                    "burn": round(_burn(attainment, spec.objective), 6),
                }
            fast = all(
                windows[w]["burn"] >= self.fast_burn for w in self._fast_pair
            )
            slow = all(
                windows[w]["burn"] >= self.slow_burn for w in self._slow_pair
            )
            state = "fast_burn" if fast else ("slow_burn" if slow else "ok")
            long_burn = windows[self._longest]["burn"]
            budget_remaining = max(0.0, 1.0 - long_burn)
            report[spec.name] = {
                "objective": spec.objective,
                "description": spec.description,
                "windows": windows,
                "events": windows[self._longest]["total"],
                "attainment": windows[self._longest]["attainment"],
                "budget_remaining": round(budget_remaining, 6),
                "state": state,
            }
            obs = self.obs
            obs.gauge("slo_attainment", report[spec.name]["attainment"], slo=spec.name)
            for wname, w in windows.items():
                obs.gauge("slo_burn_rate", w["burn"], slo=spec.name, window=wname)
            obs.gauge(
                "slo_error_budget_remaining", budget_remaining, slo=spec.name
            )
            obs.gauge("slo_state", _STATE_CODE[state], slo=spec.name)
        return report


def default_serving_slos(
    sla_ms: float | None = None,
    latency_objective: float = 0.99,
    fidelity_ceiling: float | None = None,
    fidelity_objective: float = 0.95,
    exactness_objective: float = 0.90,
    availability_objective: float = 0.999,
) -> list[SloSpec]:
    """The four paper-shaped serving SLOs over the standard metric names."""
    slos: list[SloSpec] = []
    if sla_ms is not None and sla_ms != float("inf"):
        slos.append(
            SloSpec(
                "latency_sla",
                latency_objective,
                HistogramBelow("latency_ms", sla_ms),
                f"queries served within the {sla_ms:g} ms SLA",
            )
        )
    if fidelity_ceiling is not None:
        slos.append(
            SloSpec(
                "fidelity_ceiling",
                fidelity_objective,
                HistogramBelow("fidelity_bound", fidelity_ceiling),
                f"fidelity bounds at or below {fidelity_ceiling:g}",
            )
        )
    slos.append(
        SloSpec(
            "exactness",
            exactness_objective,
            CounterRatio(
                "sharded_exact", "sharded_exact", good_labels={"exact": True}
            ),
            "sharded results carrying an exactness certificate",
        )
    )
    slos.append(
        SloSpec(
            "availability",
            availability_objective,
            GaugeTime("plane_available"),
            "time-weighted fraction with every shard up",
        )
    )
    return slos


def _record_time_s(rec: dict, fallback: float) -> float:
    """A record's completion time from its absolute span clocks."""
    spans = rec.get("spans") or []
    ends = [
        s["t0_ms"] + s.get("dur_ms", 0.0) for s in spans if "t0_ms" in s
    ]
    return max(ends) / 1e3 if ends else fallback


def replay_trace(
    records: list[dict],
    sla_ms: float | None = None,
    fidelity_ceiling: float | None = None,
    windows: dict[str, float] | None = None,
) -> dict:
    """Burn-rate report over a recorded trace (the ``slo`` CLI core).

    Replays query records in completion order (span timestamps are
    absolute readings of the recording process's clock) through a fresh
    registry + :class:`SloTracker`, sampling after every record, then
    evaluates at the final timestamp. Alert records (``kind="alert"``)
    are skipped as SLO events but counted. With no ``sla_ms`` override
    the per-record ``sla_ms`` attribute's maximum is used; if neither
    exists the latency SLO is omitted.
    """
    from repro_torch.obs.instrument import Instrumentation

    alerts = [r for r in records if r.get("kind") == "alert"]
    queries = [r for r in records if r.get("kind") != "alert"]
    times: list[float] = []
    t = 0.0
    for rec in queries:
        t = _record_time_s(rec, t)
        times.append(t)
    order = sorted(range(len(queries)), key=times.__getitem__)

    if sla_ms is None:
        recorded = [r["sla_ms"] for r in queries if "sla_ms" in r]
        sla_ms = max(recorded) if recorded else None
    if fidelity_ceiling is None:
        bounds = [r["fidelity_bound"] for r in queries if "fidelity_bound" in r]
        fidelity_ceiling = max(bounds) if bounds else None

    obs = Instrumentation()
    slos = default_serving_slos(
        sla_ms=sla_ms, fidelity_ceiling=fidelity_ceiling
    )
    tracker = SloTracker(obs, slos, windows=windows)
    t0 = times[order[0]] if order else 0.0
    tracker.sample(now=t0)
    last = t0
    for i in order:
        rec = queries[i]
        if "latency_ms" in rec:
            obs.observe("latency_ms", rec["latency_ms"])
        if "fidelity_bound" in rec:
            obs.observe("fidelity_bound", rec["fidelity_bound"])
        if "exact" in rec:
            obs.count("sharded_exact", exact=bool(rec["exact"]))
        last = times[i]
        tracker.sample(now=last)
    report = tracker.evaluate(now=last)
    return {
        "queries": len(queries),
        "alerts": len(alerts),
        "span_s": round(max(0.0, last - t0), 6),
        "sla_ms": sla_ms,
        "fidelity_ceiling": fidelity_ceiling,
        "slos": report,
    }


def render_slo(report: dict) -> str:
    """Human-readable ``slo`` CLI output."""
    lines = [
        f"queries: {report['queries']}  alerts: {report['alerts']}  "
        f"span: {report['span_s']:.3f}s"
    ]
    for name, rep in sorted(report["slos"].items()):
        lines.append(
            f"{name}: objective={rep['objective']:g} "
            f"attainment={rep['attainment']:.4f} "
            f"budget_remaining={rep['budget_remaining']:.4f} "
            f"state={rep['state']}"
        )
        for wname, w in rep["windows"].items():
            lines.append(
                f"  {wname:>4}: good={w['good']:.1f}/{w['total']:.1f} "
                f"attain={w['attainment']:.4f} burn={w['burn']:.3f}"
            )
    return "\n".join(lines)
