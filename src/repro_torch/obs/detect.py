"""Online drift/anomaly detection over the live metrics registry (§14).

The control plane's operational questions — "is one shard hot", "is the
queue building", "did the exit-reason mix shift", "is service time
drifting" — are all answerable from the registry the serving layers
already populate. This module closes the loop: lightweight online
detectors poll derived signals and emit structured **alert events** into
the same ``TraceSink`` JSONL stream the query traces use, plus a
subscription hook the ``ControlPlane`` registers to (a sustained
per-shard skew alert arms ``maybe_reshard``; a sustained burn-rate alert
marks the plane's degraded-SLO state).

Two detector kinds, both with fire/clear hysteresis (``patience``
consecutive anomalous samples to fire, ``clear_patience`` normal samples
to clear) so a single noisy poll can neither page nor silence:

  * :class:`EwmaDetector` — exponentially-weighted mean + variance,
    firing on ``|z| >= z_fire``. Adaptation freezes on anomalous samples
    (the baseline must not chase the anomaly it is reporting) and a
    relative/absolute std floor keeps z finite on constant baselines.
  * :class:`ThresholdDetector` — plain level threshold with the same
    hysteresis, for signals that are already ratios (shard skew, burn
    rate) where "normal" has a known scale.

:class:`DriftMonitor` owns the detectors, pairs each with a *probe*
(callable ``registry -> float | None``; ``None`` = no data this poll) and
fans alert events out to the sink, an ``alerts`` counter, and subscribers.
Probes for the standard signals (histogram p99, gauge level, counter
rates, exit-reason share, per-shard postings skew) are provided below;
rate-style probes keep last-poll state internally, so one probe instance
belongs to one monitor. Everything is driven by the injected clock —
deterministic under ``FakeClock``.
"""

from __future__ import annotations

import math

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "AlertEvent",
    "EwmaDetector",
    "ThresholdDetector",
    "DriftMonitor",
    "hist_percentile_probe",
    "gauge_probe",
    "counter_rate_probe",
    "counter_share_probe",
    "ShardSkewProbe",
    "default_serving_detectors",
]


class AlertEvent:
    """One fire/clear transition, JSONL-serializable (``kind="alert"``)."""

    __slots__ = ("detector", "state", "value", "zscore", "mean", "t", "labels")

    def __init__(
        self,
        detector: str,
        state: str,
        value: float,
        t: float,
        zscore: float | None = None,
        mean: float | None = None,
        labels: dict | None = None,
    ):
        self.detector = detector
        self.state = state  # "fire" | "clear"
        self.value = value
        self.zscore = zscore
        self.mean = mean
        self.t = t
        self.labels = labels or {}

    def to_dict(self) -> dict:
        out = {
            "kind": "alert",
            "detector": self.detector,
            "state": self.state,
            "value": round(float(self.value), 6),
            "t_ms": round(self.t * 1e3, 4),
        }
        if self.zscore is not None:
            out["zscore"] = round(float(self.zscore), 4)
        if self.mean is not None:
            out["mean"] = round(float(self.mean), 6)
        if self.labels:
            out.update(self.labels)
        return out


class _Hysteresis:
    """Shared fire/clear streak logic."""

    def __init__(self, name: str, patience: int, clear_patience: int):
        self.name = name
        self.patience = max(1, int(patience))
        self.clear_patience = max(1, int(clear_patience))
        self.firing = False
        self._hot = 0
        self._cool = 0

    def _step(self, anomalous: bool) -> str | None:
        """Returns "fire"/"clear" on a state transition, else None."""
        if anomalous:
            self._hot += 1
            self._cool = 0
            if not self.firing and self._hot >= self.patience:
                self.firing = True
                return "fire"
        else:
            self._cool += 1
            self._hot = 0
            if self.firing and self._cool >= self.clear_patience:
                self.firing = False
                return "clear"
        return None


class EwmaDetector(_Hysteresis):
    """EWMA mean/variance z-score detector with frozen-baseline hysteresis."""

    def __init__(
        self,
        name: str,
        alpha: float = 0.1,
        z_fire: float = 4.0,
        patience: int = 3,
        clear_patience: int = 3,
        min_samples: int = 8,
        direction: str = "both",  # "both" | "above" | "below"
        rel_floor: float = 0.05,
        abs_floor: float = 1e-9,
    ):
        super().__init__(name, patience, clear_patience)
        self.alpha = alpha
        self.z_fire = z_fire
        self.min_samples = max(1, int(min_samples))
        self.direction = direction
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor
        self._n = 0
        self.mean = 0.0
        self._var = 0.0

    def _z(self, value: float) -> float:
        std = math.sqrt(max(self._var, 0.0))
        floor = max(abs(self.mean) * self.rel_floor, self.abs_floor)
        return (value - self.mean) / max(std, floor)

    def update(self, value: float, now: float) -> AlertEvent | None:
        value = float(value)
        if self._n < self.min_samples:
            # Warm-up: adopt the sample into the baseline, never alert.
            self._absorb(value)
            return None
        z = self._z(value)
        if self.direction == "above":
            anomalous = z >= self.z_fire
        elif self.direction == "below":
            anomalous = -z >= self.z_fire
        else:
            anomalous = abs(z) >= self.z_fire
        if not anomalous:
            self._absorb(value)  # freeze baseline while anomalous
        transition = self._step(anomalous)
        if transition is None:
            return None
        return AlertEvent(
            self.name, transition, value, now, zscore=z, mean=self.mean
        )

    def _absorb(self, value: float) -> None:
        if self._n == 0:
            self.mean = value
        else:
            d = value - self.mean
            self.mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        self._n += 1


class ThresholdDetector(_Hysteresis):
    """Level threshold with hysteresis, for ratio-scaled signals."""

    def __init__(
        self,
        name: str,
        threshold: float,
        patience: int = 3,
        clear_patience: int = 3,
        direction: str = "above",
    ):
        super().__init__(name, patience, clear_patience)
        self.threshold = float(threshold)
        self.direction = direction

    def update(self, value: float, now: float) -> AlertEvent | None:
        value = float(value)
        if self.direction == "above":
            anomalous = value >= self.threshold
        else:
            anomalous = value <= self.threshold
        transition = self._step(anomalous)
        if transition is None:
            return None
        return AlertEvent(self.name, transition, value, now)


# --------------------------------------------------------------------------
# Probes: registry -> signal value (None = no data this poll)
# --------------------------------------------------------------------------


def hist_percentile_probe(metric: str, p: float = 99.0, **labels):
    def probe(registry: MetricsRegistry):
        m = registry.metrics().get(metric)
        if not isinstance(m, Histogram) or m.count(**labels) == 0:
            return None
        return m.percentile(p, **labels)

    return probe


def gauge_probe(metric: str, **labels):
    def probe(registry: MetricsRegistry):
        m = registry.metrics().get(metric)
        if not isinstance(m, Gauge):
            return None
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        v = m._samples.get(key)
        return None if v is None else float(v)

    return probe


def counter_rate_probe(metric: str, clock, **labels):
    """Delta of a counter between polls, per second (stateful)."""
    state = {"t": None, "v": None}

    def probe(registry: MetricsRegistry):
        m = registry.metrics().get(metric)
        if not isinstance(m, Counter):
            return None
        now, v = clock(), m.value(**labels)
        t0, v0 = state["t"], state["v"]
        state["t"], state["v"] = now, v
        if t0 is None or now <= t0:
            return None
        return (v - v0) / (now - t0)

    return probe


def counter_share_probe(metric: str, part_labels: dict, **total_labels):
    """Share of a labeled counter subset in the total, over poll deltas.

    Tracks the exit-reason *mix*: e.g. the fraction of queries served with
    ``reason="budget"`` since the last poll. Returns None until the total
    moved.
    """
    state = {"part": None, "total": None}

    def _sum(m: Counter, labels: dict) -> float:
        want = {str(k): str(v) for k, v in labels.items()}
        return float(
            sum(
                v
                for key, v in m._samples.items()
                if all(dict(key).get(k) == w for k, w in want.items())
            )
        )

    def probe(registry: MetricsRegistry):
        m = registry.metrics().get(metric)
        if not isinstance(m, Counter):
            return None
        part = _sum(m, {**total_labels, **part_labels})
        total = _sum(m, total_labels)
        p0, t0 = state["part"], state["total"]
        state["part"], state["total"] = part, total
        if p0 is None or total <= t0:
            return None
        return (part - p0) / (total - t0)

    return probe


class ShardSkewProbe:
    """max/mean per-shard postings rate since the last poll (>= 1.0).

    Reads the control plane's ``shard_postings{shard=...}`` counters;
    returns None until every shard has reported and the deltas are
    nonzero. A balanced plane sits near 1.0; sustained values above the
    reshard trigger mean one shard is eating the workload.
    """

    def __init__(self, n_shards: int, metric: str = "shard_postings"):
        self.n_shards = int(n_shards)
        self.metric = metric
        self._last: list[float] | None = None

    def __call__(self, registry: MetricsRegistry):
        m = registry.metrics().get(self.metric)
        if not isinstance(m, Counter):
            return None
        cur = [m.value(shard=s) for s in range(self.n_shards)]
        last, self._last = self._last, cur
        if last is None:
            return None
        deltas = [max(0.0, c - p) for c, p in zip(cur, last)]
        total = sum(deltas)
        if total <= 0.0:
            return None
        mean = total / self.n_shards
        return max(deltas) / mean


class DriftMonitor:
    """Polls probes, runs detectors, fans out alert events.

    Alerts go three places: the ``alerts`` counter in the registry, the
    TraceSink JSONL stream (interleaved with query traces, tagged
    ``kind="alert"`` — the report/slo CLIs skip them), and every
    ``subscribe``d callback (the ``ControlPlane`` hook). ``poll()`` is
    cheap enough for a per-drain cadence: O(detectors) registry reads,
    no per-query state.
    """

    def __init__(self, obs, sink=None, clock=None):
        self.obs = obs
        self.sink = sink if sink is not None else getattr(
            getattr(obs, "tracer", None), "sink", None
        )
        self.clock = clock if clock is not None else obs.clock
        self._entries: list[tuple] = []  # (detector, probe)
        self._subscribers: list = []
        self.events: list[AlertEvent] = []

    def add(self, detector, probe) -> None:
        self._entries.append((detector, probe))

    def subscribe(self, fn) -> None:
        self._subscribers.append(fn)

    def firing(self) -> list[str]:
        return [d.name for d, _ in self._entries if d.firing]

    def poll(self, now: float | None = None) -> list[AlertEvent]:
        now = self.clock() if now is None else now
        registry = self.obs.metrics
        fired: list[AlertEvent] = []
        for detector, probe in self._entries:
            value = probe(registry)
            if value is None:
                continue
            event = detector.update(value, now)
            if event is not None:
                self._emit(event)
                fired.append(event)
        return fired

    def _emit(self, event: AlertEvent) -> None:
        self.events.append(event)
        self.obs.count("alerts", detector=event.detector, state=event.state)
        if self.sink is not None:
            self.sink.append(event.to_dict())
        for fn in self._subscribers:
            fn(event)


def default_serving_detectors(
    monitor: DriftMonitor,
    n_shards: int | None = None,
    server: str | None = None,
    skew_threshold: float = 2.0,
    burn_threshold: float = 14.4,
) -> DriftMonitor:
    """Wire the standard signal set into ``monitor`` and return it.

    p99 service time and queue depth (EWMA z-score), budget-exit share
    (EWMA on the exit-reason mix), per-shard postings skew and SLO fast
    burn (thresholds). ``server`` narrows the server-labeled signals;
    shard skew needs ``n_shards``.
    """
    labels = {"server": server} if server else {}
    monitor.add(
        EwmaDetector("p99_service_ms", direction="above"),
        hist_percentile_probe(
            "step_ms" if server == "inflight" else "batch_ms", 99.0
        ),
    )
    monitor.add(
        EwmaDetector("queue_depth", direction="above"),
        gauge_probe("queue_depth", **labels),
    )
    monitor.add(
        EwmaDetector("budget_exit_share", direction="above", z_fire=3.0),
        counter_share_probe(
            "served_queries", {"reason": "budget"}, **labels
        ),
    )
    if n_shards and n_shards > 1:
        monitor.add(
            ThresholdDetector("shard_skew", skew_threshold, patience=3),
            ShardSkewProbe(n_shards),
        )
    monitor.add(
        ThresholdDetector("slo_fast_burn", burn_threshold, patience=2),
        gauge_probe("slo_burn_rate", slo="latency_sla", window="5m"),
    )
    return monitor
