"""Process-local metrics registry: counters, gauges, log2 histograms.

The serving stack needs in-process metrics that are cheap enough to sit on
the per-query path (the acceptance bar is < 5% q/s overhead at full
instrumentation) and rich enough to answer the paper's operating
questions — SLA compliance rate, queue-wait vs service split, exit-reason
mix, fidelity-bound percentiles — without retaining per-query state.

Three metric kinds, all labeled:

  * ``Counter`` — monotone float per label set (``inc``);
  * ``Gauge`` — last-write-wins float per label set (``set``);
  * ``Histogram`` — fixed log2 buckets per label set (``observe``).

Histogram layout (DESIGN.md §13): values land in 64 fixed buckets with
upper edges ``[1, 2, 4, ..., 2^62, +inf]`` — bucket ``i`` holds
``2^(i-1) <= v < 2^i`` for ``i >= 1`` and ``v < 1`` (including negatives
clamped to 0) in bucket 0. One ``int64`` add per observation, O(buckets) =
O(1) percentile reads regardless of sample count, and the per-bucket
``sum`` makes the mean exact. Quantiles interpolate linearly inside the
crossing bucket, so p50/p95/p99 carry at most one-octave error — the right
trade for latency distributions whose interesting structure is
multiplicative.

Everything is process-local and lock-free by design: the serving loops are
single-threaded per process, and cross-process aggregation happens at the
exposition layer (``repro_torch.obs.export``), never here. No globals — a
registry is constructed and threaded explicitly (``Instrumentation``).
"""

from __future__ import annotations

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "N_BUCKETS"]

N_BUCKETS = 64  # bucket 0: v < 1; bucket i: 2^(i-1) <= v < 2^i; last: overflow

# Upper (exclusive) edge of every bucket; the final edge is +inf.
BUCKET_EDGES = [2.0**i for i in range(N_BUCKETS - 1)] + [float("inf")]


def bucket_index(value: float) -> int:
    """O(1) log2 bucket for ``value`` (negatives clamp into bucket 0)."""
    v = int(value)
    if v < 1:
        return 0
    return min(v.bit_length(), N_BUCKETS - 1)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Labeled:
    """Shared label-set bookkeeping for every metric kind."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._samples: dict[tuple, object] = {}

    def labelsets(self) -> list[tuple]:
        return list(self._samples.keys())


class Counter(_Labeled):
    """Monotone labeled counter."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._samples[key] = self._samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))

    def total(self) -> float:
        return float(sum(self._samples.values()))

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "help": self.help,
            "samples": {
                ",".join(f"{k}={v}" for k, v in key) or "": val
                for key, val in self._samples.items()
            },
        }


class Gauge(_Labeled):
    """Last-write-wins labeled gauge."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._samples[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "help": self.help,
            "samples": {
                ",".join(f"{k}={v}" for k, v in key) or "": val
                for key, val in self._samples.items()
            },
        }


class _HistState:
    __slots__ = ("buckets", "count", "sum")

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0


class Histogram(_Labeled):
    """Fixed-bucket log2 histogram with O(1) percentile reads."""

    kind = "histogram"

    def _state(self, labels: dict) -> _HistState:
        key = _label_key(labels)
        st = self._samples.get(key)
        if st is None:
            st = self._samples[key] = _HistState()
        return st

    def observe(self, value: float, **labels) -> None:
        st = self._state(labels)
        st.buckets[bucket_index(value)] += 1
        st.count += 1
        st.sum += value

    def count(self, **labels) -> int:
        key = _label_key(labels)
        st = self._samples.get(key)
        return st.count if st else 0

    def mean(self, **labels) -> float:
        key = _label_key(labels)
        st = self._samples.get(key)
        return st.sum / st.count if st and st.count else 0.0

    def percentile(self, p: float, **labels) -> float:
        """Linear interpolation inside the crossing log2 bucket.

        O(N_BUCKETS) — constant in the number of observations. Returns 0.0
        for an empty histogram.
        """
        st = self._samples.get(_label_key(labels))
        return _percentile_of(st, p) if st else 0.0

    def snapshot(self) -> dict:
        out = {}
        for key, st in self._samples.items():
            out[",".join(f"{k}={v}" for k, v in key) or ""] = {
                "count": st.count,
                "sum": round(st.sum, 6),
                "mean": round(st.sum / st.count, 6) if st.count else 0.0,
                "p50": round(_percentile_of(st, 50.0), 6),
                "p95": round(_percentile_of(st, 95.0), 6),
                "p99": round(_percentile_of(st, 99.0), 6),
                "buckets": {
                    str(BUCKET_EDGES[i]): n
                    for i, n in enumerate(st.buckets)
                    if n
                },
            }
        return {"kind": self.kind, "help": self.help, "samples": out}


def _percentile_of(st: _HistState, p: float) -> float:
    if st.count == 0:
        return 0.0
    target = st.count * min(max(p, 0.0), 100.0) / 100.0
    cum = 0
    for i, n in enumerate(st.buckets):
        if n == 0:
            continue
        if cum + n >= target:
            lo = 0.0 if i == 0 else 2.0 ** (i - 1)
            hi = BUCKET_EDGES[i]
            if hi == float("inf"):
                return lo  # overflow bucket: report its floor
            frac = (target - cum) / n
            return lo + (hi - lo) * frac
        cum += n
    return BUCKET_EDGES[-2]  # unreachable: cum covers count by the last bucket


class MetricsRegistry:
    """Named metric store. ``counter``/``gauge``/``histogram`` get-or-create
    (idempotent per name — re-registration returns the live metric, so every
    layer holding the same registry shares one time series per name)."""

    def __init__(self):
        self._metrics: dict[str, _Labeled] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"wanted {cls.kind}"
            )
        elif help and not m.help:
            # Backfill: a metric first touched through the raw registry
            # (empty help) adopts the catalog help the moment an
            # Instrumentation call names it.
            m.help = help
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def metrics(self) -> dict:
        return dict(self._metrics)

    def missing_help(self) -> list[str]:
        """Names of registered metrics with an empty help string (the
        registry-wide "no undocumented metric" test hook)."""
        return sorted(n for n, m in self._metrics.items() if not m.help)

    def snapshot(self) -> dict:
        """JSON-able state of every metric (the BENCH_*.json attachment)."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}
