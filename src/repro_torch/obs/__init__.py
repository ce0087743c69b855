"""Observability substrate + operations layer: metrics, traces, SLOs.

``repro_torch.obs`` deliberately imports nothing from the rest of ``repro`` —
any layer (core engine through control plane) can depend on it without
cycles. The one object most callers need is ``Instrumentation`` (or the
shared ``NOOP`` default); see DESIGN.md §13. On top of the substrate sit
the operational components of DESIGN.md §14: the dispatch ``Profiler``,
declarative SLOs with burn-rate tracking (``slo``), online drift
detection (``detect``), and the ``watch``/``slo`` CLIs.
"""

from repro_torch.obs.catalog import METRIC_HELP, help_for
from repro_torch.obs.clock import DEFAULT_CLOCK, FakeClock
from repro_torch.obs.detect import (
    AlertEvent,
    DriftMonitor,
    EwmaDetector,
    ShardSkewProbe,
    ThresholdDetector,
)
from repro_torch.obs.export import json_snapshot, prometheus_text, write_snapshot
from repro_torch.obs.instrument import NOOP, Instrumentation, NoopInstrumentation
from repro_torch.obs.metrics import (
    N_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profiler import Profiler, jit_cache_size
from repro_torch.obs.report import render, summarize
from repro_torch.obs.slo import (
    CounterRatio,
    GaugeTime,
    HistogramBelow,
    SloSpec,
    SloTracker,
    default_serving_slos,
)
from repro_torch.obs.trace import QueryTrace, Tracer, TraceSink, read_traces

__all__ = [
    "DEFAULT_CLOCK",
    "FakeClock",
    "Instrumentation",
    "NoopInstrumentation",
    "NOOP",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "N_BUCKETS",
    "METRIC_HELP",
    "help_for",
    "Tracer",
    "TraceSink",
    "QueryTrace",
    "read_traces",
    "prometheus_text",
    "json_snapshot",
    "write_snapshot",
    "summarize",
    "render",
    "Profiler",
    "jit_cache_size",
    "SloSpec",
    "SloTracker",
    "HistogramBelow",
    "CounterRatio",
    "GaugeTime",
    "default_serving_slos",
    "AlertEvent",
    "EwmaDetector",
    "ThresholdDetector",
    "ShardSkewProbe",
    "DriftMonitor",
]
