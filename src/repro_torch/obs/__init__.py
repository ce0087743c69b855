"""Observability substrate + operations layer: metrics, traces, SLOs.

``repro_torch.obs`` deliberately imports nothing from the rest of ``repro`` —
any layer (core engine through control plane) can depend on it without
cycles. The one object most callers need is ``Instrumentation`` (or the
shared ``NOOP`` default); see DESIGN.md §13. On top of the substrate sit
the operational components of DESIGN.md §14: the dispatch ``Profiler``,
declarative SLOs with burn-rate tracking (``slo``), online drift
detection (``detect``), and the ``watch``/``slo`` CLIs.

``SpanLog`` (attached as ``Instrumentation(..., spans=SpanLog())``, or
alone as ``SpanInstrumentation(SpanLog())``; never by ``make`` or
``NOOP``) records the process's own spans and counts, on the handle's
clock, at the port's layer boundaries:

  * ``MicroBatchServer.drain_once``: ``drain`` holding ``plan``,
    ``budget``, each launch's spans and ``feedback``; counts ``batches``
    and ``plan_blocks``;
  * ``BatchEngine._run_chunk``: ``stage``, ``launch``, ``read``,
    ``unpack``; counts ``launches``;
  * ``index_io.load_index`` and ``Engine``: ``load`` holding
    ``unpack_docs``; ``pack_docs``;
  * ``Engine.plan_many``: counts ``plan_passes`` (one a call, however many
    queries it plans).
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
from repro_torch.obs.instrument import (
    NOOP,
    Instrumentation,
    NoopInstrumentation,
    SpanInstrumentation,
)
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
from repro_torch.obs.trace import QueryTrace, SpanLog, Tracer, TraceSink, read_traces

__all__ = [
    "DEFAULT_CLOCK",
    "FakeClock",
    "Instrumentation",
    "NoopInstrumentation",
    "NOOP",
    "SpanInstrumentation",
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
    "SpanLog",
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
