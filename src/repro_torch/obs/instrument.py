"""The ``Instrumentation`` handle every serving layer threads through.

One object bundles the observability substrates — a ``MetricsRegistry``,
an optional ``Tracer``, the injected clock, and an optional profiler and
``SpanLog`` — so a constructor signature stays one keyword:
``MicroBatchServer(..., obs=...)``. No globals anywhere: layers receive
the handle explicitly and share time series by sharing the handle (metric
registration is idempotent by name).

The default is ``NOOP``, a shared do-nothing instance whose every method
returns immediately and whose ``enabled`` flag is False — hot loops guard
their per-item instrumentation blocks with ``if obs.enabled`` so an
uninstrumented server pays one attribute read per batch, nothing per
query. Instrumentation must not change results: nothing in this module
touches budgets, plans, or device inputs, so instrumented results are
bitwise identical by construction (pinned in tests/test_torch_obs.py).
"""

from __future__ import annotations

from repro_torch.obs.catalog import help_for
from repro_torch.obs.clock import DEFAULT_CLOCK
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiler import Profiler
from repro_torch.obs.trace import SpanLog, Tracer, TraceSink

__all__ = ["Instrumentation", "NoopInstrumentation", "NOOP", "SpanInstrumentation"]


class Instrumentation:
    """Live metrics + tracing + clock bundle (+ optional profiler and span log).

    ``spans``, a ``SpanLog``, receives the serving loop's own spans and
    counts (a drain and the launches and host work inside it, an index
    load), stamped from ``clock``; the sites read the clock for them only
    when it is attached. ``SpanInstrumentation`` attaches one with no
    metrics or tracer, so the spans time the serving loop and not the
    registry's per-query updates.
    """

    enabled = True

    def __init__(
        self,
        metrics: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        clock=DEFAULT_CLOCK,
        profiler: Profiler | None = None,
        spans: SpanLog | None = None,
    ):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self.clock = clock
        self.profiler = profiler
        self.spans = spans

    @classmethod
    def make(
        cls,
        sample_rate: float = 1.0,
        trace_path: str | None = None,
        ring: int = 1024,
        clock=DEFAULT_CLOCK,
        profile: bool = False,
    ) -> "Instrumentation":
        """Convenience constructor: metrics + a tracer (+ JSONL sink).

        ``profile=True`` attaches a :class:`~repro_torch.obs.profiler.Profiler`;
        the serving dispatch sites pick it up via ``obs.profiler`` and add
        compile tracking + the host/device/transfer time split.
        """
        sink = TraceSink(trace_path) if trace_path else None
        obs = cls(
            MetricsRegistry(),
            Tracer(sample_rate=sample_rate, ring=ring, sink=sink),
            clock=clock,
        )
        if profile:
            obs.profiler = Profiler(obs)
        return obs

    # -------------------------------------------------------------- metrics
    def count(self, name: str, value: float = 1.0, **labels) -> None:
        self.metrics.counter(name, help_for(name)).inc(value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.metrics.gauge(name, help_for(name)).set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.metrics.histogram(name, help_for(name)).observe(value, **labels)

    # -------------------------------------------------------------- tracing
    def trace_begin(self, rid: int) -> None:
        if self.tracer is not None:
            self.tracer.begin(rid)

    def trace_span(
        self, rid: int, name: str, t0: float, t1: float, **attrs
    ) -> None:
        if self.tracer is not None:
            tr = self.tracer.get(rid)
            if tr is not None:
                tr.span(name, t0, t1, **attrs)

    def trace_attr(self, rid: int, **attrs) -> None:
        if self.tracer is not None:
            tr = self.tracer.get(rid)
            if tr is not None:
                tr.attrs.update(attrs)

    def trace_end(self, rid: int) -> None:
        if self.tracer is not None:
            self.tracer.end(rid)

    # ------------------------------------------------------------ lifecycle
    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def close(self) -> None:
        if self.tracer is not None:
            self.tracer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NoopInstrumentation(Instrumentation):
    """Shared default: every hook is a no-op, ``enabled`` is False.

    Keeps the ``clock`` attribute (servers resolve their clock through the
    handle) and a metrics registry that is never written, so generic code
    can snapshot it and get ``{}``.
    """

    enabled = False

    def __init__(self):
        super().__init__(MetricsRegistry(), None, DEFAULT_CLOCK)

    def count(self, name, value=1.0, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def trace_begin(self, rid):
        pass

    def trace_span(self, rid, name, t0, t1, **attrs):
        pass

    def trace_attr(self, rid, **attrs):
        pass

    def trace_end(self, rid):
        pass


NOOP = NoopInstrumentation()


class SpanInstrumentation(NoopInstrumentation):
    """An enabled handle that keeps only a span log: the sites open their
    spans and take their counts, and every metric and trace hook does
    nothing (its registry stays empty)."""

    enabled = True

    def __init__(self, spans: SpanLog, clock=DEFAULT_CLOCK):
        super().__init__()
        self.spans = spans
        self.clock = clock
