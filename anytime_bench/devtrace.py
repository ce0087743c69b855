"""The device trace of a ``--trace 1`` window: ``torch.profiler`` on the card.

The session records device activity only (CUPTI), so the host loop runs at
its untraced speed but for the profiler's own per-launch cost. A one-element
fill, launched on an idle card right after the host clock is read, marks the
window's start on the profiler's clock; ``yardstick.DeviceTimeline`` maps the
device's operations onto the host's clock with it.
"""

from __future__ import annotations

import time

from anytime_bench.yardstick import DeviceTimeline

__all__ = ["DeviceTrace"]


class DeviceTrace:
    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.prof = None
        self.marker_host = self.end_host = 0.0

    def start(self) -> float:
        """Start tracing, launch the marker; returns its host time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        mark = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.marker_host = time.perf_counter()
        mark.fill_(1.0)
        torch.cuda.synchronize(self.device)
        return self.marker_host

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.end_host = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def timeline(self) -> DeviceTimeline | None:
        """The window's device operations, or None if the profiler recorded
        none (then no device metric is read)."""
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
                ops.append((e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9))
        ops.sort(key=lambda o: o[1])
        # The window begins at the marker: a process that traced before may
        # hand this session records of earlier work, which come before it.
        at = next((i for i, o in enumerate(ops) if "Fill" in o[0]), None)
        if at is None:
            if ops:
                raise RuntimeError("the trace holds no marker (a fill) to align it by")
            return None
        marker, ops = ops[at], ops[at + 1:]
        return DeviceTimeline(ops, marker[1], self.marker_host, self.end_host)
