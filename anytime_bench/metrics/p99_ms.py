"""p99_ms: the 99th percentile of the latency of every query due in the
window, from its due time to its answer. With a query unanswered the tail is
undefined and the metric is left out (the run is not correct then)."""

import numpy as np


def read(ctx):
    lat = ctx.latency_ms
    if lat is None or lat.size == 0 or not np.isfinite(lat).all():
        return None
    return float(np.percentile(lat, 99))
