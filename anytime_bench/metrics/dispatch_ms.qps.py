"""dispatch_ms.qps: host ms per ``traverse`` launch of the batch engine, from
``BatchEngine.run_batch``'s entry to its return less the waits for the
device (each launch is followed by a synchronize in the traced run): the
staging, upload, launch and read-back; moves qps."""


def read(ctx):
    spans = ctx.spans
    if spans is None or not spans.counts["launches"]:
        return None
    host_s = spans.total_s("dispatch") - spans.total_s("device_wait")
    return host_s * 1e3 / spans.counts["launches"]
