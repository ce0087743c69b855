"""queue_ms.p99: mean ms from a query's due time to its admission into an
in-flight slot (``InflightServer._admit``, wrapped by the harness); moves
p99_ms."""

import numpy as np


def read(ctx):
    admitted = ctx.spans.marks.get("admitted") if ctx.spans is not None else None
    win = ctx.window
    if not admitted or win.due is None:
        return None
    waits = [(admitted[rid] - win.t0 - due) * 1e3
             for rid, due in zip(win.rids, win.due) if rid in admitted]
    return float(np.mean(waits)) if waits else None
