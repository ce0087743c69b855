"""Readers that several per-layer metrics share; each metric's own file says
which end-to-end metric it moves."""

from anytime_bench.yardstick import HBM_BYTES_PER_S


def plan_ms(ctx):
    """Host ms in the port's planning entry per query planned."""
    if ctx.spans is None or not ctx.spans.counts["planned"]:
        return None
    return ctx.spans.total_s("plan") * 1e3 / ctx.spans.counts["planned"]


def idle_share(ctx):
    """% of the traced window in which no operation ran on the device."""
    tl = ctx.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return (1.0 - tl.busy_s / tl.window_s) * 100.0


def traverse_roofline(ctx):
    """% of the HBM roofline: the bytes the window's queries need (the byte
    model over the reference's trajectories, whose counters the comparison
    checked) at 3.35 TB/s, over the traverse kernel's device time."""
    tl = ctx.timeline
    if tl is None:
        return None
    kernel_s = tl.kernel_s("traverse_kernel")
    if kernel_s <= 0:
        return None
    return ctx.bytes_needed / HBM_BYTES_PER_S / kernel_s * 100.0
