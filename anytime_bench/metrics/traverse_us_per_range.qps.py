"""traverse_us_per_range.qps: the ``traverse`` kernel's device µs over the
traced window (window and drain) per range scored, summed as
``ranges_processed`` over the window's answered queries (the port's own
counter of its range loop, which the comparison checks against the
reference); moves qps."""


def read(ctx):
    tl = ctx.timeline
    if tl is None:
        return None
    ranges = sum(int(r.ranges_processed) for r in ctx.window.results if r is not None)
    kernel_s = tl.kernel_s("traverse_kernel")
    if ranges == 0 or kernel_s <= 0:
        return None
    return kernel_s * 1e6 / ranges
