"""traverse_roofline.qps: the ``traverse`` kernel's share of its HBM roofline
over the traced window; moves qps."""

from anytime_bench.metrics._shared import traverse_roofline as read  # noqa: F401
