"""idle_share.qps: % of the traced window (window and drain) in which the card
ran no operation, from the profiler's device trace; moves qps."""

from anytime_bench.metrics._shared import idle_share as read  # noqa: F401
