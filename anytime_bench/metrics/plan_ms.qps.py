"""plan_ms.qps: host ms per query in the port's planning entry
(``BatchEngine.plan`` / ``plan_many`` to ``Engine.plan`` and
``ClusteredIndex.query_block_table``), timed by the harness around it;
moves qps."""

from anytime_bench.metrics._shared import plan_ms as read  # noqa: F401
