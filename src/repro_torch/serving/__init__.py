# Batched anytime serving: shape-bucketed batches traversed by one launch of
# the traverse kernel each, with per-query budgets, and the SLA-governed
# micro-batching request loop (DESIGN.md §3).
from repro_torch.serving.batch_engine import (  # noqa: F401
    INT32_MAX,
    BatchEngine,
    BatchResult,
    lane_result,
)
from repro_torch.serving.bucketing import (  # noqa: F401
    BatchedPlan,
    BucketSpec,
    DoubleBuffer,
    SlotTable,
    batch_ladder,
    bucket_pow2,
    dummy_plan,
    iter_bucket_chunks,
    saturate_bounds,
    stack_plans,
)
from repro_torch.serving.microbatch import (  # noqa: F401
    MicroBatchServer,
    ServedQuery,
    SlaBudgeter,
    result_exit_reason,
)
