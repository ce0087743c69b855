# Batched anytime serving: shape-bucketed batches traversed by one launch of
# the traverse kernel each, with per-query budgets; the SLA-governed
# micro-batching request loop (DESIGN.md §3); the slot-swapping in-flight
# loop (DESIGN.md §11); and range-sharded engines whose every (query,
# shard) pair runs in one launch on one card (DESIGN.md §4).
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
from repro_torch.serving.inflight import InflightServer  # noqa: F401
from repro_torch.serving.microbatch import (  # noqa: F401
    MicroBatchServer,
    ServedQuery,
    ShardedSlaBudgeter,
    SlaBudgeter,
    result_exit_reason,
)
from repro_torch.serving.sharded import (  # noqa: F401
    ShardedBatchEngine,
    ShardedEngine,
    ShardedResult,
    apply_down_mask,
    shard_exit_reason,
    sharded_batched_traverse,
    split_outputs,
)
