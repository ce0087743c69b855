"""Shape bucketing for batched device traversal (the port's copy).

The reference jit-compiles its batched traversal per static shape, so it
snaps both axes of a batch to a small geometric ladder. The port keeps the
ladder's buckets, but the ``traverse`` kernel takes any shape, so the batch
engine (``BatchEngine``) pads a whole micro-batch to its *widest* width
bucket and launches it once. The sharded and in-flight paths keep the
reference's ladder: the sharded batch engine launches each width bucket
apart, and the in-flight table grows from bucket to bucket:

  * width buckets — the block-table width B (the ragged per-query axis) is
    padded up to the next power of two >= ``min_width``. Padding columns are
    ``-1`` block ids, which the scorer drops before touching memory, so a
    padded plan is *bitwise* equivalent to the unpadded one, however wide
    the padding.
  * batch buckets — a launch's lanes are padded up to the next power of
    two with inert dummy lanes (``max_ranges = 0`` and ``budget = 0``)
    whose results are discarded on unstack.

Plans are held on the host (``QueryPlan``) and stacked into one host
staging table (``stack_table``), which reaches the device in one upload
(``upload_int32``), never a device->host copy per plan.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.range_daat import QueryPlan, resolve_device, upload_int32

__all__ = [
    "BucketSpec",
    "BatchedPlan",
    "DoubleBuffer",
    "SlotTable",
    "batch_ladder",
    "bucket_pow2",
    "dummy_plan",
    "iter_bucket_chunks",
    "saturate_bounds",
    "stack_plans",
    "stack_table",
]

INT32_MAX = 2**31 - 1


def bucket_pow2(n: int, lo: int = 1, hi: int | None = None) -> int:
    """Smallest power of two >= n, clamped to [lo, hi]."""
    if lo < 1:
        raise ValueError(f"bucket_pow2 needs lo >= 1, got lo={lo}")
    if hi is not None and hi < lo:
        raise ValueError(f"bucket_pow2 needs hi >= lo, got lo={lo} hi={hi}")
    v = lo
    while v < n:
        v *= 2
    if hi is not None:
        v = min(v, hi)
    return v


def saturate_bounds(bounds_host: np.ndarray) -> np.ndarray:
    """Narrow int64 per-range BoundSums to the device's int32 lattice.

    A BoundSum past 2^31 must *saturate*, never wrap: a wrapped-negative
    bound satisfies ``bound <= theta`` immediately and silently disables
    safe termination for that range. Saturation errs conservative (the
    range merely looks too promising to skip).
    """
    b = np.asarray(bounds_host)
    if np.any(b < 0):
        raise ValueError(
            "negative per-range BoundSum — upstream impact quantisation bug?"
        )
    if np.any(b > INT32_MAX):
        warnings.warn(
            "per-range BoundSum exceeds int32; saturating to 2^31-1 "
            "(safe termination stays conservative for the affected ranges)",
            RuntimeWarning,
            stacklevel=2,
        )
        b = np.minimum(b, INT32_MAX)
    return b.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static-shape ladder for the batch path."""

    min_width: int = 32  # floor for the block-table width bucket
    max_batch: int = 32  # batch lanes per device program (upper bucket)
    min_batch: int = 1  # floor for the batch-size bucket

    def __post_init__(self):
        if self.min_width < 1 or self.max_batch < 1 or self.min_batch < 1:
            raise ValueError(
                f"BucketSpec sizes must be >= 1, got min_width={self.min_width} "
                f"max_batch={self.max_batch} min_batch={self.min_batch}"
            )
        if self.min_batch > self.max_batch:
            raise ValueError(
                f"min_batch={self.min_batch} > max_batch={self.max_batch}"
            )

    def width_bucket(self, width: int) -> int:
        return bucket_pow2(width, lo=self.min_width)

    def batch_bucket(self, n: int) -> int:
        return bucket_pow2(n, lo=self.min_batch, hi=self.max_batch)


def iter_bucket_chunks(plans: Sequence[QueryPlan], spec: BucketSpec):
    """Group plan indices by width bucket, chunked to ``max_batch`` lanes.

    Yields ``(width_bucket, [plan indices])`` in deterministic (width, then
    arrival) order — the reference's dispatch grouping, which the sharded
    batch engine keeps (``BatchEngine`` pads to the widest bucket instead).
    """
    groups: dict[int, list[int]] = {}
    for i, p in enumerate(plans):
        groups.setdefault(spec.width_bucket(p.blk_tab_host.shape[1]), []).append(i)
    for width, idxs in sorted(groups.items()):
        for lo in range(0, len(idxs), spec.max_batch):
            yield width, idxs[lo : lo + spec.max_batch]


def batch_ladder(spec: BucketSpec) -> list[int]:
    """Every reachable batch bucket: powers of two from ``min_batch``, plus
    ``max_batch`` itself (``batch_bucket`` clamps there, so a non-power-of-
    two ``max_batch`` is a reachable shape the pow2 ladder would miss)."""
    out = []
    b = spec.min_batch
    while b <= spec.max_batch:
        out.append(b)
        b *= 2
    if out[-1] != spec.max_batch:
        out.append(spec.max_batch)
    return out


def dummy_plan(n_ranges: int, width: int, device=None) -> QueryPlan:
    """An inert all-padding plan (for warmup and pad lanes) for ``device``
    (``None``: the card)."""
    return QueryPlan(
        q_terms=np.asarray([-1], np.int32),
        blk_tab_host=np.full((n_ranges, width), -1, np.int32),
        rest_tab_host=np.zeros((n_ranges, width), np.int32),
        order_host=np.arange(n_ranges, dtype=np.int32),
        bounds_host=np.zeros(n_ranges, dtype=np.int64),
        device=resolve_device(device),
    )


class BatchedPlan(NamedTuple):
    """Stacked, padded query plans on one device — ``batched_traverse`` input."""

    blk_tab: torch.Tensor  # [N, R, B] int32, -1 padded
    rest_tab: torch.Tensor  # [N, R, B] int32
    order: torch.Tensor  # [N, R] int32
    ordered_bounds: torch.Tensor  # [N, R] int32
    valid: np.ndarray  # [N] bool host mask — False on dummy pad lanes


class SlotTable:
    """Mutable host-side staging for one device program's lane inputs.

    ``n_slots`` lanes x ``n_ranges`` x ``width`` block/rest tables, plus
    per-lane order, bounds, budget, and max_ranges. This is the slot
    state-machine's *plan* half (the traversal-carry half lives in
    ``range_daat.TraverseCarry``): an in-flight server writes admitted
    queries into vacant lanes, clears exited ones, and snapshots the whole
    table to device tensors once per dispatch.

    A cleared (vacant) lane is inert: all ``-1`` blocks, zero bounds, zero
    budget, ``max_ranges = 0`` — the traversal cond fails on the first
    iteration, so a vacant lane costs nothing per quantum.
    """

    def __init__(self, n_slots: int, n_ranges: int, width: int):
        if n_slots < 1 or n_ranges < 1 or width < 1:
            raise ValueError(
                f"SlotTable needs positive dims, got n_slots={n_slots} "
                f"n_ranges={n_ranges} width={width}"
            )
        self.n_slots = n_slots
        self.n_ranges = n_ranges
        self.width = width
        self.blk = np.full((n_slots, n_ranges, width), -1, dtype=np.int32)
        self.rest = np.zeros((n_slots, n_ranges, width), dtype=np.int32)
        self.order = np.tile(
            np.arange(n_ranges, dtype=np.int32), (n_slots, 1)
        )
        self.bounds = np.zeros((n_slots, n_ranges), dtype=np.int32)
        self.budget = np.zeros(n_slots, dtype=np.int32)
        self.maxr = np.zeros(n_slots, dtype=np.int32)
        self.valid = np.zeros(n_slots, dtype=bool)

    def write_lane(
        self,
        lane: int,
        plan: QueryPlan,
        budget: int = INT32_MAX,
        max_ranges: int = INT32_MAX,
    ) -> None:
        """Stage ``plan`` into ``lane`` from its host tables; bounds saturate
        (never wrap) to int32."""
        if plan.blk_tab_host.shape[0] != self.n_ranges:
            raise ValueError(
                f"plan has R={plan.blk_tab_host.shape[0]}, table has R={self.n_ranges}"
            )
        w = plan.blk_tab_host.shape[1]
        if w > self.width:
            raise ValueError(f"plan width {w} > table width {self.width}")
        # Columns past w are -1 / 0, the scorer's padding, whatever wider
        # plan the lane held before.
        self.blk[lane, :, :w] = plan.blk_tab_host
        self.blk[lane, :, w:] = -1
        self.rest[lane, :, :w] = plan.rest_tab_host
        self.rest[lane, :, w:] = 0
        self.order[lane] = plan.order_host
        self.bounds[lane] = saturate_bounds(plan.bounds_host)
        self.budget[lane] = min(int(budget), INT32_MAX)
        self.maxr[lane] = min(int(max_ranges), INT32_MAX)
        self.valid[lane] = True

    def clear_lane(self, lane: int) -> None:
        self.blk[lane] = -1
        self.rest[lane] = 0
        self.order[lane] = np.arange(self.n_ranges, dtype=np.int32)
        self.bounds[lane] = 0
        self.budget[lane] = 0
        self.maxr[lane] = 0
        self.valid[lane] = False

    def copy_from(self, other: "SlotTable") -> None:
        """Overwrite this table's contents with ``other``'s (same shape)."""
        if (other.n_slots, other.n_ranges, other.width) != (
            self.n_slots,
            self.n_ranges,
            self.width,
        ):
            raise ValueError("SlotTable shapes differ")
        for name in ("blk", "rest", "order", "bounds", "budget", "maxr", "valid"):
            getattr(self, name)[:] = getattr(other, name)

    def grow_width(self, width: int) -> "SlotTable":
        """A fresh table with a wider block-table axis, contents carried over.

        Width growth is the one event that changes the in-flight program
        shape; keeping it on the pow2 ladder bounds recompiles.
        """
        if width < self.width:
            raise ValueError(f"cannot shrink width {self.width} -> {width}")
        out = SlotTable(self.n_slots, self.n_ranges, width)
        out.blk[:, :, : self.width] = self.blk
        out.rest[:, :, : self.width] = self.rest
        out.order[:] = self.order
        out.bounds[:] = self.bounds
        out.budget[:] = self.budget
        out.maxr[:] = self.maxr
        out.valid[:] = self.valid
        return out

    def device_arrays(self, device=None):
        """Snapshot the staging arrays to tensors on ``device`` (``None``:
        the card), in one upload."""
        return tuple(upload_int32(
            (self.blk, self.rest, self.order, self.bounds, self.budget, self.maxr),
            resolve_device(device),
        ))


class DoubleBuffer:
    """Front/back pair of ``SlotTable``s for overlap of admission and scoring.

    The *front* table is what the current device dispatch reads (its
    snapshot is already in flight under asynchronous launch); lane writes
    for the *next* quantum (clears for exited queries, admissions from the
    queue) land in the *back* table. ``swap()`` flips the roles between
    dispatches, so host-side planning overlaps device execution instead of
    serialising with it.
    """

    def __init__(self, n_slots: int, n_ranges: int, width: int):
        self.front = SlotTable(n_slots, n_ranges, width)
        self.back = SlotTable(n_slots, n_ranges, width)

    def swap(self) -> None:
        self.front, self.back = self.back, self.front
        # The new back starts as a copy of what is now in flight, so lane
        # writes are deltas against the live table, not a blank slate.
        self.back.copy_from(self.front)

    def grow_width(self, width: int) -> None:
        self.front = self.front.grow_width(width)
        self.back = self.back.grow_width(width)


def stack_table(
    plans: Sequence[QueryPlan],
    width: int,
    batch: int,
    budgets=None,
    max_ranges=None,
) -> SlotTable:
    """Stage ``plans`` into a host [batch, R, width] ``SlotTable``, lane i
    holding plan i under ``budgets[i]`` and ``max_ranges[i]`` (None:
    uncapped); the lanes past ``len(plans)`` are inert dummies.

    Every plan must have block-table width <= ``width`` and the same R.
    Per-range bounds saturate (with a warning) rather than wrap when the
    int64 ``bounds_host`` exceeds int32.
    """
    n = len(plans)
    if n == 0 or n > batch:
        raise ValueError(f"need 0 < len(plans)={n} <= batch={batch}")
    R = plans[0].blk_tab_host.shape[0]

    table = SlotTable(batch, R, width)
    for i, p in enumerate(plans):
        if p.blk_tab_host.shape[0] != R:
            raise ValueError("all plans in a batch must share the same R")
        table.write_lane(i, p, INT32_MAX if budgets is None else budgets[i],
                         INT32_MAX if max_ranges is None else max_ranges[i])
    return table


def stack_plans(
    plans: Sequence[QueryPlan], width: int, batch: int
) -> BatchedPlan:
    """Stack ``plans`` into one [batch, R, width] batch with dummy padding,
    on the first plan's device, in one upload (``stack_table``).

    Dummy lanes (indices >= len(plans)) get all ``-1`` block tables and zero
    bounds; callers must also zero their budgets so they exit immediately.
    """
    table = stack_table(plans, width, batch)
    return BatchedPlan(
        *upload_int32((table.blk, table.rest, table.order, table.bounds),
                      plans[0].device),
        valid=table.valid.copy(),
    )
