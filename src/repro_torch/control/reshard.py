"""Online reshard: load-driven range cuts + staged live cutover (DESIGN.md §9).

The port's copy of the reference's module (numpy; the successor engine
is the port's ``ShardedEngine``).

The §4 planner balances *static* postings mass, but traffic is not static:
query terms cluster topically, so a shard whose ranges hold the hot topics
does more work per query than its mass share predicts. ``ReshardPlanner``
watches the per-shard postings observations the serving loop already
produces (``MicroBatchServer`` -> ``ShardedSlaBudgeter``), maintains a
load EWMA per shard, and — when the imbalance crosses a trigger — proposes
new cuts by re-balancing the per-range mass *scaled by each shard's
observed/expected load ratio*: ranges living in an overloaded shard get
heavier, so the §4 cut balancer naturally shrinks that shard's band.

``ReshardTask`` executes the cutover without a serving pause: the work is
cut into small host-side steps (re-stack one shard per step via
``core.clustered_index.restack_shards`` — no full index rebuild, the
source arrays are the old shards or an ``index_io`` shard artifact — then
build the new engine, whose constructor uploads the stacked shards to the
card, then run each (width, batch-ladder) shape once through it).
The serving loop interleaves ``step()`` calls between micro-batches and
swaps engines only when the task reports ready; queries issued at any
point are served by whichever layout is live, and post-cutover results are
bitwise-equal to a fresh build at the new layout because ``restack_shards``
reproduces ``shard_device_index(cuts=...)`` array-for-array.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.clustered_index import (
    IndexShard,
    balance_range_shards,
    restack_prep,
    restack_shards,
)

__all__ = ["ReshardPlanner", "ReshardTask"]


@dataclasses.dataclass
class ReshardPlanner:
    """Per-shard load EWMAs -> proposed range cuts.

    ``range_mass`` is the static per-range postings mass ([R], the §4
    partitioning weight); ``cuts`` the live layout. ``observe`` feeds the
    per-shard postings actually traversed for a served batch — the same
    numbers ``ShardedSlaBudgeter.observe_sharded`` consumes.
    """

    range_mass: np.ndarray  # [R] int64 static postings mass per range
    cuts: np.ndarray  # [S + 1] current layout
    ema: float = 0.3
    trigger: float = 1.25  # max/mean load ratio that arms a reshard

    def __post_init__(self):
        self.range_mass = np.asarray(self.range_mass, np.int64)
        self.cuts = np.asarray(self.cuts, np.int64)
        self.load = np.zeros(self.n_shards, np.float64)  # postings/query EWMA
        self.batches_seen = 0

    @property
    def n_shards(self) -> int:
        return int(self.cuts.shape[0] - 1)

    # ----------------------------------------------------------- observing
    def observe(self, shard_postings: Sequence[float], n_queries: int) -> None:
        """Feed one served batch's per-shard postings counters."""
        if n_queries <= 0:
            return
        per_q = np.asarray(shard_postings, np.float64) / n_queries
        if per_q.shape != (self.n_shards,):
            raise ValueError(
                f"shard_postings shape {per_q.shape} != ({self.n_shards},)"
            )
        if self.batches_seen == 0:
            self.load = per_q
        else:
            self.load = (1 - self.ema) * self.load + self.ema * per_q
        self.batches_seen += 1

    def imbalance(self) -> float:
        """max/mean observed per-shard load (1.0 = perfectly even)."""
        mean = float(self.load.mean())
        if mean <= 0:
            return 1.0
        return float(self.load.max()) / mean

    # ------------------------------------------------------------ proposing
    def propose(self) -> np.ndarray:
        """New cuts balancing load-scaled range mass.

        Each shard's observed/expected ratio (load share over static mass
        share) scales the mass of its ranges; ``balance_range_shards`` then
        re-cuts the scaled mass. With no observations (or uniform load)
        this degenerates to the static §4 cut.
        """
        mass = np.maximum(self.range_mass, 1).astype(np.float64)
        if self.batches_seen and self.load.sum() > 0:
            static = mass.copy()  # freeze shares before any band is scaled
            load_share = self.load / self.load.sum()
            for s in range(self.n_shards):
                lo, hi = int(self.cuts[s]), int(self.cuts[s + 1])
                mass_share = static[lo:hi].sum() / static.sum()
                scale = load_share[s] / max(mass_share, 1e-12)
                mass[lo:hi] *= max(scale, 1e-6)
        weights = np.maximum(np.round(mass), 1).astype(np.int64)
        return balance_range_shards(weights, self.n_shards)

    def should_reshard(self) -> bool:
        """Armed when load is imbalanced AND the proposal actually moves a cut."""
        if self.batches_seen == 0 or self.imbalance() < self.trigger:
            return False
        return not np.array_equal(self.propose(), self.cuts)

    def committed(self, cuts: np.ndarray) -> None:
        """Adopt a new live layout (called by the plane after the cutover).

        The load EWMA is reset: old per-shard observations are measured
        against boundaries that no longer exist.
        """
        self.cuts = np.asarray(cuts, np.int64)
        self.load = np.zeros(self.n_shards, np.float64)
        self.batches_seen = 0


class ReshardTask:
    """Staged cutover to ``cuts``: one unit of work per ``step()``.

    Stages (one unit each): re-stack one new shard from the source shards;
    construct the successor engine (the host re-pack and the upload of its
    stacked shards); run one width's batch ladder through it once (the
    port's ``ShardedBatchEngine.warmup``, the reference's pre-compile). ``ready`` turns True when the successor can serve
    every shape the caller warms — the plane then swaps atomically between
    micro-batches. The old engine is untouched throughout, so serving never
    pauses and a mid-flight abort costs nothing.
    """

    def __init__(
        self,
        source_shards: list[IndexShard],
        cuts: np.ndarray,
        build_engine,  # list[IndexShard] -> (sengine, bengine)
        warm_widths: Sequence[int] = (),
    ):
        self.cuts = np.asarray(cuts, np.int64)
        self._source = list(source_shards)
        # Validates source contiguity and the cuts *now*, so a malformed
        # layout fails at start_reshard time, never mid-serving; the
        # prepared geometry is reused by every carve step.
        self._prep = restack_prep(self._source, self.cuts)
        self._build_engine = build_engine
        self._warm = list(warm_widths)
        self.new_shards: list[IndexShard] = []
        self.sengine = None
        self.bengine = None
        self.steps_done = 0
        self._stage = "carve"

    @property
    def n_shards(self) -> int:
        return int(self.cuts.shape[0] - 1)

    @property
    def stage(self) -> str:
        return self._stage

    @property
    def ready(self) -> bool:
        return self._stage == "ready"

    def step(self) -> str:
        """Advance one unit of cutover work; returns the stage just run."""
        if self._stage == "carve":
            s = len(self.new_shards)
            (piece,) = restack_shards(
                self._source, self.cuts, only=s, prep=self._prep
            )
            self.new_shards.append(piece)
            self.steps_done += 1
            if len(self.new_shards) == self.n_shards:
                self._stage = "build"
            return "carve"
        if self._stage == "build":
            self.sengine, self.bengine = self._build_engine(self.new_shards)
            self.steps_done += 1
            self._stage = "warm" if self._warm else "ready"
            return "build"
        if self._stage == "warm":
            width = self._warm.pop(0)
            self.bengine.warmup([width])
            self.steps_done += 1
            if not self._warm:
                self._stage = "ready"
            return "warm"
        return "ready"
