"""Shard/replica health ledger for degraded anytime serving (DESIGN.md §9).

The port's copy of the reference's module (numpy only).

The anytime contract makes failover cheap to reason about: a dead shard is
just a shard whose traversal terminated at zero postings, and the §4
fidelity accounting already knows how to certify what that costs — the
merged result keeps flowing with ``exact=False`` and a ``fidelity_bound``
widened by the dead shard's unprocessed BoundSum mass. This module is the
bookkeeping side: who is down, since when, and which mask the dispatch
should apply.

State is per (replica, shard) cell. A *shard* is down for serving only when
every replica of it is down (with one replica, that is the replica itself);
a *replica row* is healthy only when all its shards are up — the
``ReplicaGroupEngine`` falls back to a surviving replica when a row
degrades, so partial-replica outages cost throughput, not fidelity.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

__all__ = ["HealthEvent", "HealthLedger"]


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One transition in the ledger, for observability and tests."""

    seq: int
    kind: str  # "down" | "up"
    shard: int
    replica: int | None  # None = every replica of the shard


class HealthLedger:
    """Boolean (replica, shard) availability matrix with an event log."""

    def __init__(self, n_shards: int, n_replicas: int = 1):
        if n_shards < 1 or n_replicas < 1:
            raise ValueError(
                f"need n_shards >= 1 and n_replicas >= 1, got "
                f"{n_shards}, {n_replicas}"
            )
        self.n_shards = n_shards
        self.n_replicas = n_replicas
        self._up = np.ones((n_replicas, n_shards), dtype=bool)
        self._seq = itertools.count()
        self.events: list[HealthEvent] = []

    # ------------------------------------------------------------ mutation
    def _check(self, shard: int, replica: int | None) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} not in [0, {self.n_shards})")
        if replica is not None and not 0 <= replica < self.n_replicas:
            raise ValueError(f"replica {replica} not in [0, {self.n_replicas})")

    def mark_down(self, shard: int, replica: int | None = None) -> None:
        """Declare a shard dead on one replica (or on all when None)."""
        self._check(shard, replica)
        rows = slice(None) if replica is None else replica
        self._up[rows, shard] = False
        self.events.append(HealthEvent(next(self._seq), "down", shard, replica))

    def mark_up(self, shard: int, replica: int | None = None) -> None:
        """Declare a shard recovered on one replica (or on all when None)."""
        self._check(shard, replica)
        rows = slice(None) if replica is None else replica
        self._up[rows, shard] = True
        self.events.append(HealthEvent(next(self._seq), "up", shard, replica))

    def reset(self, n_shards: int | None = None) -> None:
        """Mark everything up (e.g. after a reshard replaces the layout)."""
        if n_shards is not None:
            self.n_shards = n_shards
        self._up = np.ones((self.n_replicas, self.n_shards), dtype=bool)

    # ------------------------------------------------------------- queries
    @property
    def all_up(self) -> bool:
        return bool(self._up.all())

    def shard_down_mask(self) -> np.ndarray:
        """[S] bool — True where NO replica of the shard is alive.

        This is the mask the dispatch applies (``serving.sharded
        .apply_down_mask``): only a shard with zero live replicas has to be
        served degraded; anything less is routed around at full fidelity.
        """
        return ~self._up.any(axis=0)

    def replica_healthy_mask(self) -> np.ndarray:
        """[n_replicas] bool — True where the replica has every shard up."""
        return self._up.all(axis=1)

    def n_healthy_replicas(self) -> int:
        return int(self.replica_healthy_mask().sum())

    def snapshot(self) -> dict:
        """JSON-able state for dashboards / the control-plane stats call."""
        return {
            "n_shards": self.n_shards,
            "n_replicas": self.n_replicas,
            "up": self._up.tolist(),
            "shard_down": self.shard_down_mask().tolist(),
            "healthy_replicas": int(self.n_healthy_replicas()),
            "events": len(self.events),
        }
