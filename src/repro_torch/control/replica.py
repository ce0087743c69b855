"""Replicated shard groups: a query-parallel ``data`` axis over the shard
mesh (DESIGN.md §9).

``ReplicaGroupEngine`` composes the §4 range-shard axis with a
query-parallel ``data`` axis: in the reference, a 2-D (data x shard) mesh
where every row holds a full copy of the sharded index and each row
serves a slice of the micro-batch, bitwise identical to serving the same
queries on one replica.

The port serves on one card, so a group always takes the reference's
fallback: it serves through the wrapped ``ShardedEngine`` unchanged (its
stacked-shard ``traverse`` launch), and the control plane drops to the
same path when the health ledger reports a degraded replica row. The
(data x shard) mesh (``use_mesh=True``) raises ``NotImplementedError``
until the mesh paths are ported (ROADMAP A7).
"""

from __future__ import annotations

import torch

from repro_torch.serving.sharded import ShardedEngine

__all__ = ["ReplicaGroupEngine"]


class ReplicaGroupEngine:
    """N data-parallel replicas of a ``ShardedEngine``.

    Drop-in wherever a ``ShardedEngine`` is accepted (``ShardedBatchEngine``
    takes either): planning, budget splitting and result unpacking delegate
    to the wrapped engine; only ``dispatch`` is the group's. ``use_mesh``:
    None = auto (replicate when the runtime has n_replicas * n_shards
    cards; the mesh is not ported, so auto falls back on every runtime
    that would pick it as well as on one card), True = require the 2-D
    mesh (raises ``NotImplementedError``), False = always fall back to the
    wrapped engine's own path. ``data_axis`` and ``mesh_axis`` name the
    unported mesh's axes and are kept for it. ``dispatches`` counts
    replica-mesh dispatches actually issued: 0 on the fallback.
    """

    def __init__(
        self,
        sengine: ShardedEngine,
        n_replicas: int,
        use_mesh: bool | None = None,
        data_axis: str = "data",
        mesh_axis: str = "shard",
    ):
        if n_replicas < 1:
            raise ValueError(f"need n_replicas >= 1, got {n_replicas}")
        if use_mesh:
            raise NotImplementedError(
                "use_mesh=True (a (data x shard) replica mesh: make_mesh_dispatch "
                "with data_axis= and distributed/sharding.py::replica_mesh) is not "
                "ported yet, ROADMAP A7's mesh item; use_mesh=None or False serves "
                "through the wrapped ShardedEngine"
            )
        self.sengine = sengine
        self.n_replicas = n_replicas
        self._data_axis = data_axis
        self._shard_axis = mesh_axis
        # The reference builds the replica mesh under auto when the runtime
        # has n_replicas * n_shards devices; until A7 every runtime serves
        # through the fallback, one card (torch.cuda.device_count() == 1)
        # as the reference does.
        self.group_mesh = None
        self.dispatches = 0  # replica-mesh dispatches actually issued

    def __getattr__(self, name):
        # Everything but dispatch (and the replica plumbing above) is the
        # wrapped engine's: shard_plan, split_*_budget, _to_results, shards,
        # cuts, query_shard_mass, ... — the ShardedBatchEngine contract.
        return getattr(self.sengine, name)

    # ------------------------------------------------------------- dispatch
    def dispatch(
        self, blk, rest, order, bounds, budgets, maxr,
        safe_stop: bool = True, prune_blocks: bool = True,
    ) -> torch.Tensor:
        """Run one (batch x shard) step: the wrapped engine's one
        ``traverse`` launch over every (query, shard) pair, whose packed
        ``[N, 2k + 5S]`` output comes back unchanged."""
        return self.sengine.dispatch(
            blk, rest, order, bounds, budgets, maxr,
            safe_stop=safe_stop, prune_blocks=prune_blocks,
        )


def _slice_pad(out: torch.Tensor, n: int) -> torch.Tensor:
    """Drop pad lanes on the device: the first ``n`` rows of the packed
    ``[N, 2k + 5S]`` dispatch output (a view, so the dispatch stays
    asynchronous). The mesh dispatch that pads its batch to a multiple of
    the replica count is A7's; the fallback never pads."""
    return out[:n]
