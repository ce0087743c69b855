"""Replicated shard groups: a query-parallel ``data`` axis over the shard
mesh (DESIGN.md §9).

``ReplicaGroupEngine`` composes the §4 range-shard axis with a
query-parallel ``data`` axis: a 2-D (data x shard) mesh of
``torch.distributed`` ranks (``distributed.sharding.replica_mesh``) where
every row holds a full copy of the sharded index (rank r holds shard
r % n_shards) and each row serves a slice of the micro-batch. The step is
the *same* program as the single-replica mesh path
(``serving.sharded.make_mesh_dispatch`` with ``data_axis=``): the
per-query traversal and the broker merge never see the replica axis, so an
N-replica dispatch is bitwise identical to serving the same queries on one
replica; replication buys throughput, never a different answer.

Fallbacks keep the engine total: without ``n_replicas * n_shards`` ranks
(one card, no process group) the group serves through the wrapped
``ShardedEngine`` unchanged (its stacked ``traverse`` launch or its 1-D
mesh), and the control plane drops to the same path when the health
ledger reports a degraded replica row.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sharding as mesh_lib
from repro_torch.serving.sharded import ShardedEngine, make_mesh_dispatch

__all__ = ["ReplicaGroupEngine"]


class ReplicaGroupEngine:
    """N data-parallel replicas of a ``ShardedEngine``.

    Drop-in wherever a ``ShardedEngine`` is accepted (``ShardedBatchEngine``
    takes either): planning, budget splitting and result unpacking delegate
    to the wrapped engine; only ``dispatch`` is the group's, sharding the
    batch axis over the replica rows of a (data x shard) mesh. ``use_mesh``:
    None = auto (replicate when a process group of n_replicas * n_shards
    ranks is up and the wrapped engine is on the mesh), True = require the
    2-D mesh, False = always fall back to the wrapped engine's own path
    (useful on one card, where replica rows cannot add throughput but the
    scheduling logic still runs). ``dispatches`` counts replica-mesh
    dispatches actually issued: 0 on the fallback.
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
        self.sengine = sengine
        self.n_replicas = n_replicas
        self._data_axis = data_axis
        self._shard_axis = mesh_axis
        need = n_replicas * sengine.n_shards
        if use_mesh is None:
            use_mesh = (n_replicas > 1 and sengine.mesh is not None
                        and mesh_lib.mesh_world_size() >= need)
        self.group_mesh = None
        if use_mesh:
            if sengine.mesh is None:
                raise ValueError(
                    "the replica mesh needs the wrapped ShardedEngine on the mesh "
                    "(use_mesh=True there too): each rank serves its own shard")
            mesh_lib.announce(_replica_twin, sengine, n_replicas, data_axis, mesh_axis)
            self.group_mesh = mesh_lib.replica_mesh(
                n_replicas, sengine.n_shards, data_axis, mesh_axis)
            mesh_lib.register(self)
        self._group_fns: dict = {}
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
        """Run one (batch x shard) step across all replica rows.

        The batch axis is padded to a multiple of ``n_replicas`` with inert
        zero-budget lanes (the §3 dummy-lane discipline) so it divides
        evenly over the ``data`` axis; pad lanes are sliced off the packed
        ``[N, 2k + 5S]`` output. Without the mesh, the wrapped engine's
        dispatch, unchanged.
        """
        if self.group_mesh is None:
            return self.sengine.dispatch(
                blk, rest, order, bounds, budgets, maxr,
                safe_stop=safe_stop, prune_blocks=prune_blocks,
            )
        n = blk.shape[0]
        pad = (-n) % self.n_replicas
        budgets, maxr = np.asarray(budgets, np.int64), np.asarray(maxr, np.int64)
        if pad:
            def zb(a, fill=0):
                a = np.asarray(a)
                return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

            blk = zb(blk, -1)
            rest, order, bounds = zb(rest), zb(order), zb(bounds)
            budgets, maxr = zb(budgets), zb(maxr)
        out = mesh_lib.mesh_call(self, "_mesh_step", blk, rest, order, bounds,
                                 budgets, maxr, safe_stop, prune_blocks)
        self.dispatches += 1
        if self.obs.enabled:  # delegates to the wrapped engine's handle
            self.obs.count("replica_dispatches")
            self.obs.observe("replica_pad_lanes", pad)
        if pad:
            out = _slice_pad(out, n)
        return out

    def _mesh_step(self, blk, rest, order, bounds, budgets, maxr, safe_stop,
                   prune_blocks):
        """This rank's part of one replica-mesh dispatch."""
        key = (safe_stop, prune_blocks)
        if key not in self._group_fns:
            se = self.sengine
            self._group_fns[key] = make_mesh_dispatch(
                self.group_mesh, self._shard_axis, s_pad=se.s_pad, k=se.k,
                safe_stop=safe_stop, prune_blocks=prune_blocks, impl=se.impl,
                interpret=True, data_axis=self._data_axis, docs_format=se.docs_format,
            )
        se = self.sengine
        return self._group_fns[key](se.dix, se.doc_base, blk, rest, order, bounds,
                                    budgets, maxr)


def _replica_twin(sengine: ShardedEngine, n_replicas: int, data_axis: str,
                  mesh_axis: str) -> ReplicaGroupEngine:
    """A rank's counterpart of the replica group rank 0 builds while it
    drives."""
    return ReplicaGroupEngine(sengine, n_replicas, use_mesh=True, data_axis=data_axis,
                              mesh_axis=mesh_axis)


def _slice_pad(out: torch.Tensor, n: int) -> torch.Tensor:
    """Drop pad lanes on the device: the first ``n`` rows of the packed
    ``[N, 2k + 5S]`` dispatch output (a view, so the host copy happens at
    the caller's read, ``_to_results``)."""
    return out[:n]
