"""The paper's own system as an architecture: ``anytime-ir``.

The counterpart of the JAX package's ``configs/anytime_ir.py``. One 256-chip
node of the reference = 16 ISN shards (model axis) x 16-way query
parallelism (data axis); sizes model a web-scale node: 64M docs / 4B
postings across shards, 256 topical ranges, 256-query batches, k=10.

The serve step is ``serve/distributed_ir.make_sharded_query_fn``: per-shard
anytime traversal (postings budget = the per-ISN SLA quantum) and the broker
merge. On one card the Q x M (query, shard) lanes are one launch of the
``traverse`` kernel; a context over more devices waits for the mesh paths
(ROADMAP A7).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import Arch, ShapeInfo, needs_mesh
from repro_torch.core.range_daat import resolve_device
from repro_torch.models.layers import tensor_from_numpy
from repro_torch.serve import distributed_ir as dir_mod

_FULL = dict(
    n_queries=256, n_shards=16, r_loc=16, b_width=512,
    nnz_loc=256_000_000, nb_loc=2_097_152, s_pad=262_144, k=10,
)
_REDUCED = dict(
    n_queries=8, n_shards=1, r_loc=8, b_width=64,
    nnz_loc=65_536, nb_loc=2048, s_pad=1024, k=10,
)
_ARRAY_FIELDS = ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
                 "doc_base")


class AnytimeIRArch(Arch):
    name = "anytime-ir"
    family = "ir"
    # "i8": impacts stored at their native quantized width (int8), where the
    # baseline stores them at int32.
    variants = ("baseline", "i8")

    def shapes(self):
        return {
            "serve_anytime": ShapeInfo(
                "serve_anytime", "serve",
                "256-query batch, 16 ISN shards, SLA postings budget",
            ),
            "serve_exhaustive": ShapeInfo(
                "serve_exhaustive", "serve",
                "same, unlimited budget (rank-safe baseline)",
            ),
        }

    def model_config(self, reduced: bool = False):
        return dict(_REDUCED if reduced else _FULL)

    def init_params(self, key, cfg, device=None):
        """The "parameters" are the sharded index arrays (stateless serving),
        built by ``build_sharded_index``: here only their meta tensors."""
        del key, device
        arrays, _ = dir_mod.sharded_query_specs(**cfg)
        return arrays

    def param_shapes(self, cfg):
        return self.init_params(None, cfg)

    def params_from_numpy(self, tree, cfg, device=None):
        """The reference's ``ShardedIndexArrays`` fields (a dict of numpy
        arrays) as the port's, with ``cfg``'s ``s_pad`` and ``k``."""
        dev = resolve_device(device)
        return dir_mod.ShardedIndexArrays(
            **{f: tensor_from_numpy(tree[f], dev) for f in _ARRAY_FIELDS},
            s_pad=cfg["s_pad"], k=cfg["k"])

    def _with_variant(self, cfg, variant):
        if variant == "i8":
            return dict(cfg, impact_dtype=torch.int8)
        return cfg

    def input_specs(self, cfg, shape):
        _, tables = dir_mod.sharded_query_specs(**cfg)
        return {"tables": tables}

    def make_batch(self, cfg, shape, seed: int = 0):
        raise NotImplementedError(
            "anytime-ir batches are plan tables of a built index "
            "(serve/distributed_ir.py: build_sharded_index, plan_queries)"
        )

    def build_step(self, cfg, shape, shard_ctx=None, variant: str = "baseline"):
        """``step(arrays, batch) -> (vals, ids, ranges)`` over
        ``batch["tables"]``; ``serve_anytime`` gives every lane the budget
        ``nnz_loc // 64`` postings, ``serve_exhaustive`` none."""
        del variant  # the step is dtype-agnostic
        budget = 2**31 - 1 if shape == "serve_exhaustive" else cfg["nnz_loc"] // 64
        fn = dir_mod.make_sharded_query_fn(
            shard_ctx, s_pad=cfg["s_pad"], k=cfg["k"], budget=budget
        )

        def step(arrays, batch):
            return fn(arrays, batch["tables"])

        return step, "serve"

    def param_pspecs(self, cfg, params, variant: str = "baseline", ctx=None):
        needs_mesh("anytime-ir param_pspecs")

    def batch_pspecs(self, cfg, shape, ctx, variant: str = "baseline"):
        needs_mesh("anytime-ir batch_pspecs")
