"""Embedding lookups for recommendation models: EmbeddingBag and field lookups.

The counterpart of the JAX package's ``models/embedding.py``. A bag is a
gather of table rows plus a masked, weighted reduction over the bag; the
reduction is the CUDA kernel of ``kernels/embedding_bag`` (``impl="cuda"``)
or a plain contraction in the table's dtype (``impl="torch"``). The gather
stays plain PyTorch, as it stayed XLA around the Pallas kernel.

Ids follow the JAX package's indexing: an id below 0 is padding and adds
nothing, and an id at or past the table's end reads the last row (JAX clamps
out-of-range gathers; torch indexing would raise), so ids are clamped to
``[0, V - 1]`` before the gather. Ragged bags drop segment ids outside
``[0, n_bags)``, as ``jax.ops.segment_sum`` does.

``table_from_numpy`` carries a table built by the JAX package (as numpy,
float32 or ml_dtypes bfloat16) into the port bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.range_daat import resolve_device
from repro_torch.kernels.embedding_bag import ops
from repro_torch.models.layers import tensor_from_numpy

COMBINES = ("sum", "mean")

__all__ = [
    "COMBINES",
    "bag_inputs",
    "combine_bags",
    "embedding_bag",
    "embedding_bag_ragged",
    "sharded_field_lookup",
    "table_from_numpy",
]


def _resolve_impl(impl: str | None, device: torch.device) -> str:
    """``None`` means the kernel on the card and the plain path on the CPU."""
    if impl is None:
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in ops.IMPLS:
        raise ValueError(f"impl {impl!r} not in {ops.IMPLS}")
    return impl


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, the table on {table.device}")
    return table[ids.clamp(0, table.shape[0] - 1)]


def bag_inputs(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bag reduce's operands: rows [B, L, D] and masked weights [B, L]."""
    mask = (ids >= 0).to(table.dtype)
    w = mask if weights is None else weights.to(table.dtype) * mask
    return _gather(table, ids), w


def combine_bags(out: torch.Tensor, w: torch.Tensor, combine: str) -> torch.Tensor:
    """``"sum"`` keeps the reduced bags; ``"mean"`` divides by max(Σ w, 1)."""
    if combine == "sum":
        return out
    if combine == "mean":
        return out / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    raise ValueError(f"combine {combine!r} not in {COMBINES}")


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    combine: str = "sum",
    impl: str | None = None,
) -> torch.Tensor:
    """Fixed-width multi-hot bag: out[b] = reduce_l w[b, l] · table[ids[b, l]].

    ``table`` is [V, D], ``ids`` [B, L] (-1 = padding), ``weights`` [B, L]
    or None; the result is [B, D] in the table's dtype.
    """
    impl = _resolve_impl(impl, table.device)
    rows, w = bag_inputs(table, ids, weights)
    return combine_bags(ops.bag_reduce(rows, w, impl=impl), w, combine)


def embedding_bag_ragged(
    table: torch.Tensor,
    flat_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    n_bags: int,
    combine: str = "sum",
) -> torch.Tensor:
    """Ragged bags: out[s] = reduce of table[flat_ids[i]] over segment_ids[i] == s.

    ``flat_ids`` and ``segment_ids`` are [N]; ids below 0 add nothing, and
    segment ids outside ``[0, n_bags)`` are dropped. The result is [n_bags, D].
    """
    if combine not in COMBINES:
        raise ValueError(f"combine {combine!r} not in {COMBINES}")
    if segment_ids.device != table.device:
        raise ValueError(
            f"segment_ids are on {segment_ids.device}, the table on {table.device}")
    valid = flat_ids >= 0
    rows = torch.where(valid[:, None], _gather(table, flat_ids), 0)
    keep = (segment_ids >= 0) & (segment_ids < n_bags)
    seg = segment_ids[keep].to(torch.int64)
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    out.index_add_(0, seg, rows[keep])
    if combine == "mean":
        cnt = torch.zeros(n_bags, dtype=table.dtype, device=table.device)
        cnt.index_add_(0, seg, valid[keep].to(table.dtype))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def sharded_field_lookup(table: torch.Tensor, ids: torch.Tensor, shard_ctx=None, *,
                         placed: bool = False):
    """Field lookup: table[ids] with padding ids (< 0) reading zeros.

    With a ``ShardCtx`` the table is row-sharded over its ``model`` axis
    in contiguous blocks (``P(model, None)``): every rank calls this with
    the global table and ids, keeps its own row block, resolves the ids
    that fall inside it (the others read zeros) and the sum over
    ``model`` assembles the full rows, the reference's ``psum``. The id
    stream is split over the data axes only when it divides evenly, and
    replicated otherwise; every rank gets the whole [..., D] result.
    ``placed=True`` takes ``table`` as this rank's row block and ``ids`` as
    this rank's ids already (a tower on placed parameters): the result is
    this rank's rows, and under autograd each block gets its rows'
    gradient.
    """
    if shard_ctx is None:
        return _gather(table, ids) * (ids >= 0)[..., None].to(table.dtype)
    from repro_torch.distributed import sharding as mesh_lib

    if placed:
        m_axis = shard_ctx.model_axis
        with mesh_lib.bound(shard_ctx.mesh):
            m = mesh_lib.axis_index(m_axis)
            V_loc = table.shape[0]
            local = ids - m * V_loc
            own = (ids >= 0) & (local >= 0) & (local < V_loc)
            rows = table[local.clamp(0, V_loc - 1)]
            return mesh_lib.psum(torch.where(own[..., None], rows, torch.zeros_like(rows)),
                                 m_axis)
    mesh_lib.require_group("sharded_field_lookup with a sharding context")
    m_axis = shard_ctx.model_axis

    def body(tbl_local, ids_local):
        m = mesh_lib.axis_index(m_axis)
        rows_per = tbl_local.shape[0]  # V / n_model (contiguous blocks)
        owner = torch.where(ids_local >= 0, torch.div(ids_local, rows_per,
                                                      rounding_mode="floor"), -1)
        local_row = torch.clamp(ids_local - m * rows_per, 0, rows_per - 1)
        rows = tbl_local[local_row]
        rows = torch.where((owner == m)[..., None], rows, torch.zeros_like(rows))
        return mesh_lib.psum(rows, m_axis)

    shape = ids.shape
    flat = ids.reshape(-1)
    # Shard the id stream over data only when it divides; tiny id sets
    # (e.g. batch-1 retrieval user features) are replicated instead.
    da = tuple(shard_ctx.data_axes)
    ids_spec = mesh_lib.P(da) if flat.shape[0] % shard_ctx.n_data == 0 else mesh_lib.P()
    fn = mesh_lib.shard_map(
        body,
        mesh=shard_ctx.mesh,
        in_specs=(mesh_lib.P(m_axis, None), ids_spec),
        out_specs=mesh_lib.P(*ids_spec, None),
    )
    out = fn(table, flat)
    return out.reshape(*shape, table.shape[1])


def table_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """A table of the JAX package (float32 or bfloat16 numpy) as a tensor.

    Bit for bit: bfloat16 (``ml_dtypes``) crosses as its 16-bit pattern.
    ``device=None`` is the card; a missing card raises, and
    ``device="cpu"`` keeps the table on the CPU.
    """
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.dtype != np.float32 and not (a.dtype.name == "bfloat16" and a.dtype.itemsize == 2):
        raise TypeError(f"table must be float32 or bfloat16, got {a.dtype}")
    return tensor_from_numpy(a, dev)
