"""GraphSAGE (mean aggregator) over explicit edge lists, on one device.

The counterpart of the JAX package's ``models/gnn.py``. Message passing is
gather(src) -> segment sum over dst -> degree normalisation, the reference's
``jax.ops.segment_sum`` as ``index_add_`` into a trash row:

  * full-graph forward (``full_graph_sm`` / ``ogb_products`` shapes);
  * sampled layered-subgraph forward (``minibatch_lg``: hop k uses the k-th
    sampled edge set);
  * batched small graphs with mean readout (``molecule``).

Padded edges (src = -1) drop out, as do destinations outside [0, n), which
``segment_sum`` drops. The gather and the sum run over ``EDGE_CHUNK`` edges
at a time, so that the [E, d] messages never exist whole (ogb_products'
61.9M edges at d 128 would be 31.7 GB, and their gradient as much again);
on the CPU the sum's order is the edges' order either way. The hidden
layers' ``max(norm, 1e-6)`` keeps the reference's split gradient at a tie.
``sage_forward_sharded`` partitions the graph over a mesh's data axes:
nodes in contiguous blocks, edges binned by their destination's block, the
first hop's mean aggregate precomputed (it depends on no weight), so each
later layer's aggregation is local after one bfloat16 ``all_gather`` of
the hidden rows; the parameters are replicated (``sage_param_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.range_daat import resolve_device
from repro_torch.distributed.sharding import (
    P,
    all_gather_tiled,
    bound,
    mesh_coord,
    psum,
    sum_grads,
)
from repro_torch.models.layers import Params, dense_init, gather_rows, make_generator, maximum

__all__ = ["SAGEConfig", "init_sage", "sage_forward", "sage_forward_sampled",
           "sage_forward_graphs", "sage_param_specs", "sage_forward_sharded",
           "sage_loss_per_node", "shard_graph", "edge_sharded"]

EDGE_CHUNK = 1 << 23  # edges gathered and summed at a time


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    n_layers: int
    d_in: int
    d_hidden: int
    n_classes: int
    sample_sizes: tuple[int, ...] = (25, 10)
    dtype: Any = torch.float32


def init_sage(key, cfg: SAGEConfig, device=None):
    """Random parameters on ``device`` (None: the card). ``key`` is an int
    seed or a ``torch.Generator`` there."""
    dev = resolve_device(device)
    gen = make_generator(key, dev)
    layers = []
    d = cfg.d_in
    for i in range(cfg.n_layers):
        out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        layers.append(Params(
            w_self=dense_init(gen, d, out, cfg.dtype, device=dev),
            w_neigh=dense_init(gen, d, out, cfg.dtype, device=dev),
            b=torch.zeros((out,), dtype=cfg.dtype, device=dev),
        ))
        d = out
    return Params(layers=nn.ModuleList(layers))


def _segment_sum(values_fn, dst, n_rows: int, width: int, dtype, device):
    """``segment_sum`` of ``values_fn(lo, hi)`` (the values of edges lo:hi)
    over ``dst`` into ``n_rows`` rows, ``EDGE_CHUNK`` edges at a time."""
    out = torch.zeros((n_rows, width), dtype=dtype, device=device)
    for lo in range(0, dst.shape[0], EDGE_CHUNK):
        hi = min(lo + EDGE_CHUNK, dst.shape[0])
        out = out.index_add(0, dst[lo:hi], values_fn(lo, hi))
    return out


_EDGE_CTX: list = []  # the context of an ``edge_sharded`` loss running on this rank


def edge_sharded(loss_fn, shard_ctx):
    """``loss_fn`` on replicated nodes whose edges are this rank's block over
    the data axes (the baseline variant's layout on a mesh): every mean
    aggregation sums this rank's edges and a ``psum`` over the data axes
    completes the sums and the degrees (its gradient summed over them too:
    every rank uses the sums alike). The loss is returned as ``psum(L /
    n_data)``: the value L on every rank, each backward pass its share."""
    da = tuple(shard_ctx.data_axes)

    def loss(p, b):
        _EDGE_CTX.append(shard_ctx)
        try:
            with bound(shard_ctx.mesh):
                return psum(loss_fn(p, b) / shard_ctx.n_data, da)
        finally:
            _EDGE_CTX.pop()

    return loss


def _mean_aggregate(h, src_idx, dst_idx, n_nodes):
    """mean_{(s,d) in E} h[s] grouped by d; padded (-1) edges drop out."""
    src_idx, dst_idx = src_idx.long(), dst_idx.long()
    valid = src_idx >= 0
    dst = torch.where(valid & (dst_idx >= 0) & (dst_idx <= n_nodes), dst_idx, n_nodes)

    def msgs(lo, hi):
        rows = gather_rows(h, src_idx[lo:hi].clamp(min=0))
        return torch.where(valid[lo:hi, None], rows, 0)

    summed = _segment_sum(msgs, dst, n_nodes + 1, h.shape[1], h.dtype, h.device)[:-1]
    deg = torch.zeros(n_nodes + 1, dtype=h.dtype, device=h.device).index_add(
        0, dst, valid.to(h.dtype))[:-1]
    if _EDGE_CTX:
        da = tuple(_EDGE_CTX[-1].data_axes)
        summed, deg = sum_grads(psum(summed, da), da), psum(deg, da)
    return summed / torch.clamp(deg, min=1.0)[:, None]


def _sage_layer(layer, h, agg, last: bool):
    out = h @ layer["w_self"] + agg @ layer["w_neigh"] + layer["b"]
    if last:
        return out
    out = torch.relu(out)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / maximum(norm, 1e-6)


def _on_device(params, *arrays):
    dev = params["layers"][0]["w_self"].device
    return [torch.as_tensor(a, device=dev) for a in arrays]


def sage_forward(params, feats, edges, cfg: SAGEConfig):
    """Full-graph forward. feats [N, d]; edges [E, 2] (src, dst)."""
    feats, edges = _on_device(params, feats, edges)
    h = feats.to(cfg.dtype)
    n = feats.shape[0]
    for i, layer in enumerate(params["layers"]):
        agg = _mean_aggregate(h, edges[:, 0], edges[:, 1], n)
        h = _sage_layer(layer, h, agg, i == len(params["layers"]) - 1)
    return h  # [N, n_classes] at the last layer


def sage_forward_sampled(params, feats, hops, cfg: SAGEConfig, n_batch: int):
    """Layered-subgraph forward: hop k's edges feed layer k (outermost first).

    feats [n_sub, d] over the union node set; returns logits for the first
    n_batch nodes (the seed batch).
    """
    (feats,) = _on_device(params, feats)
    h = feats.to(cfg.dtype)
    n = feats.shape[0]
    L = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        src, dst = _on_device(params, *hops[L - 1 - i])  # outermost hop aggregates first
        agg = _mean_aggregate(h, src, dst, n)
        h = _sage_layer(layer, h, agg, i == L - 1)
    return h[:n_batch]


def sage_forward_graphs(params, feats, edges, graph_ids, n_graphs, cfg: SAGEConfig):
    """Batched small graphs: node embeddings -> mean readout per graph."""
    feats, edges, graph_ids = _on_device(params, feats, edges, graph_ids)
    h = feats.to(cfg.dtype)
    n = feats.shape[0]
    for i, layer in enumerate(params["layers"]):
        agg = _mean_aggregate(h, edges[:, 0], edges[:, 1], n)
        h = _sage_layer(layer, h, agg, i == len(params["layers"]) - 1)
    gids = graph_ids.long()
    keep = (gids >= 0) & (gids < n_graphs)
    gids = torch.where(keep, gids, n_graphs)
    summed = torch.zeros((n_graphs + 1, h.shape[1]), dtype=h.dtype, device=h.device
                         ).index_add(0, gids, h)[:-1]
    counts = torch.zeros(n_graphs + 1, dtype=h.dtype, device=h.device).index_add(
        0, gids, torch.ones(n, dtype=h.dtype, device=h.device))[:-1]
    return summed / torch.clamp(counts, min=1.0)[:, None]


def sage_loss(logits, labels):
    lf = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=lf.device).long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def sage_loss_per_node(logits, labels):
    """Per-node CE (no reduction), the sharded variant's loss."""
    lf = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=lf.device).long()
    return torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels[:, None])[:, 0]


def sage_param_specs(cfg: SAGEConfig, model_axis: str = "model"):
    """Every layer replicated (the hidden dims are small; the heavy axis,
    the edges, is handled by the inputs' sharding)."""
    del model_axis
    return {"layers": [{"w_self": P(), "w_neigh": P(), "b": P()}
                       for _ in range(cfg.n_layers)]}


def sage_forward_sharded(params, feats_loc, agg0_loc, edges_loc, cfg: SAGEConfig,
                         n_nodes: int, shard_ctx):
    """Node/dst-partitioned full-batch forward on placed inputs.

    feats_loc [N/D, d]: this rank's node block (contiguous); agg0_loc
    [N/D, d]: the precomputed first-hop mean aggregate of those nodes;
    edges_loc [E/D, 2]: edges whose dst lies in the block (-1 padded).
    Returns this rank's logits [N/D, n_classes]. Under autograd the
    gathered rows send their gradient back to the ranks that own them.
    """
    del n_nodes
    da = tuple(shard_ctx.data_axes)
    with bound(shard_ctx.mesh):
        feats_loc, agg0_loc, edges_loc = _on_device(params, feats_loc, agg0_loc, edges_loc)
        n_loc = feats_loc.shape[0]
        base = mesh_coord(shard_ctx.mesh, shard_ctx.data_axes)[0] * n_loc
        h = feats_loc.to(cfg.dtype)
        L = len(params["layers"])
        src = edges_loc[:, 0].long()
        dst = edges_loc[:, 1].long()
        dst_local = torch.where(dst >= 0, dst - base, n_loc)
        valid = (src >= 0) & (dst_local >= 0) & (dst_local < n_loc)
        seg = torch.where(valid, dst_local, n_loc)
        for i, layer in enumerate(params["layers"]):
            if i == 0:
                agg = agg0_loc.to(cfg.dtype)  # precomputed, no collective
            else:
                # The rows cross in bfloat16; the gather (and its scatter-add
                # in the backward pass) runs in the compute dtype.
                h_full = all_gather_tiled(h.to(torch.bfloat16), da, 0).to(cfg.dtype)

                def msgs(lo, hi, h_full=h_full):
                    rows = h_full[src[lo:hi].clamp(min=0)]
                    return torch.where(valid[lo:hi, None], rows, 0)

                summed = _segment_sum(msgs, seg, n_loc + 1, h.shape[1], cfg.dtype,
                                      h.device)[:-1]
                deg = torch.zeros(n_loc + 1, dtype=cfg.dtype, device=h.device).index_add(
                    0, seg, valid.to(cfg.dtype))[:-1]
                agg = summed / torch.clamp(deg, min=1.0)[:, None]
            h = _sage_layer(layer, h, agg, i == L - 1)
        return h


def shard_graph(feats, edges, labels, n_shards: int, n_pad: int, e_pad: int,
                device=None) -> dict:
    """The sharded variant's inputs from a graph: nodes padded to ``n_pad``
    (labels -1), ``agg0`` the first hop's mean aggregate (computed on
    ``device``, None: the card), and the edges binned by their destination's
    block of ``n_pad / n_shards`` nodes into ``n_shards`` equal bins of
    ``e_pad / n_shards`` (-1 padded, each bin in the edges' order). Raises
    when a bin overflows."""
    dev = resolve_device(device)
    feats = torch.as_tensor(feats, device=dev)
    edges = torch.as_tensor(edges, device=dev)
    n, d = feats.shape
    agg0 = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    agg0[:n] = _mean_aggregate(feats.to(torch.float32), edges[:, 0], edges[:, 1], n)
    fp = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    fp[:n] = feats
    lab = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    lab[:n] = torch.as_tensor(labels, device=dev)
    n_loc, width = n_pad // n_shards, e_pad // n_shards
    e = edges[(edges[:, 0] >= 0) & (edges[:, 1] >= 0)]
    owner = e[:, 1].long() // n_loc
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n_shards)
    if int(counts.max()) > width:
        raise ValueError(f"an edge bin holds {int(counts.max())} edges, more than its "
                         f"{width} slots")
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(e.shape[0], device=dev) - starts[owner[order]] + owner[order] * width
    out = torch.full((e_pad, 2), -1, dtype=torch.int32, device=dev)
    out[slot] = e[order].to(torch.int32)
    return {"feats": fp, "agg0": agg0, "edges": out, "labels": lab}
