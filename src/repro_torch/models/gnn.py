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
``sage_forward_sharded`` and ``sage_param_specs`` lay the graph out over a
mesh; they raise until the mesh paths are ported (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.range_daat import resolve_device
from repro_torch.models.layers import Params, dense_init, gather_rows, make_generator, maximum

__all__ = ["SAGEConfig", "init_sage", "sage_forward", "sage_forward_sampled",
           "sage_forward_graphs", "sage_param_specs"]

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


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} partitions the graph's nodes and edges over a device mesh "
        "(shard_map in the reference); the mesh paths are ROADMAP A7")


def sage_param_specs(cfg: SAGEConfig, model_axis: str = "model"):
    _needs_mesh("sage_param_specs")


def sage_forward_sharded(params, feats_loc, agg0_loc, edges_loc, cfg: SAGEConfig,
                         n_nodes: int, shard_ctx):
    _needs_mesh("sage_forward_sharded")
