"""Graph substrate: synthetic graphs, CSR adjacency, neighbor sampling.

A copy of the JAX package's ``data/graphs.py`` (numpy only; the port keeps
its own copy and imports nothing of the reference). It is pinned array for
array against the reference in ``tests/test_torch_train_archs.py``. The
neighbor sampler is a real fanout sampler over CSR (GraphSAGE minibatch
training): it produces the layered subgraph arrays the model consumes,
with deterministic seeding and fixed padded shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GraphData", "make_graph", "to_csr", "sample_subgraph", "make_molecule_batch"]


@dataclasses.dataclass(frozen=True)
class GraphData:
    n_nodes: int
    edges: np.ndarray  # [E, 2] int32 (src, dst)
    feats: np.ndarray  # [N, d] float32
    labels: np.ndarray  # [N] int32


def make_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int = 16,
    seed: int = 0,
) -> GraphData:
    """Community-structured random graph with learnable labels."""
    rng = np.random.default_rng(seed)
    n_comm = max(2, n_classes)
    comm = rng.integers(0, n_comm, size=n_nodes)
    # 80% intra-community edges, 20% random (degree-skewed endpoints).
    n_intra = int(n_edges * 0.8)
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = np.empty(n_edges, dtype=np.int64)
    # intra: pick dst from same community via sorted trick
    order = np.argsort(comm, kind="stable")
    starts = np.searchsorted(comm[order], np.arange(n_comm))
    ends = np.concatenate([starts[1:], [n_nodes]])
    cs = comm[src[:n_intra]]
    lo, hi = starts[cs], ends[cs]
    dst[:n_intra] = order[(lo + rng.random(n_intra) * np.maximum(hi - lo, 1)).astype(np.int64)]
    dst[n_intra:] = rng.integers(0, n_nodes, size=n_edges - n_intra)
    edges = np.stack([src, dst], 1).astype(np.int32)

    centers = rng.normal(0, 1, size=(n_comm, d_feat)).astype(np.float32)
    feats = centers[comm] + rng.normal(0, 0.8, size=(n_nodes, d_feat)).astype(
        np.float32
    )
    labels = (comm % n_classes).astype(np.int32)
    return GraphData(n_nodes=n_nodes, edges=edges, feats=feats, labels=labels)


def to_csr(n_nodes: int, edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """In-neighbour CSR: for each dst node, the list of srcs."""
    order = np.argsort(edges[:, 1], kind="stable")
    srcs = edges[order, 0]
    counts = np.bincount(edges[:, 1], minlength=n_nodes)
    ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(counts)
    return ptr, srcs.astype(np.int32)


def sample_subgraph(
    ptr: np.ndarray,
    nbrs: np.ndarray,
    feats: np.ndarray,
    labels: np.ndarray,
    batch_nodes: np.ndarray,
    fanouts: tuple[int, ...],
    seed: int = 0,
):
    """Layered fanout sampling (GraphSAGE).

    Returns dict with fixed shapes:
      nodes   [n_sub]           all touched node ids (batch first)
      feats   [n_sub, d]
      labels  [n_batch]
      hops    list over layers (outermost hop first) of (src_idx, dst_idx)
              index pairs into ``nodes``, each padded to batch*prod(fanouts).
    """
    rng = np.random.default_rng(seed)
    frontier = np.asarray(batch_nodes, dtype=np.int64)
    node_index: dict[int, int] = {int(n): i for i, n in enumerate(frontier)}
    nodes: list[int] = [int(n) for n in frontier]
    hops = []
    for f in fanouts:
        src_idx: list[int] = []
        dst_idx: list[int] = []
        nxt: list[int] = []
        for d in frontier:
            lo, hi = int(ptr[d]), int(ptr[d + 1])
            if hi == lo:
                continue
            take = rng.integers(lo, hi, size=f)
            for s in nbrs[take]:
                s = int(s)
                if s not in node_index:
                    node_index[s] = len(nodes)
                    nodes.append(s)
                    nxt.append(s)
                src_idx.append(node_index[s])
                dst_idx.append(node_index[int(d)])
        pad = len(frontier) * f
        src = np.full(pad, -1, dtype=np.int32)
        dst = np.full(pad, -1, dtype=np.int32)
        src[: len(src_idx)] = src_idx
        dst[: len(dst_idx)] = dst_idx
        hops.append((src, dst))
        frontier = np.asarray(nxt + list(frontier), dtype=np.int64)
    nodes_arr = np.asarray(nodes, dtype=np.int64)
    return {
        "nodes": nodes_arr,
        "feats": feats[nodes_arr].astype(np.float32),
        "labels": labels[np.asarray(batch_nodes, dtype=np.int64)].astype(np.int32),
        "hops": hops,
        "n_batch": len(batch_nodes),
    }


def make_molecule_batch(
    batch: int, n_nodes: int, n_edges: int, d_feat: int, n_classes: int, seed: int = 0
):
    """Block-diagonal batch of small graphs (the ``molecule`` shape)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, size=(batch * n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, size=(batch, n_edges))
    dst = rng.integers(0, n_nodes, size=(batch, n_edges))
    off = (np.arange(batch) * n_nodes)[:, None]
    edges = np.stack([(src + off).ravel(), (dst + off).ravel()], 1).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    labels = rng.integers(0, n_classes, size=batch).astype(np.int32)
    return feats, edges, graph_ids, labels
