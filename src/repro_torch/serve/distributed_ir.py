"""Distributed anytime IR: ISN shards and the broker merge, on one card.

The paper's deployment story (§1, §7): a collection too large for one node is
partitioned across index server nodes; every query runs on all partitions and
a broker merges per-node top-k lists (DESIGN.md §4-§5; ``serving/sharded.py``
is the range-partitioned sibling that shards one index at range boundaries
instead of building per-node sub-indexes from a random document split):

  * the corpus is split into M shards, each a self-contained
    cluster-skipping sub-index (its own ranges, bounds, local docid space),
    all under one global quantizer so their integer scores merge;
  * each shard runs the *single-node* anytime traversal over its
    sub-index with a per-shard work budget — the per-ISN SLA quantum;
  * the broker merge takes the global top-k of the gathered per-shard
    lists.

The port's path is the reference's on one device: the M sub-indexes are
stacked shard-major ``[M, ...]`` on the card, and the Q x M (query, shard)
lanes run as one launch of the ``traverse`` kernel (lane n reads shard
n % M, ``core.range_daat.traverse_lanes``), followed by the local->global
docid lift and the broker merge in plain torch on the device. The merge
is the reference's ``argsort(-vals)[:, :k]``, a stable sort: tied scores
keep their gathered (shard-major) position. A context spanning more than
one device (the reference's ``shard_map`` over a mesh) waits for the
mesh paths (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bm25 import invert
from repro_torch.core.clustered_index import build_index
from repro_torch.core.quantize import fit_quantizer
from repro_torch.core.range_daat import (
    DeviceIndex,
    Engine,
    batched_init_carry,
    carry_buffer,
    lane_caps,
    resolve_device,
    traverse_lanes,
    upload_int32,
)
from repro_torch.data.synth import Corpus

__all__ = [
    "ShardedIndexArrays",
    "build_sharded_index",
    "merge_shard_topk",
    "make_sharded_query_fn",
    "plan_queries",
    "sharded_anytime_query",
    "sharded_query_specs",
]

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ShardedIndexArrays:
    """Shard-major device arrays (all leading dim = M shards)."""

    docs: torch.Tensor  # [M, NNZ] int32 local docids
    impacts: torch.Tensor  # [M, NNZ] int32
    blk_start: torch.Tensor  # [M, NB] int32
    blk_len: torch.Tensor  # [M, NB] int32
    blk_maximp: torch.Tensor  # [M, NB] int32
    range_starts: torch.Tensor  # [M, R_loc] int32 (local docid space)
    doc_base: torch.Tensor  # [M] int32 — global docid offset per shard
    s_pad: int
    k: int

    def to(self, device) -> "ShardedIndexArrays":
        """The same arrays on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name not in ("s_pad", "k")})

    def device_index(self) -> DeviceIndex:
        """The shards as one stacked ``DeviceIndex`` (int32 impacts, raw
        int32 docids). Bounds arrive through the plan tables, so
        ``bounds_dense`` and ``range_sizes`` are placeholders, as in the
        reference's per-shard traversal."""
        M = self.docs.shape[0]
        return DeviceIndex(
            docs=self.docs, impacts=self.impacts, blk_start=self.blk_start,
            blk_len=self.blk_len, blk_maximp=self.blk_maximp,
            bounds_dense=torch.zeros((M, 1, 1), dtype=torch.int32,
                                     device=self.docs.device),
            range_starts=self.range_starts,
            range_sizes=torch.zeros_like(self.range_starts),
        )


def build_sharded_index(
    corpus: Corpus, n_shards: int, n_ranges_per_shard: int = 8, bits: int = 8,
    strategy: str = "clustered_bp", seed: int = 0, device=None,
):
    """Round-robin partition the corpus, build one sub-index per shard.

    Returns (arrays, engines) — engines are the per-shard host Engine
    objects (for planning query block tables per shard). The host build
    is the reference's, array for array; ``device`` (None: the card;
    ``"cpu"`` for the plain path on the CPU) holds the stacked arrays and
    the engines.
    """
    dev = resolve_device(device)
    # One GLOBAL quantizer so per-shard integer scores are merge-compatible.
    global_quant = fit_quantizer(invert(corpus).scores, bits=bits)

    # Split docs round-robin (the random-partition policy of §7.2).
    shard_of = np.arange(corpus.n_docs) % n_shards
    engines = []
    for m in range(n_shards):
        docs_m = np.nonzero(shard_of == m)[0]
        ptr = [0]
        terms = []
        tfs = []
        for d in docs_m:
            t, f = corpus.doc_slice(int(d))
            terms.append(t)
            tfs.append(f)
            ptr.append(ptr[-1] + len(t))
        sub = Corpus(
            n_docs=len(docs_m),
            n_terms=corpus.n_terms,
            doc_ptr=np.asarray(ptr, np.int64),
            doc_terms=np.concatenate(terms) if terms else np.empty(0, np.int32),
            doc_tfs=np.concatenate(tfs) if tfs else np.empty(0, np.int32),
            doc_topic=corpus.doc_topic[docs_m],
            n_topics=corpus.n_topics,
        )
        idx = build_index(
            sub, n_ranges=n_ranges_per_shard, strategy=strategy, bits=bits,
            seed=seed + m, quantizer=global_quant,
        )
        engines.append(Engine(idx, k=10, device=dev))

    # Pad per-shard arrays to common sizes and stack shard-major.
    def stack(get, pad_val=0, dtype=np.int32):
        arrs = [np.asarray(get(e.index), dtype=dtype) for e in engines]
        width = max(a.shape[0] for a in arrs)
        out = np.full((n_shards, width), pad_val, dtype=dtype)
        for m, a in enumerate(arrs):
            out[m, : a.shape[0]] = a
        return torch.from_numpy(out).to(dev)

    s_pad = max(e.s_pad for e in engines)
    doc_base = np.zeros(n_shards, np.int32)
    # global id = base + local id; bases spaced by padded shard size
    sizes = [e.index.n_docs for e in engines]
    doc_base[1:] = np.cumsum(sizes)[:-1]

    arrays = ShardedIndexArrays(
        docs=stack(lambda i: i.docs),
        impacts=stack(lambda i: i.impacts),
        blk_start=stack(lambda i: i.blk_start),
        blk_len=stack(lambda i: i.blk_len),
        blk_maximp=stack(lambda i: i.blk_maximp),
        range_starts=stack(lambda i: i.range_starts),
        doc_base=torch.from_numpy(doc_base).to(dev),
        s_pad=s_pad,
        k=10,
    )
    return arrays, engines


def plan_queries(engines, q_terms_batch: np.ndarray):
    """Host-side per-shard plans -> stacked [Q, M, R, B] tables.

    The reference's tables as host numpy int32 arrays (the port's plans
    hold host tables): ``sharded_anytime_query`` uploads them in one copy.
    """
    M = len(engines)
    Q = q_terms_batch.shape[0]
    plans = [[e.plan(q_terms_batch[qi]) for e in engines] for qi in range(Q)]
    R = max(p.order_host.shape[0] for row in plans for p in row)
    B = max(p.blk_tab_host.shape[1] for row in plans for p in row)

    blk = np.full((Q, M, R, B), -1, np.int32)
    rest = np.zeros((Q, M, R, B), np.int32)
    order = np.zeros((Q, M, R), np.int32)
    bounds = np.zeros((Q, M, R), np.int32)
    for qi in range(Q):
        for m in range(M):
            p = plans[qi][m]
            r, b = p.blk_tab_host.shape
            blk[qi, m, :r, :b] = p.blk_tab_host
            rest[qi, m, :r, :b] = p.rest_tab_host
            order[qi, m, :r] = p.order_host
            bounds[qi, m, :r] = p.ordered_bounds_host
    return blk, rest, order, bounds


def merge_shard_topk(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """[Q, M, k] per-shard lists (global ids) -> ([Q, k], [Q, k]).

    The reference's broker merge: ``argsort(-vals)`` over the gathered
    shard-major ``[Q, M * k]`` row, stable, first k. Tied scores keep their
    gathered position (shard, then heap slot), which is not the
    *(score desc, docid asc)* order of ``serving.sharded``'s merge.
    """
    q = vals.shape[0]
    mv, mi = vals.reshape(q, -1), gids.reshape(q, -1)
    sel = torch.sort(-mv.to(torch.int64), dim=1, stable=True).indices[:, :k]
    return torch.gather(mv, 1, sel), torch.gather(mi, 1, sel)


def _ctx_devices(ctx) -> int:
    """Devices a sharding context spans: 1 for None; else its model x data
    extent (the reference's ``ShardCtx.n_model * n_data``)."""
    if ctx is None:
        return 1
    return int(getattr(ctx, "n_model", 1)) * int(getattr(ctx, "n_data", 1))


def sharded_query_specs(
    *, n_queries: int, n_shards: int, r_loc: int, b_width: int, nnz_loc: int,
    nb_loc: int, s_pad: int, k: int, impact_dtype=torch.int32,
):
    """Meta-device tensors of the web-scale sharded index and its plan
    tables (the reference's ShapeDtypeStructs): shapes and types, no
    allocation. ``impact_dtype=torch.int8`` stores impacts at their native
    8-bit width."""
    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    arrays = ShardedIndexArrays(
        docs=i32(n_shards, nnz_loc),
        impacts=torch.empty((n_shards, nnz_loc), dtype=impact_dtype, device="meta"),
        blk_start=i32(n_shards, nb_loc),
        blk_len=i32(n_shards, nb_loc),
        blk_maximp=i32(n_shards, nb_loc),
        range_starts=i32(n_shards, r_loc),
        doc_base=i32(n_shards),
        s_pad=s_pad,
        k=k,
    )
    tables = (
        i32(n_queries, n_shards, r_loc, b_width),
        i32(n_queries, n_shards, r_loc, b_width),
        i32(n_queries, n_shards, r_loc),
        i32(n_queries, n_shards, r_loc),
    )
    return arrays, tables


def make_sharded_query_fn(ctx, *, s_pad: int, k: int, budget: int, impl: str | None = None):
    """The sharded query step (the ``anytime-ir`` serve step):
    ``step(arrays, tables) -> (vals [Q, k], ids [Q, k] global, ranges)``.

    Every (query, shard) pair's anytime traversal with the postings budget
    ``budget``, safe stop and block pruning on, then the broker merge. On
    the arrays' device: one upload and, under ``impl="cuda"`` (the default
    on the card), one ``traverse`` launch for the Q x M lanes;
    ``impl="torch"`` is its plain version. ``ctx`` is None or a one-device
    context; a context over more devices raises ``NotImplementedError``
    (ROADMAP A7).
    """
    if _ctx_devices(ctx) != 1:
        raise NotImplementedError(
            f"a sharding context over {_ctx_devices(ctx)} devices (the reference's "
            "shard_map over the mesh, serve/distributed_ir.py:213-270) is not ported "
            "yet, ROADMAP A7's mesh item; pass ctx=None to run every (query, shard) "
            "pair on the arrays' device"
        )

    def step(arrays: ShardedIndexArrays, tables):
        blk, rest, order, bounds = (np.asarray(t) for t in tables)
        Q, M, R, B = blk.shape
        dix = arrays.device_index()
        dev = arrays.docs.device
        lane_impl = impl or ("cuda" if dev.type == "cuda" else "torch")
        n = Q * M
        lanes = upload_int32(
            (blk.reshape(n, R, B), rest.reshape(n, R, B), order.reshape(n, R),
             bounds.reshape(n, R), lane_caps(np.full(n, budget, np.int64)),
             lane_caps(np.full(n, INT32_MAX, np.int64)),
             carry_buffer(batched_init_carry(n, k))),
            dev,
        )
        out = traverse_lanes(dix, *lanes, s_pad=s_pad, k=k, impl=lane_impl).view(
            Q, M, 2 * k + 5)
        ids = out[:, :, k + 2:2 * k + 2]
        gids = torch.where(ids >= 0, ids + arrays.doc_base[None, :, None], -1)
        out_v, out_i = merge_shard_topk(out[:, :, :k], gids, k)
        return out_v, out_i, out[:, :, 2 * k + 2].sum()

    return step


def sharded_anytime_query(arrays, tables, ctx, budget: int = 2**31 - 1,
                          impl: str | None = None):
    """``make_sharded_query_fn``'s step at the arrays' ``s_pad`` and ``k``:
    ``(vals [Q, k], ids [Q, k] global, ranges)`` on the arrays' device,
    ``ranges`` the ranges processed summed over every query and shard (the
    reference's ``psum``). ``tables`` are ``plan_queries``' [Q, M, R, B]
    tables."""
    step = make_sharded_query_fn(ctx, s_pad=arrays.s_pad, k=arrays.k, budget=budget,
                                 impl=impl)
    return step(arrays, tables)
