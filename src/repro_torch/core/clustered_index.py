"""Cluster-skipping inverted index (paper §3, Figs 2-4).

Host-side structure (numpy, built offline):

  * document-ordered postings, CSR by term, docids under the arrangement's
    permutation, impacts globally quantized to b bits;
  * fixed-width posting *blocks* (BLOCK=128, the paper's SIMD-BP128 geometry
    and the TPU lane width) that never cross a range boundary, each with
    max-docid and max-impact metadata — this is the skip structure that makes
    SeekGEQ an O(1) indexed access in either direction;
  * a (term, range) directory with the per-range upper bounds U[t, r] used by
    BoundSum and by safe early termination;
  * the cluster map (range_ends) — the paper's C vector.

The port's copy of the JAX package's host-side build: the same numpy code,
so an index built here is array-for-array the reference's. The device-side
mirror (``range_daat.DeviceIndex``) holds flat torch tensors. An index the
reference built crosses over through :func:`index_from_arrays`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from repro_torch.core.bm25 import (
    BM25Params,
    CollectionStats,
    checked_int32,
    collection_stats,
    invert,
)
from repro_torch.core.quantize import Quantizer, fit_quantizer
from repro_torch.core.reorder import Arrangement, arrange
from repro_torch.data.synth import Corpus

BLOCK = 128

# Legal per-block packed widths (bits per docid delta). Every width divides
# 32, so no delta ever straddles a uint32 word (lane j occupies bits
# [j*w, (j+1)*w) of the block's word run and j*w % 32 + w <= 32 for every w
# here); 24 is excluded exactly because lane 1 would straddle a word
# boundary. The tuple doubles as the width-code table: the device directory
# stores ``index(PACK_WIDTHS, w)`` in the top bits of each entry.
PACK_WIDTHS = (0, 4, 8, 16, 32)

# Device directory entry layout (DESIGN.md §12): bits [0, PACK_DIR_BITS)
# hold the block's word offset, bits above hold its PACK_WIDTHS code. Caps
# the packed stream at 2^27 words = 512 MiB per engine/shard upload.
PACK_DIR_BITS = 27

__all__ = [
    "BLOCK",
    "PACK_DIR_BITS",
    "PACK_WIDTHS",
    "ClusteredIndex",
    "INDEX_ARRAYS",
    "IndexDelta",
    "IndexShard",
    "PackedPostings",
    "apply_delta",
    "balance_range_shards",
    "build_index",
    "build_index_cached",
    "device_bytes_report",
    "extend_index",
    "extended_arrangement",
    "index_from_arrays",
    "pack_dir_entries",
    "pack_docs",
    "plan_delta",
    "range_postings_mass",
    "shard_cuts",
    "shard_device_index",
    "unpack_docs",
]


def device_bytes_report(
    nnz: int,
    n_blocks: int,
    n_terms: int,
    n_ranges: int,
    impact_dtype: str = "int32",
    docs_format: str = "int32",
    n_pack_words: int = 0,
) -> dict[str, int]:
    """HBM bytes of a ``DeviceIndex`` upload from index dimensions alone.

    The single source of the accounting formula: the built index delegates
    here (``ClusteredIndex.device_bytes``), and artifact tooling computes
    the same report straight from manifest metadata without loading any
    array.

    With ``docs_format="packed"`` the ``docs`` entry covers the bit-packed
    delta word stream plus its per-block (word_start, width, first_doc)
    directory (DESIGN.md §12) — the int32 docid array is not uploaded.
    """
    if impact_dtype not in ("int32", "int8"):
        raise ValueError(f"impact_dtype {impact_dtype!r} not in ('int32', 'int8')")
    if docs_format not in ("int32", "packed"):
        raise ValueError(f"docs_format {docs_format!r} not in ('int32', 'packed')")
    imp_itemsize = 1 if impact_dtype == "int8" else 4
    if docs_format == "packed":
        # Word stream + the two int32 directory columns the engine uploads:
        # (word_start | width_code << PACK_DIR_BITS) and the first docid.
        docs_bytes = n_pack_words * 4 + 2 * n_blocks * 4
    else:
        docs_bytes = nnz * 4
    out = {
        "docs": docs_bytes,
        "impacts": nnz * imp_itemsize,
        "blk_start": n_blocks * 4,
        "blk_len": n_blocks * 4,
        "blk_maximp": n_blocks * 4,
        "bounds_dense": n_terms * n_ranges * 4,
        "range_starts": n_ranges * 4,
        "range_sizes": n_ranges * 4,
    }
    out["postings"] = out["docs"] + out["impacts"]
    out["total"] = sum(v for k, v in out.items() if k != "postings")
    return out


@dataclasses.dataclass(frozen=True)
class PackedPostings:
    """Per-block fixed-width bit-packed docid deltas (DESIGN.md §12).

    Block ``b`` stores its ``blk_len[b]`` docid deltas (``delta_0 = 0``
    explicitly, so lane ``j`` always reads bits ``[j*w, (j+1)*w)`` of the
    block's word run) at ``blk_width[b]`` bits each, starting at word
    ``blk_word_start[b]`` of the shared uint32 ``words`` stream; the
    absolute first docid lives out-of-band in ``blk_first``. Widths come
    from ``PACK_WIDTHS`` — the smallest that covers the block's max delta —
    so constant runs cost zero stream words.
    """

    words: np.ndarray  # [n_words] uint32 — packed delta stream
    blk_word_start: np.ndarray  # [NB] int64 — word offset per block
    blk_width: np.ndarray  # [NB] int32 — bits per delta (PACK_WIDTHS)
    blk_first: np.ndarray  # [NB] int32 — absolute first docid (0 if empty)
    n_postings: int

    @property
    def n_words(self) -> int:
        return int(self.words.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.blk_word_start.shape[0])

    def device_nbytes(self) -> int:
        """Bytes of the device upload: word stream + merged int32 directory
        (:func:`pack_dir_entries`) + first-docid column."""
        return self.n_words * 4 + 2 * self.n_blocks * 4


def _segment_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... as one flat int64 array."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    ends = np.cumsum(lens)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)


def pack_docs(
    docs: np.ndarray, blk_start: np.ndarray, blk_len: np.ndarray
) -> PackedPostings:
    """Bit-pack per-block docid deltas into a uint32 word stream.

    Width selection: the smallest of ``PACK_WIDTHS`` covering the block's
    max delta (0 for constant runs — including every single-posting block).
    Words per block: ``ceil(len * width / 32)``. Docids must be
    non-negative and non-decreasing within each block; raises
    ``ValueError`` otherwise.
    """
    docs = np.asarray(docs)
    blk_start = np.asarray(blk_start, np.int64)
    blk_len = np.asarray(blk_len, np.int64)
    nb = int(blk_start.shape[0])
    if nb and int(blk_len.max(initial=0)) > BLOCK:
        raise ValueError(f"block length exceeds BLOCK={BLOCK}")
    lane = _segment_arange(blk_len)
    seg = np.repeat(np.arange(nb, dtype=np.int64), blk_len)
    vals = docs[blk_start[seg] + lane].astype(np.int64)
    total = int(vals.shape[0])
    if total and int(vals.min()) < 0:
        raise ValueError("docids must be non-negative")
    # Deltas with delta_0 := 0 at each block head.
    prev = np.empty_like(vals)
    if total:
        prev[1:] = vals[:-1]
    heads = lane == 0
    prev[heads] = vals[heads]
    delta = vals - prev
    if total and int(delta.min()) < 0:
        raise ValueError("docids must be non-decreasing within a block")
    maxd = np.zeros(nb, np.int64)
    np.maximum.at(maxd, seg, delta)
    width = np.select(
        [maxd < (1 << w) for w in PACK_WIDTHS[:-1]],
        list(PACK_WIDTHS[:-1]),
        default=PACK_WIDTHS[-1],
    ).astype(np.int32)
    firsts = np.zeros(nb, np.int32)
    nz = blk_len > 0
    seg_head = np.cumsum(blk_len) - blk_len
    firsts[nz] = vals[seg_head[nz]].astype(np.int32)
    wpb = (blk_len * width.astype(np.int64) + 31) // 32
    word_start = np.cumsum(wpb) - wpb
    n_words = int(wpb.sum())
    words = np.zeros(n_words, np.uint32)
    w_post = width.astype(np.int64)[seg]
    packed_lanes = w_post > 0
    bit = lane[packed_lanes] * w_post[packed_lanes]
    word_idx = word_start[seg[packed_lanes]] + bit // 32
    # Byte-aligned widths: shift + width <= 32, each delta lands in one word.
    contrib = delta[packed_lanes].astype(np.uint64) << (bit % 32).astype(np.uint64)
    np.bitwise_or.at(words, word_idx, contrib.astype(np.uint32))
    return PackedPostings(
        words=words,
        blk_word_start=word_start,
        blk_width=width,
        blk_first=firsts,
        n_postings=total,
    )


def pack_dir_entries(packed: PackedPostings) -> np.ndarray:
    """Merge (word_start, width) into one int32 directory column.

    Entry layout: ``word_start | PACK_WIDTHS.index(width) << PACK_DIR_BITS``.
    Folding the 3-bit width code into the word offset's headroom is what
    takes the per-block directory from three uploaded columns to two —
    without it the directory overhead on short blocks eats most of the
    packing win (DESIGN.md §12).
    """
    if packed.n_words >= (1 << PACK_DIR_BITS):
        raise ValueError(
            f"packed stream has {packed.n_words} words >= 2^{PACK_DIR_BITS}; "
            f"shard the index before packing"
        )
    codes = np.searchsorted(np.asarray(PACK_WIDTHS), packed.blk_width)
    return (
        packed.blk_word_start.astype(np.int64) | (codes << PACK_DIR_BITS)
    ).astype(np.int32)


def unpack_docs(
    packed: PackedPostings, blk_start: np.ndarray, blk_len: np.ndarray
) -> np.ndarray:
    """Exact inverse of :func:`pack_docs`: rebuild the int32 docid array.

    Each block's deltas are masked out of the word stream and
    prefix-summed from ``blk_first``; results scatter back to
    ``blk_start[b] + lane``. ``unpack_docs(pack_docs(x, s, l), s, l) == x``
    bitwise for any valid block geometry.
    """
    blk_start = np.asarray(blk_start, np.int64)
    blk_len = np.asarray(blk_len, np.int64)
    nb = int(blk_start.shape[0])
    lane = _segment_arange(blk_len)
    seg = np.repeat(np.arange(nb, dtype=np.int64), blk_len)
    total = int(lane.shape[0])
    w = packed.blk_width.astype(np.int64)[seg]
    delta = np.zeros(total, np.int64)
    nzl = w > 0
    bit = lane[nzl] * w[nzl]
    word = packed.words[packed.blk_word_start[seg[nzl]] + bit // 32]
    mask = (np.int64(1) << w[nzl]) - 1
    delta[nzl] = (
        word.astype(np.uint64) >> (bit % 32).astype(np.uint64)
    ).astype(np.int64) & mask
    cs = np.cumsum(delta)
    seg_head = np.cumsum(blk_len) - blk_len
    base = np.zeros(nb, np.int64)
    nz = blk_len > 0
    # cumsum *before* each head (head's own delta is 0 by construction).
    base[nz] = cs[seg_head[nz]] - delta[seg_head[nz]]
    vals = packed.blk_first.astype(np.int64)[seg] + cs - base[seg]
    n_out = int((blk_start + blk_len).max(initial=0))
    out = np.zeros(n_out, np.int32)
    out[blk_start[seg] + lane] = vals.astype(np.int32)
    return out


@dataclasses.dataclass
class ClusteredIndex:
    n_docs: int
    n_terms: int
    arrangement: Arrangement
    quantizer: Quantizer

    # Postings, CSR by term (docids are *new* ids under the arrangement).
    ptr: np.ndarray  # [V+1] int64
    docs: np.ndarray  # [nnz] int32
    impacts: np.ndarray  # [nnz] int32 (1 .. 2^b - 1)

    # Blocks (never straddle a range boundary).
    blk_start: np.ndarray  # [NB] int64 offset into docs/impacts
    blk_len: np.ndarray  # [NB] int32 (<= BLOCK)
    blk_maxdoc: np.ndarray  # [NB] int32
    blk_maximp: np.ndarray  # [NB] int32
    blk_term: np.ndarray  # [NB] int32
    blk_range: np.ndarray  # [NB] int32

    # (term, range) directory — CSR over terms.
    tr_ptr: np.ndarray  # [V+1] int64
    tr_range: np.ndarray  # [NTR] int32
    tr_blk_start: np.ndarray  # [NTR] int64  (block-id range for this (t, r))
    tr_blk_end: np.ndarray  # [NTR] int64
    tr_bound: np.ndarray  # [NTR] int32  U[t, r]

    # Dense helpers.
    term_bound: np.ndarray  # [V] int32 — global U_t (WAND/MaxScore bounds)
    bounds_dense: np.ndarray  # [V, R] int32 — U[t, r], 0 where absent

    # Frozen base-build collection statistics + scoring params (DESIGN.md
    # §10): incremental extension scores appended postings against THESE,
    # never the extended collection's, so existing arrays stay bitwise
    # stable. None on indexes loaded from pre-§10 artifacts (which then
    # cannot be extended — rebuild from the corpus first).
    stats: CollectionStats | None = None
    bm25: BM25Params = dataclasses.field(default_factory=BM25Params)

    @property
    def n_ranges(self) -> int:
        return self.arrangement.n_ranges

    @property
    def n_blocks(self) -> int:
        return int(self.blk_start.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.docs.shape[0])

    @property
    def range_ends(self) -> np.ndarray:
        return self.arrangement.range_ends

    @property
    def range_starts(self) -> np.ndarray:
        return self.arrangement.range_starts

    @property
    def max_range_size(self) -> int:
        return int(self.arrangement.range_sizes.max())

    # ---------------------------------------------------------------- space
    def packed_postings(self) -> PackedPostings:
        """Bit-packed docid deltas for this index's block geometry (cached).

        Built indexes are never mutated in place (same contract the
        fingerprint cache relies on), so the packed mirror is computed once
        per index object and shared by every Engine upload / space report.
        """
        cached = self.__dict__.get("_packed_cache")
        if cached is None:
            cached = pack_docs(self.docs, self.blk_start, self.blk_len)
            self.__dict__["_packed_cache"] = cached
        return cached

    def device_bytes(
        self, impact_dtype: str = "int32", docs_format: str = "int32"
    ) -> dict[str, int]:
        """Actual HBM bytes per device array at the chosen impact dtype.

        Mirrors exactly what ``range_daat.Engine`` uploads as its
        ``DeviceIndex`` — one entry per device array (all int32 except
        ``impacts``, which is 1 B/posting under ``impact_dtype="int8"``,
        DESIGN.md §8) plus ``postings`` (docs + impacts) and ``total``
        aggregates; under ``docs_format="packed"`` the ``docs`` entry is
        the packed word stream + directory (DESIGN.md §12). Tests assert
        these equal the uploaded buffers' nbytes.
        """
        n_pack_words = (
            self.packed_postings().n_words if docs_format == "packed" else 0
        )
        return device_bytes_report(
            nnz=self.nnz,
            n_blocks=self.n_blocks,
            n_terms=self.n_terms,
            n_ranges=self.n_ranges,
            impact_dtype=impact_dtype,
            docs_format=docs_format,
            n_pack_words=n_pack_words,
        )

    def space_report(
        self, impact_dtype: str = "int32", docs_format: str = "int32"
    ) -> dict:
        """Logical space accounting in GiB at paper-matched widths (T2).

        docids at 4 B, impacts at ceil(bits/8) B, block metadata, the sparse
        (term, range) bound directory, listwise bounds, and the cluster map.
        The ``device_bytes`` section reports the *actual* HBM footprint of
        the device mirror at ``impact_dtype`` (see :meth:`device_bytes`).
        """
        gib = 1 / (1024**3)
        imp_bytes = (self.quantizer.bits + 7) // 8
        postings = self.nnz * (4 + imp_bytes)
        blocks = self.n_blocks * (8 + 4 + 4 + 4)  # start, len, maxdoc, maximp
        rangewise = self.tr_range.shape[0] * (4 + imp_bytes) + 8 * (
            self.n_terms + 1
        )
        listwise = self.n_terms * imp_bytes
        cluster_map = self.n_ranges * 8
        return {
            "postings_gib": postings * gib,
            "block_meta_gib": blocks * gib,
            "listwise_bounds_gib": listwise * gib,
            "rangewise_bounds_gib": rangewise * gib,
            "cluster_map_gib": cluster_map * gib,
            "total_gib": (postings + blocks + rangewise + listwise + cluster_map)
            * gib,
            "device_bytes": self.device_bytes(impact_dtype, docs_format),
        }

    # ------------------------------------------------------------- queries
    def query_block_table(
        self, q_terms: np.ndarray, pad_to: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-range padded block-id table for a query (host-side, cheap).

        Returns (blk_ids [R, B] int64 with -1 padding, rest_bound [R, B]
        int32) where ``rest_bound[r, j] = BoundSum(r) - U[t_j, r]`` for the
        term owning block j — the quantity needed for block-level pruning
        (DESIGN.md §2: per-block bound = blk_maximp + rest_bound).
        """
        q = [int(t) for t in q_terms if t >= 0]
        R = self.n_ranges
        per_range: list[list[int]] = [[] for _ in range(R)]
        rests: list[list[int]] = [[] for _ in range(R)]
        bsum = self.bounds_dense[q].sum(axis=0).astype(np.int64) if q else np.zeros(R, np.int64)
        for t in q:
            s, e = self.tr_ptr[t], self.tr_ptr[t + 1]
            for i in range(s, e):
                r = int(self.tr_range[i])
                rest = int(bsum[r] - self.tr_bound[i])
                for b in range(int(self.tr_blk_start[i]), int(self.tr_blk_end[i])):
                    per_range[r].append(b)
                    rests[r].append(rest)
        width = max((len(x) for x in per_range), default=1)
        width = max(width, 1)
        if pad_to is not None:
            width = max(width, pad_to)
        blk = np.full((R, width), -1, dtype=np.int64)
        rest = np.zeros((R, width), dtype=np.int32)
        for r in range(R):
            n = len(per_range[r])
            if n:
                blk[r, :n] = per_range[r]
                rest[r, :n] = rests[r]
        return blk, rest

    def fingerprint(self) -> str:
        # Cached: a sha1 pass over the postings arrays is the dominant cost
        # of chain materialization (each link checks its parent's print and
        # its own result), and built indexes are never mutated in place.
        cached = self.__dict__.get("_fingerprint_cache")
        if cached is None:
            h = hashlib.sha1()
            for a in (self.ptr, self.docs, self.impacts, self.range_ends):
                h.update(np.ascontiguousarray(a).tobytes())
            cached = h.hexdigest()[:16]
            self.__dict__["_fingerprint_cache"] = cached
        return cached


def _build_blocks(
    ptr: np.ndarray,
    docs: np.ndarray,
    n_terms: int,
    impacts: np.ndarray,
    range_ends: np.ndarray,
) -> tuple[np.ndarray, ...]:
    """Split every term's postings into <=BLOCK runs within range boundaries.

    Takes raw CSR arrays (not a ``Postings``) so incremental extension can
    run it over a delta's postings lifted to global docids (DESIGN.md §10).
    """
    starts: list[int] = []
    lens: list[int] = []
    maxdoc: list[int] = []
    maximp: list[int] = []
    bterm: list[int] = []
    brange: list[int] = []
    tr_rows: list[tuple[int, int, int, int, int]] = []  # term, range, b0, b1, bound

    for t in range(n_terms):
        s, e = int(ptr[t]), int(ptr[t + 1])
        if s == e:
            continue
        d = docs[s:e]
        # Range id per posting; postings are docid-sorted so ranges appear as runs.
        rid = np.searchsorted(range_ends, d, side="right")
        run_starts = np.concatenate([[0], np.nonzero(np.diff(rid))[0] + 1])
        run_ends = np.concatenate([run_starts[1:], [d.shape[0]]])
        for rs, re_ in zip(run_starts, run_ends):
            r = int(rid[rs])
            b0 = len(starts)
            bound = 0
            for off in range(rs, re_, BLOCK):
                hi = min(off + BLOCK, re_)
                starts.append(s + off)
                lens.append(hi - off)
                maxdoc.append(int(d[hi - 1]))
                mi = int(impacts[s + off : s + hi].max())
                maximp.append(mi)
                bound = max(bound, mi)
                bterm.append(t)
                brange.append(r)
            tr_rows.append((t, r, b0, len(starts), bound))

    return (
        np.asarray(starts, dtype=np.int64),
        np.asarray(lens, dtype=np.int32),
        np.asarray(maxdoc, dtype=np.int32),
        np.asarray(maximp, dtype=np.int32),
        np.asarray(bterm, dtype=np.int32),
        np.asarray(brange, dtype=np.int32),
        tr_rows,
    )


def build_index(
    corpus: Corpus,
    arrangement: Arrangement | None = None,
    n_ranges: int = 32,
    strategy: str = "clustered_bp",
    bits: int = 8,
    params: BM25Params = BM25Params(),
    seed: int = 0,
    quantizer: Quantizer | None = None,
    stats: CollectionStats | None = None,
) -> ClusteredIndex:
    """Build the cluster-skipping index.

    ``quantizer`` may be supplied to share one global impact scale across
    sub-indexes (required when merging scores across shards — §7.2).
    ``stats`` substitutes frozen collection statistics for the corpus's own
    — how the incremental-extension invariant is verified: a from-scratch
    build on the concatenated corpus at the base's stats/quantizer/
    arrangement equals the compacted chain bitwise (DESIGN.md §10).
    """
    if arrangement is None:
        arrangement = arrange(corpus, n_ranges=n_ranges, strategy=strategy, seed=seed)
    stats = stats or collection_stats(corpus)
    post = invert(corpus, arrangement.doc_order, params, stats=stats)
    quant = quantizer or fit_quantizer(post.scores, bits=bits)
    impacts = quant.quantize(post.scores)

    (
        blk_start,
        blk_len,
        blk_maxdoc,
        blk_maximp,
        blk_term,
        blk_range,
        tr_rows,
    ) = _build_blocks(
        post.ptr, post.docs, post.n_terms, impacts, arrangement.range_ends
    )

    V = corpus.n_terms
    R = arrangement.n_ranges
    tr_ptr = np.zeros(V + 1, dtype=np.int64)
    tr_term = np.asarray([r[0] for r in tr_rows], dtype=np.int32)
    counts = np.bincount(tr_term, minlength=V) if tr_rows else np.zeros(V, np.int64)
    tr_ptr[1:] = np.cumsum(counts)
    tr_range = np.asarray([r[1] for r in tr_rows], dtype=np.int32)
    tr_blk_start = np.asarray([r[2] for r in tr_rows], dtype=np.int64)
    tr_blk_end = np.asarray([r[3] for r in tr_rows], dtype=np.int64)
    tr_bound = np.asarray([r[4] for r in tr_rows], dtype=np.int32)

    bounds_dense = np.zeros((V, R), dtype=np.int32)
    if tr_rows:
        bounds_dense[tr_term, tr_range] = tr_bound
    term_bound = bounds_dense.max(axis=1) if R else np.zeros(V, np.int32)

    return ClusteredIndex(
        n_docs=corpus.n_docs,
        n_terms=V,
        arrangement=arrangement,
        quantizer=quant,
        ptr=post.ptr,
        docs=post.docs,
        impacts=impacts,
        blk_start=blk_start,
        blk_len=blk_len,
        blk_maxdoc=blk_maxdoc,
        blk_maximp=blk_maximp,
        blk_term=blk_term,
        blk_range=blk_range,
        tr_ptr=tr_ptr,
        tr_range=tr_range,
        tr_blk_start=tr_blk_start,
        tr_blk_end=tr_blk_end,
        tr_bound=tr_bound,
        term_bound=checked_int32(term_bound, "term bounds"),
        bounds_dense=bounds_dense,
        stats=stats,
        bm25=params,
    )


# --------------------------------------------------------------------------
# Incremental extension: delta planning and exact tail-append (DESIGN.md §10)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IndexDelta:
    """A tail-append against a parent ``ClusteredIndex``.

    Everything is *delta-local*: ``docs`` are new docids in [0, n_docs),
    ``doc_order``/``range_ends`` describe the delta's own arrangement, and
    the global picture only materializes in :func:`apply_delta` (delta docs
    land at the parent's docid tail, delta ranges after the parent's).
    Impacts are already quantized at the parent's shared scale, scored
    against the parent's *frozen* collection statistics, so applying the
    delta never touches a parent array value. ``parent_fingerprint`` pins
    the exact index this delta was planned against.
    """

    n_docs: int
    n_terms: int
    parent_fingerprint: str
    ptr: np.ndarray  # [V+1] int64 — delta postings CSR by term
    docs: np.ndarray  # [nnz_d] int32 delta-local new docids, ascending per term
    impacts: np.ndarray  # [nnz_d] int32 at the parent's quantizer scale
    doc_order: np.ndarray  # [n_docs] int64 delta-local permutation
    range_ends: np.ndarray  # [R_d] int64 delta-local, last == n_docs

    @property
    def nnz(self) -> int:
        return int(self.docs.shape[0])

    @property
    def n_ranges(self) -> int:
        return int(self.range_ends.shape[0])


def extended_arrangement(
    base: Arrangement, doc_order: np.ndarray, range_ends: np.ndarray
) -> Arrangement:
    """Append a delta-local arrangement at the docid tail of ``base``.

    The single definition both sides of the §10 invariant use: the applied
    delta *and* the verifying from-scratch build share this arrangement.
    """
    n = int(base.range_ends[-1])
    return Arrangement(
        doc_order=np.concatenate(
            [base.doc_order, np.asarray(doc_order, np.int64) + n]
        ),
        range_ends=np.concatenate(
            [base.range_ends, np.asarray(range_ends, np.int64) + n]
        ),
        strategy=base.strategy,
    )


def plan_delta(
    index: ClusteredIndex,
    corpus_delta: Corpus,
    n_ranges: int = 1,
    strategy: str = "clustered",
    seed: int = 0,
    arrangement: Arrangement | None = None,
) -> IndexDelta:
    """Score and arrange a delta corpus against a built index.

    The delta gets its own (small) arrangement — clustering/BP run only on
    the appended documents — and its postings are scored with the parent's
    frozen stats and quantizer, which is what makes the append exact: no
    existing impact, bound, or block can change.
    """
    if corpus_delta.n_terms != index.n_terms:
        raise ValueError(
            f"delta corpus has {corpus_delta.n_terms} terms, index has "
            f"{index.n_terms} — extension shares one vocabulary"
        )
    if corpus_delta.n_docs <= 0:
        raise ValueError("delta corpus is empty")
    if index.stats is None:
        raise ValueError(
            "index carries no frozen collection stats (loaded from a "
            "pre-incremental artifact?) — rebuild from the corpus to extend"
        )
    if arrangement is None:
        arrangement = arrange(
            corpus_delta, n_ranges=n_ranges, strategy=strategy, seed=seed
        )
    post = invert(corpus_delta, arrangement.doc_order, index.bm25, stats=index.stats)
    return IndexDelta(
        n_docs=int(corpus_delta.n_docs),
        n_terms=int(index.n_terms),
        parent_fingerprint=index.fingerprint(),
        ptr=post.ptr,
        docs=post.docs,
        impacts=index.quantizer.quantize(post.scores),
        doc_order=np.asarray(arrangement.doc_order, np.int64),
        range_ends=np.asarray(arrangement.range_ends, np.int64),
    )


def apply_delta(index: ClusteredIndex, delta: IndexDelta) -> ClusteredIndex:
    """Materialize ``index`` + ``delta`` into one extended ``ClusteredIndex``.

    Bitwise-exact merge: the result is array-for-array identical to
    ``build_index`` on the concatenated corpus at the extended arrangement
    with the parent's quantizer and frozen stats (pinned by tier-1 tests).
    Postings stay CSR-by-term — each term's delta postings (all at larger
    docids) slot in behind its base postings — and blocks/(term, range)
    rows re-interleave per term without recomputing any base value.
    """
    if delta.parent_fingerprint != index.fingerprint():
        raise ValueError(
            f"delta was planned against index {delta.parent_fingerprint}, "
            f"this index has fingerprint {index.fingerprint()}"
        )
    if delta.n_terms != index.n_terms:
        raise ValueError(
            f"delta vocabulary {delta.n_terms} != index {index.n_terms}"
        )
    V = index.n_terms
    base_n = index.n_docs
    R_base = index.n_ranges
    arrangement = extended_arrangement(
        index.arrangement, delta.doc_order, delta.range_ends
    )

    # Postings: per-term concat (base run, then delta run at larger docids).
    base_counts = np.diff(index.ptr)
    d_counts = np.diff(delta.ptr)
    new_ptr = index.ptr + delta.ptr
    docs = np.empty(index.nnz + delta.nnz, np.int32)
    impacts = np.empty(index.nnz + delta.nnz, np.int32)
    dest_base = np.arange(index.nnz, dtype=np.int64) + np.repeat(
        delta.ptr[:-1], base_counts
    )
    dest_delta = np.arange(delta.nnz, dtype=np.int64) + np.repeat(
        index.ptr[1:], d_counts
    )
    docs[dest_base] = index.docs
    docs[dest_delta] = delta.docs.astype(np.int64) + base_n
    impacts[dest_base] = index.impacts
    impacts[dest_delta] = delta.impacts

    # Delta blocks at global coordinates (docids lifted to the tail; the
    # extended range_ends sends them straight to global range ids >= R_base).
    (
        d_start,
        d_len,
        d_maxdoc,
        d_maximp,
        d_term,
        d_range,
        d_tr_rows,
    ) = _build_blocks(
        delta.ptr,
        delta.docs.astype(np.int64) + base_n,
        V,
        delta.impacts,
        arrangement.range_ends,
    )
    # Block starts move: base blocks shift by their term's delta postings
    # prefix; delta blocks land after their term's base postings.
    b_start_g = index.blk_start + delta.ptr[:-1][index.blk_term]
    d_start_g = d_start + index.ptr[1:][d_term] if d_term.size else d_start

    # Fresh-build block order is (term, docid run): sort the union by
    # (term, new start) — within a term every base block starts before
    # every delta block, so runs stay contiguous.
    all_start = np.concatenate([b_start_g, d_start_g])
    all_term = np.concatenate([index.blk_term, d_term])
    order = np.lexsort((all_start, all_term))
    newpos = np.empty(order.shape[0], np.int64)
    newpos[order] = np.arange(order.shape[0])

    # (term, range) directory: same per-term interleave, with block-id
    # windows remapped through the merged block order.
    d_tr_term = np.asarray([r[0] for r in d_tr_rows], np.int32)
    d_tr_range = np.asarray([r[1] for r in d_tr_rows], np.int32)
    d_tr_b0 = np.asarray([r[2] for r in d_tr_rows], np.int64)
    d_tr_b1 = np.asarray([r[3] for r in d_tr_rows], np.int64)
    d_tr_bound = np.asarray([r[4] for r in d_tr_rows], np.int32)
    d_tr_counts = (
        np.bincount(d_tr_term, minlength=V) if d_tr_rows else np.zeros(V, np.int64)
    )
    d_tr_ptr = np.zeros(V + 1, dtype=np.int64)
    d_tr_ptr[1:] = np.cumsum(d_tr_counts)

    NB_base = index.n_blocks
    NTR_b = int(index.tr_range.shape[0])
    NTR_d = int(d_tr_term.shape[0])
    base_tr_counts = np.diff(index.tr_ptr)
    dest_tr_b = np.arange(NTR_b, dtype=np.int64) + np.repeat(
        d_tr_ptr[:-1], base_tr_counts
    )
    dest_tr_d = np.arange(NTR_d, dtype=np.int64) + np.repeat(
        index.tr_ptr[1:], d_tr_counts
    )

    def interleave(base_vals, d_vals, dtype):
        out = np.empty(NTR_b + NTR_d, dtype)
        out[dest_tr_b] = base_vals
        out[dest_tr_d] = d_vals
        return out

    tr_blk_start = interleave(
        newpos[index.tr_blk_start],
        newpos[NB_base + d_tr_b0] if NTR_d else d_tr_b0,
        np.int64,
    )
    tr_blk_end = interleave(
        newpos[index.tr_blk_end - 1] + 1,
        newpos[NB_base + d_tr_b1 - 1] + 1 if NTR_d else d_tr_b1,
        np.int64,
    )

    # Refreshed BoundSum tail: new columns for the delta's ranges only.
    R_d = delta.n_ranges
    d_bounds = np.zeros((V, R_d), dtype=np.int32)
    if d_tr_rows:
        d_bounds[d_tr_term, d_tr_range - R_base] = d_tr_bound
    bounds_dense = np.hstack([np.asarray(index.bounds_dense), d_bounds])
    term_bound = checked_int32(
        np.maximum(np.asarray(index.term_bound), d_bounds.max(axis=1)),
        "term bounds",
    )

    return ClusteredIndex(
        n_docs=base_n + delta.n_docs,
        n_terms=V,
        arrangement=arrangement,
        quantizer=index.quantizer,
        ptr=new_ptr,
        docs=docs,
        impacts=impacts,
        blk_start=all_start[order],
        blk_len=np.concatenate([index.blk_len, d_len])[order],
        blk_maxdoc=np.concatenate([index.blk_maxdoc, d_maxdoc])[order],
        blk_maximp=np.concatenate([index.blk_maximp, d_maximp])[order],
        blk_term=all_term[order],
        blk_range=np.concatenate([index.blk_range, d_range])[order],
        tr_ptr=index.tr_ptr + d_tr_ptr,
        tr_range=interleave(index.tr_range, d_tr_range, np.int32),
        tr_blk_start=tr_blk_start,
        tr_blk_end=tr_blk_end,
        tr_bound=interleave(index.tr_bound, d_tr_bound, np.int32),
        term_bound=term_bound,
        bounds_dense=bounds_dense,
        stats=index.stats,
        bm25=index.bm25,
    )


def extend_index(
    index: ClusteredIndex,
    corpus_delta: Corpus,
    n_ranges: int = 1,
    strategy: str = "clustered",
    seed: int = 0,
    arrangement: Arrangement | None = None,
) -> ClusteredIndex:
    """Append a delta corpus at the docid tail of a built index.

    The cheap-update property the document-ordered layout buys (paper §1):
    only the delta is clustered, inverted, scored, and blocked; base arrays
    are re-interleaved, never recomputed. Equivalent to
    ``apply_delta(index, plan_delta(index, corpus_delta, ...))``.
    """
    return apply_delta(
        index,
        plan_delta(
            index,
            corpus_delta,
            n_ranges=n_ranges,
            strategy=strategy,
            seed=seed,
            arrangement=arrangement,
        ),
    )


# Arrays that make up a built index, under the reference artifact's names
# (the arrangement's two arrays flattened in).
INDEX_ARRAYS = (
    "ptr", "docs", "impacts",
    "blk_start", "blk_len", "blk_maxdoc", "blk_maximp", "blk_term", "blk_range",
    "tr_ptr", "tr_range", "tr_blk_start", "tr_blk_end", "tr_bound",
    "term_bound", "bounds_dense",
    "doc_order", "range_ends",
)


def index_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    n_docs: int,
    n_terms: int,
    strategy: str,
    quant_bits: int,
    quant_scale: float,
) -> ClusteredIndex:
    """Rebuild a ``ClusteredIndex`` from its arrays (``INDEX_ARRAYS`` names).

    How an index built elsewhere (another process, a saved artifact's
    arrays) crosses into the port without a rebuild. The arrays are taken
    as they are, so ``fingerprint()`` equals the source index's. Frozen
    collection statistics are not carried: the result serves queries but
    cannot be extended incrementally.
    """
    missing = [n for n in INDEX_ARRAYS if n not in arrays]
    if missing:
        raise ValueError(f"index arrays missing: {missing}")
    a = {n: np.asarray(arrays[n]) for n in INDEX_ARRAYS}
    return ClusteredIndex(
        n_docs=int(n_docs),
        n_terms=int(n_terms),
        arrangement=Arrangement(
            doc_order=a.pop("doc_order"),
            range_ends=a.pop("range_ends"),
            strategy=strategy,
        ),
        quantizer=Quantizer(bits=int(quant_bits), scale=float(quant_scale)),
        **a,
    )


# ------------------------------------------------------------------ sharding
#
# The reference's range sharding (its ``core/clustered_index.py``), copied:
# numpy only, so a shard list built here equals the reference's array for
# array.


@dataclasses.dataclass
class IndexShard:
    """A contiguous band of ranges carved out of a ``ClusteredIndex``.

    Everything is remapped to shard-local coordinates (DESIGN.md §4):
    ``docs`` holds local docids (global - ``doc_base``), ``blk_start``
    offsets into the shard-local postings array, ``range_starts`` /
    ``bounds_dense`` cover only this shard's ranges, and ``blk_map`` sends
    global block ids to shard-local ones (-1 for blocks owned elsewhere) so
    a globally-planned ``QueryPlan`` can be sliced per shard without
    replanning.
    """

    shard_id: int
    range_lo: int  # global range-id window [range_lo, range_hi)
    range_hi: int
    doc_base: int  # global docid of local doc 0
    n_docs: int
    postings: int  # postings mass carried by this shard

    docs: np.ndarray  # [nnz_s] int32 LOCAL docids
    impacts: np.ndarray  # [nnz_s] int32
    blk_start: np.ndarray  # [NB_s] int64 offsets into the LOCAL postings
    blk_len: np.ndarray  # [NB_s] int32
    blk_maxdoc: np.ndarray  # [NB_s] int32 LOCAL docids
    blk_maximp: np.ndarray  # [NB_s] int32
    blk_map: np.ndarray  # [NB_global] int32 global block id -> local (-1)

    range_starts: np.ndarray  # [R_s] int32 LOCAL docid space
    range_sizes: np.ndarray  # [R_s] int32
    bounds_dense: np.ndarray  # [V, R_s] int32 — U[t, r] for local ranges

    @property
    def n_ranges(self) -> int:
        return self.range_hi - self.range_lo


def balance_range_shards(mass: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous range partition balancing postings mass.

    Returns ``cuts`` [n_shards + 1] with shard s owning ranges
    ``[cuts[s], cuts[s+1])``. Greedy prefix-sum cuts: each boundary lands on
    whichever side of the ideal s/n_shards mass quantile is closer, subject
    to every shard keeping at least one range. The range structure is the
    unit of partitioning — a topically-coherent shard boundary, unlike the
    random document split of the classic partitioned deployment (§7.2).
    """
    mass = np.asarray(mass, dtype=np.int64)
    R = int(mass.shape[0])
    if not 1 <= n_shards <= R:
        raise ValueError(f"need 1 <= n_shards={n_shards} <= n_ranges={R}")
    cum = np.cumsum(mass)
    total = int(cum[-1])
    cuts = [0]
    for s in range(1, n_shards):
        target = total * s / n_shards
        j = int(np.searchsorted(cum, target))  # first prefix >= target
        # Nearest cut: left mass is cum[j-1] cutting before range j,
        # cum[j] cutting after it — take whichever lands closer to target.
        left = int(cum[j - 1]) if j > 0 else 0
        if j < R and abs(int(cum[j]) - target) < abs(left - target):
            j += 1
        j = max(j, cuts[-1] + 1)  # every shard keeps >= 1 range
        j = min(j, R - (n_shards - s))
        cuts.append(j)
    cuts.append(R)
    return np.asarray(cuts, dtype=np.int64)


def range_postings_mass(index: ClusteredIndex) -> np.ndarray:
    """[R] int64 postings mass per global range (the partitioning weight)."""
    return np.bincount(
        index.blk_range, weights=index.blk_len, minlength=index.n_ranges
    ).astype(np.int64)


def _validate_cuts(cuts: np.ndarray, n_ranges: int) -> np.ndarray:
    cuts = np.asarray(cuts, dtype=np.int64)
    if (
        cuts.ndim != 1
        or cuts.shape[0] < 2
        or cuts[0] != 0
        or cuts[-1] != n_ranges
        or np.any(np.diff(cuts) < 1)
    ):
        raise ValueError(
            f"cuts {cuts.tolist()} must rise strictly from 0 to "
            f"n_ranges={n_ranges} (every shard keeps >= 1 range)"
        )
    return cuts


def shard_cuts(shards: list["IndexShard"]) -> np.ndarray:
    """[S + 1] int64 global range cuts recovered from a shard list."""
    return np.asarray(
        [sh.range_lo for sh in shards] + [shards[-1].range_hi], np.int64
    )


def shard_device_index(
    index: ClusteredIndex,
    n_shards: int | None = None,
    cuts: np.ndarray | None = None,
) -> list[IndexShard]:
    """Partition a built index along range boundaries into device shards.

    Ranges stay whole (blocks never straddle a range boundary, so a range
    boundary is also a block and postings boundary); contiguous bands of
    ranges are assigned to shards by :func:`balance_range_shards` so every
    shard carries a near-equal share of postings — or by explicit ``cuts``
    ([S + 1], rising from 0 to n_ranges), which is how the control plane's
    reshard planner places load-rebalanced boundaries (DESIGN.md §9). Each
    shard's arrays are rewritten to local coordinates — see
    :class:`IndexShard`. Scores need no recalibration across shards: the
    quantizer is global, so per-shard integer top-k lists merge exactly
    (DESIGN.md §4).
    """
    R = index.n_ranges
    mass = range_postings_mass(index)
    if cuts is None:
        if n_shards is None:
            raise ValueError("need n_shards or explicit cuts")
        cuts = balance_range_shards(mass, n_shards)
    else:
        cuts = _validate_cuts(cuts, R)
        if n_shards is not None and n_shards != cuts.shape[0] - 1:
            raise ValueError(
                f"n_shards={n_shards} != len(cuts)-1={cuts.shape[0] - 1}"
            )
        n_shards = cuts.shape[0] - 1

    NB = index.n_blocks
    range_starts = index.range_starts
    range_sizes = index.arrangement.range_sizes
    shards: list[IndexShard] = []
    for s in range(n_shards):
        lo, hi = int(cuts[s]), int(cuts[s + 1])
        doc_base = int(range_starts[lo])
        sel = (index.blk_range >= lo) & (index.blk_range < hi)
        gids = np.nonzero(sel)[0]
        lens = index.blk_len[gids].astype(np.int64)
        starts = index.blk_start[gids]
        local_start = np.zeros(gids.shape[0], dtype=np.int64)
        if gids.size:
            local_start[1:] = np.cumsum(lens)[:-1]
            tot = int(lens.sum())
            take = np.repeat(starts - local_start, lens) + np.arange(tot)
        else:
            take = np.empty(0, dtype=np.int64)

        blk_map = np.full(NB, -1, dtype=np.int32)
        blk_map[gids] = np.arange(gids.shape[0], dtype=np.int32)

        n_docs = int(
            (range_starts[hi] if hi < R else index.n_docs) - doc_base
        )
        shards.append(
            IndexShard(
                shard_id=s,
                range_lo=lo,
                range_hi=hi,
                doc_base=doc_base,
                n_docs=n_docs,
                postings=int(mass[lo:hi].sum()),
                docs=checked_int32(index.docs[take] - doc_base, "shard docids"),
                impacts=index.impacts[take].astype(np.int32),
                blk_start=local_start,
                blk_len=index.blk_len[gids].astype(np.int32),
                blk_maxdoc=checked_int32(
                    index.blk_maxdoc[gids] - doc_base, "shard block maxdocs"
                ),
                blk_maximp=index.blk_maximp[gids].astype(np.int32),
                blk_map=blk_map,
                range_starts=(range_starts[lo:hi] - doc_base).astype(np.int32),
                range_sizes=range_sizes[lo:hi].astype(np.int32),
                bounds_dense=index.bounds_dense[:, lo:hi],
            )
        )
    return shards


def build_index_cached(
    corpus: Corpus,
    cache_dir: str = ".cache",
    **kwargs,
) -> ClusteredIndex:
    """Disk-cached index build (BP + k-means are the slow offline steps).

    Cached as a versioned ``repro_torch.index_io`` artifact directory
    (DESIGN.md §8) under the reference's sha1 cache key, so the two
    packages share cache entries: a corrupt entry raises, while an entry
    from an older format version is treated as a miss and rebuilt.
    """
    from repro_torch import index_io  # local: index_io sits above core

    key = hashlib.sha1(
        (corpus.fingerprint() + repr(sorted(kwargs.items()))).encode()
    ).hexdigest()[:16]
    path = os.path.join(cache_dir, f"index_{key}")
    if os.path.isdir(path):
        try:
            return index_io.load_index(path)
        except index_io.VersionMismatchError:
            pass  # older format — self-heal: rebuild and overwrite below
    idx = build_index(corpus, **kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    index_io.save_index(
        idx,
        path,
        build_params={k: repr(v) for k, v in sorted(kwargs.items())},
        overwrite=True,
    )
    return idx
