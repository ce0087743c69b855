"""Plain PyTorch versions of the range scorer (the port's oracle).

Scores one document range: gathers the postings of the query's surviving
blocks and scatter-adds quantized impacts into a range-local int32
accumulator. Every function mirrors its namesake in the JAX package's
``kernels/range_scorer/ref.py`` bitwise; the CUDA kernels in ``kernel.py``
must match :func:`scatter_accumulate_ref`, :func:`unpack_locals_ref` and
:func:`range_step_ref` exactly. :func:`range_step_ref` is one whole range
step of the engine (the reference's ``core/range_daat.py::score_range_step``):
block pruning, the scorer, the range top-k and the merge into the running
top-k state. :func:`traverse_ref` is the plain version of the ``traverse``
kernel: the reference's whole-query loop (``_traverse_loop``) run on each of
N lanes from a carry. The CPU tests run these functions, and
``chip_smoke.py`` holds the kernels against them on the card.

The running state is one int32 buffer laid out ``vals[k] | postings |
blocks | ids[k]``, and :class:`TopKState`'s fields are views of it: θ and
the postings counter sit side by side, so the host reads both in one copy
(:func:`theta_postings`). The ``range_step`` kernel writes the same layout.
A traversal's carry appends three fields to it, ``i | exit_safe |
exit_budget`` (the cursor and the two exit flags, 0 or 1), one row of
``carry_width(k) = 2k + 5`` int32 per lane.

The packed word stream is held as int32 carrying the uint32 bit pattern:
PyTorch has no right shift for ``uint32`` on the CPU, so the decode widens
each word to int64 and masks it back to 32 bits before shifting.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.clustered_index import BLOCK, PACK_DIR_BITS, PACK_WIDTHS

# Zero-point for native int8 impact storage: quantized impacts live in
# [1, 2^b - 1] ⊆ [1, 255] for b <= 8, which overflows signed int8, so the
# stored code is ``impact - IMPACT_BIAS`` ∈ [-127, 127] and the gather
# widens with ``+ IMPACT_BIAS`` back into exact int32.
IMPACT_BIAS = 128

DOCS_FORMATS = ("int32", "packed")
INT32_MAX = 2**31 - 1
_WORD_MASK = 0xFFFFFFFF
# Low half of a packed (score, position) selection key: ranking by
# ``LOW - position`` puts the smaller position first among equal scores.
_LOW = 2**32 - 1

__all__ = [
    "BLOCK",
    "DOCS_FORMATS",
    "IMPACT_BIAS",
    "TopKState",
    "carry_width",
    "gather_block_impacts",
    "gather_block_postings",
    "gather_block_postings_packed",
    "init_state",
    "merge_topk",
    "range_step_ref",
    "range_topk",
    "scatter_accumulate_ref",
    "score_blocks_packed_ref",
    "score_blocks_ref",
    "shard_row",
    "state_views",
    "theta",
    "theta_postings",
    "traverse_ref",
    "unpack_dir",
    "unpack_locals_ref",
]


class TopKState(NamedTuple):
    vals: torch.Tensor  # [k] int32, sorted descending (0 = empty slot)
    ids: torch.Tensor  # [k] int32 (-1 = empty)
    postings: torch.Tensor  # 0-d int32 — postings scored so far
    blocks: torch.Tensor  # 0-d int32 — blocks processed so far


def carry_width(k: int) -> int:
    """Int32 slots of one lane's carry: the state, then i | exit_safe | exit_budget."""
    return 2 * k + 5


def state_views(buf: torch.Tensor, k: int) -> TopKState:
    """The state over one int32 buffer ``vals[k] | postings | blocks | ids[k]``."""
    return TopKState(vals=buf[:k], ids=buf[k + 2:], postings=buf[k], blocks=buf[k + 1])


def init_state(k: int, device="cpu") -> TopKState:
    """An empty heap: k slots (0, -1), counters 0; one upload to ``device``."""
    buf = torch.zeros(2 * k + 2, dtype=torch.int32)
    buf[k + 2:] = -1
    return state_views(buf.to(device), k)


def theta(state: TopKState) -> torch.Tensor:
    """Heap-entry threshold: k-th largest score so far (0 while unfilled)."""
    return state.vals[-1]


def theta_postings(state: TopKState) -> list[int]:
    """[θ, postings] on the host: one device->host copy for a laid-out state.

    A state whose fields are views of one buffer (``state_views``) has θ and
    the postings counter adjacent, so one two-element view is read; any
    other state is stacked first.
    """
    vals, post = state.vals, state.postings
    k = vals.shape[0]
    if (post.data_ptr() == vals.data_ptr() + 4 * k
            and post.untyped_storage().data_ptr() == vals.untyped_storage().data_ptr()):
        return vals.as_strided((2,), (1,), vals.storage_offset() + k - 1).tolist()
    return torch.stack((vals[-1], post)).tolist()


def _lanes(device: torch.device) -> torch.Tensor:
    return torch.arange(BLOCK, dtype=torch.int32, device=device)


def _lane_valid(
    starts: torch.Tensor, lens: torch.Tensor, keep: torch.Tensor
) -> torch.Tensor:
    """[B, BLOCK] lane validity shared by both docid formats."""
    lane = _lanes(starts.device)
    return (lane[None, :] < lens[:, None]) & keep[:, None] & (starts >= 0)[:, None]


def gather_block_impacts(
    post_imps: torch.Tensor,  # [nnz] int32 or biased int8 impacts
    starts: torch.Tensor,  # [B] block start offsets (-1 pad ok)
) -> torch.Tensor:
    """Gather [B, BLOCK] widened impact values by posting offset.

    Impacts stay offset-addressed in every docs format — packed blocks
    replace only the docid stream, so ``blk_start`` still indexes impacts.
    """
    offs = starts.to(torch.int32)[:, None] + _lanes(starts.device)[None, :]
    nnz = post_imps.shape[0]
    v = post_imps[offs.clamp(0, nnz - 1)]
    if post_imps.dtype == torch.int8:
        # Native int8 storage: the widen is the only place the true impact
        # is rebuilt, so postings stay 1 B each in device memory.
        v = v.to(torch.int32) + IMPACT_BIAS
    return v


def gather_block_postings(
    post_docs: torch.Tensor,  # [nnz] int32 docids (new ids)
    post_imps: torch.Tensor,  # [nnz] int32 impacts (or biased int8)
    starts: torch.Tensor,  # [B] block start offsets (-1 pad ok)
    lens: torch.Tensor,  # [B] int32 block lengths
    keep: torch.Tensor,  # [B] bool survives pruning
    range_start,  # scalar int32 first new-docid of the range
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather block postings into dense [B*BLOCK] (local_id, value) pairs.

    Invalid lanes get local_id = -1 and value = 0 so any downstream
    accumulator drops them.
    """
    B = starts.shape[0]
    offs = starts.to(torch.int32)[:, None] + _lanes(starts.device)[None, :]
    valid = _lane_valid(starts, lens, keep)
    nnz = post_docs.shape[0]
    d = post_docs[offs.clamp(0, nnz - 1)]
    v = gather_block_impacts(post_imps, starts)
    local = torch.where(valid, d - range_start, -1).to(torch.int32)
    vals = torch.where(valid, v, 0).to(torch.int32)
    return local.reshape(B * BLOCK), vals.reshape(B * BLOCK)


def unpack_dir(pack_dir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split merged directory entries into (word_start, width) columns.

    Entries come from ``core.clustered_index.pack_dir_entries``: the word
    offset in the low ``PACK_DIR_BITS`` bits, the ``PACK_WIDTHS`` code
    above it. Entries are non-negative, so the arithmetic shift is exact.
    """
    entry = pack_dir.to(torch.int32)
    ws = entry & ((1 << PACK_DIR_BITS) - 1)
    table = torch.tensor(PACK_WIDTHS, dtype=torch.int32, device=pack_dir.device)
    return ws, table[entry >> PACK_DIR_BITS]


def unpack_locals_ref(
    pack_words: torch.Tensor,  # [n_words] int32 holding the uint32 stream
    starts: torch.Tensor,  # [B] block start offsets (-1 pad ok; validity only)
    lens: torch.Tensor,  # [B] int32 block lengths
    pack_dir: torch.Tensor,  # [B] int32 merged (word_start | width code)
    pack_firsts: torch.Tensor,  # [B] int32 absolute first docid per block
    keep: torch.Tensor,  # [B] bool survives pruning
    range_start,  # scalar int32 first new-docid of the range
) -> torch.Tensor:
    """Decode packed blocks to [B*BLOCK] range-local ids (-1 invalid).

    The plain version of the ``unpack_locals`` kernel. Lane ``j`` of a
    width-``w`` block reads bits ``[j*w, (j+1)*w)`` of its word run
    (``delta_0 = 0`` is stored, so the layout is uniform), and an inclusive
    prefix sum from the out-of-band first docid rebuilds absolute ids.
    Deltas of lanes past ``lens`` are zeroed *before* the cumsum so tail
    garbage can never leak into valid lanes.
    """
    B = starts.shape[0]
    lane = _lanes(starts.device)
    valid = _lane_valid(starts, lens, keep)
    pack_starts, widths = unpack_dir(pack_dir)
    w = widths[:, None].to(torch.int64)  # [B, 1]
    bit = lane[None, :].to(torch.int64) * w  # [B, BLOCK]
    widx = pack_starts[:, None] + bit // 32
    words = pack_words.to(torch.int64) & _WORD_MASK
    if words.numel() == 0:
        # Every block has width 0: no lane reads a word.
        words = torch.zeros(1, dtype=torch.int64, device=pack_words.device)
    word = words[widx.clamp(0, words.numel() - 1)]
    mask = (torch.ones_like(w) << w) - 1  # exact for w == 32 in int64
    delta = (word >> (bit % 32)) & mask
    in_len = lane[None, :] < lens[:, None]
    delta = torch.where(in_len, delta, 0).to(torch.int32)
    d = pack_firsts.to(torch.int32)[:, None] + torch.cumsum(delta, 1, dtype=torch.int32)
    local = torch.where(valid, d - range_start, -1).to(torch.int32)
    return local.reshape(B * BLOCK)


def gather_block_postings_packed(
    pack_words: torch.Tensor,  # [n_words] int32 holding the uint32 stream
    post_imps: torch.Tensor,  # [nnz] int32 or biased int8 impacts
    starts: torch.Tensor,  # [B] block start offsets into impacts (-1 pad ok)
    lens: torch.Tensor,  # [B] int32 block lengths
    pack_dir: torch.Tensor,  # [B] int32 merged (word_start | width code)
    pack_firsts: torch.Tensor,  # [B] int32 absolute first docid per block
    keep: torch.Tensor,  # [B] bool survives pruning
    range_start,  # scalar int32 first new-docid of the range
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-format twin of :func:`gather_block_postings` — the oracle.

    Returns the identical (local_id, value) contract, bitwise.
    """
    local = unpack_locals_ref(
        pack_words, starts, lens, pack_dir, pack_firsts, keep, range_start
    )
    valid = _lane_valid(starts, lens, keep)
    v = gather_block_impacts(post_imps, starts)
    vals = torch.where(valid, v, 0).to(torch.int32)
    return local, vals.reshape(local.shape)


def scatter_accumulate_ref(
    ids: torch.Tensor, vals: torch.Tensor, s_pad: int
) -> torch.Tensor:
    """acc[s] = sum of vals at ids == s, for s in [0, s_pad). Returns int32.

    The plain version of the ``scatter_accumulate`` kernel: ids below 0 or
    at/after ``s_pad`` are dropped through one spill slot past the end.
    """
    drop = (ids < 0) | (ids >= s_pad)
    tgt = torch.where(drop, s_pad, ids).to(torch.int64)
    acc = torch.zeros(s_pad + 1, dtype=torch.int32, device=ids.device)
    acc.scatter_add_(0, tgt, vals.to(torch.int32))
    return acc[:s_pad]


def score_blocks_ref(
    post_docs: torch.Tensor,
    post_imps: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    keep: torch.Tensor,
    range_start,
    s_pad: int,
) -> torch.Tensor:
    """Accumulate surviving blocks into an int32 accumulator of size s_pad."""
    local, vals = gather_block_postings(
        post_docs, post_imps, starts, lens, keep, range_start
    )
    return scatter_accumulate_ref(local, vals, s_pad)


def score_blocks_packed_ref(
    pack_words: torch.Tensor,
    post_imps: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    pack_dir: torch.Tensor,
    pack_firsts: torch.Tensor,
    keep: torch.Tensor,
    range_start,
    s_pad: int,
) -> torch.Tensor:
    """Packed-format twin of :func:`score_blocks_ref` (same accumulator)."""
    local, vals = gather_block_postings_packed(
        pack_words, post_imps, starts, lens,
        pack_dir, pack_firsts, keep, range_start,
    )
    return scatter_accumulate_ref(local, vals, s_pad)


def _topk_positions(vals: torch.Tensor, tie: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k best entries under (vals desc, tie asc).

    ``vals`` and ``tie`` are non-negative and below 2^31, so one int64 key
    ``vals * 2^32 + (2^32 - 1 - tie)`` orders them exactly; ``torch.topk``
    alone breaks ties in no fixed order.
    """
    key = (vals.to(torch.int64) << 32) | (_LOW - tie.to(torch.int64))
    return torch.topk(key, k).indices


def merge_topk(
    vals: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of flat (vals, ids) candidates under the heap's total order.

    Score descending, docid ascending, empty slots (id < 0) last — the
    reference's ``lexsort((i_key, -vals))``. Scores are sums of positive
    impacts, so never negative. Empty slots are all (0, -1), so which of
    them is picked does not show.
    """
    i_key = torch.where(ids >= 0, ids, INT32_MAX)
    sel = _topk_positions(vals, i_key, k)
    return vals[sel], ids[sel]


def range_topk(acc: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, local ids) of the k best accumulator slots.

    ``jax.lax.top_k`` returns the lowest index among equal values; the
    (score desc, local id asc) key reproduces that.
    """
    pos = torch.arange(acc.shape[0], dtype=torch.int64, device=acc.device)
    loc = _topk_positions(acc, pos, k)
    return acc[loc], loc.to(torch.int32)


def range_step_ref(
    dix,
    state: TopKState,
    blk_ids: torch.Tensor,  # [B] int32, -1 padded
    rest: torch.Tensor,  # [B] int32 — bound sum of *other* terms for pruning
    range_start: torch.Tensor,  # 0-d int32
    *,
    s_pad: int,
    k: int,
    prune_blocks: bool = True,
    docs_format: str = "int32",
) -> TopKState:
    """Score one range and merge its top-k into the running state.

    The plain version of the ``range_step`` kernel. ``dix`` is the engine's
    ``core.range_daat.DeviceIndex``; the result lies in a fresh buffer, so
    ``state`` stays valid.
    """
    th = theta(state)
    safe_ids = blk_ids.clamp(min=0)
    starts = dix.blk_start[safe_ids]
    lens = dix.blk_len[safe_ids]
    maximp = dix.blk_maximp[safe_ids]
    keep = blk_ids >= 0
    if prune_blocks:
        # Block-level refinement (paper "Improved Pruning With Local Range
        # Bounds"): a block survives only if its own max impact plus the
        # other terms' bounds can beat the current threshold.
        keep = keep & (maximp + rest > th)
    if docs_format == "packed":
        acc = score_blocks_packed_ref(
            dix.pack_words, dix.impacts, starts, lens, dix.pack_dir[safe_ids],
            dix.pack_first[safe_ids], keep, range_start, s_pad,
        )
    elif docs_format == "int32":
        acc = score_blocks_ref(dix.docs, dix.impacts, starts, lens, keep, range_start,
                               s_pad)
    else:
        raise ValueError(f"docs_format {docs_format!r} not in {DOCS_FORMATS}")

    vals, loc = range_topk(acc, k)
    cand_ids = torch.where(vals > 0, loc + range_start, -1).to(torch.int32)
    nv, ni = merge_topk(torch.cat([state.vals, vals]), torch.cat([state.ids, cand_ids]), k)
    postings = state.postings + torch.where(keep, lens, 0).sum(dtype=torch.int32)
    blocks = state.blocks + keep.sum(dtype=torch.int32)
    return state_views(torch.cat([nv, postings[None], blocks[None], ni]), k)


def shard_row(dix, shard: int):
    """Shard ``shard``'s row of an index of stacked shards: the same
    ``DeviceIndex`` type, every column a view of its row."""
    return type(dix)._make(None if x is None else x[shard] for x in dix)


def _gather_index(i: int, n: int) -> int:
    """A traced gather's index into an axis of n: negative counts from the
    end, then the index clamps to [0, n) (``jnp`` indexing under ``jit``)."""
    i = i + n if i < 0 else i
    return min(max(i, 0), n - 1)


def traverse_ref(
    dix,
    blk_tab: torch.Tensor,  # [N, R, B] int32, -1 padded
    rest_tab: torch.Tensor,  # [N, R, B] int32
    order: torch.Tensor,  # [N, R] int32 processing order
    ordered_bounds: torch.Tensor,  # [N, R] int32 BoundSum of order[i]
    budget: torch.Tensor,  # [N] int32 postings budgets
    maxr: torch.Tensor,  # [N] int32 range budgets
    carry: torch.Tensor,  # [N, 2k+5] int32 carry in
    *,
    s_pad: int,
    k: int,
    quantum: int | None = None,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    docs_format: str = "int32",
) -> torch.Tensor:
    """Each lane's whole-query loop from its carry; the new [N, 2k+5] carry.

    The plain version of the ``traverse`` kernel, and the reference's
    ``_traverse_loop`` run once per lane: the exit flags are computed at
    the top of each iteration (``θ = vals[k-1]``; safe when ``safe_stop``
    and ``bound <= θ`` and ``θ > 0``; budget when ``postings >= budget`` or
    ``i >= maxr``, all signed int32); the iteration that finds an exit
    scores nothing and leaves the cursor alone but still counts toward
    ``quantum``; ``quantum=None`` runs to an exit. ``order[i]``,
    ``ordered_bounds[i]`` and the tables at ``order[i]`` are read as the
    reference's traced gathers read them (:func:`_gather_index`). Each
    iteration reads
    θ and the postings counter to the host, so this is the tests' and the
    CPU's path, never the card's.

    ``dix`` may be S range shards stacked row by row (every column
    ``[S, W]``, ``range_starts`` ``[S, R]``): lane n then reads shard
    n % S (:func:`shard_row`), the reference's double vmap over [N, S].
    """
    N, R = order.shape
    n_shards = dix.range_starts.shape[0] if dix.range_starts.dim() == 2 else 0
    if n_shards and N % n_shards:
        raise ValueError(f"{N} lanes do not divide into {n_shards} shards")
    rows = []
    for n in range(N):
        lane_dix = shard_row(dix, n % n_shards) if n_shards else dix
        order_h = order[n].tolist()
        bounds_h = ordered_bounds[n].tolist()
        bud, mr = int(budget[n]), int(maxr[n])
        state = state_views(carry[n, : 2 * k + 2], k)
        i, s_safe, s_budget = (int(x) for x in carry[n, 2 * k + 2:].tolist())
        steps = 0
        while i < R and not s_safe and not s_budget and (
            quantum is None or steps < quantum
        ):
            th, postings = theta_postings(state)
            s_safe = int(safe_stop and bounds_h[_gather_index(i, R)] <= th and th > 0)
            s_budget = int(postings >= bud or i >= mr)
            if not (s_safe or s_budget):
                r = _gather_index(order_h[_gather_index(i, R)], R)
                state = range_step_ref(
                    lane_dix, state, blk_tab[n, r], rest_tab[n, r],
                    lane_dix.range_starts[r],
                    s_pad=s_pad, k=k, prune_blocks=prune_blocks,
                    docs_format=docs_format,
                )
                i += 1
            steps += 1
        tail = torch.tensor([i, s_safe, s_budget], dtype=torch.int32,
                            device=carry.device)
        rows.append(torch.cat([state.vals, state.postings[None], state.blocks[None],
                               state.ids, tail]))
    if not rows:
        return carry.new_empty((0, carry_width(k)))
    return torch.stack(rows)
