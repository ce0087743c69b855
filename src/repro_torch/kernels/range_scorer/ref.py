"""Plain PyTorch versions of the range scorer (the port's oracle).

Scores one document range: gathers the postings of the query's surviving
blocks and scatter-adds quantized impacts into a range-local int32
accumulator. Every function mirrors its namesake in the JAX package's
``kernels/range_scorer/ref.py`` bitwise; the two CUDA kernels in
``kernel.py`` must match :func:`scatter_accumulate_ref` and
:func:`unpack_locals_ref` exactly. The CPU tests run these functions, and
``chip_smoke.py`` holds the kernels against them on the card.

The packed word stream is held as int32 carrying the uint32 bit pattern:
PyTorch has no right shift for ``uint32`` on the CPU, so the decode widens
each word to int64 and masks it back to 32 bits before shifting.
"""

from __future__ import annotations

import torch

from repro_torch.core.clustered_index import BLOCK, PACK_DIR_BITS, PACK_WIDTHS

# Zero-point for native int8 impact storage: quantized impacts live in
# [1, 2^b - 1] ⊆ [1, 255] for b <= 8, which overflows signed int8, so the
# stored code is ``impact - IMPACT_BIAS`` ∈ [-127, 127] and the gather
# widens with ``+ IMPACT_BIAS`` back into exact int32.
IMPACT_BIAS = 128

_WORD_MASK = 0xFFFFFFFF

__all__ = [
    "BLOCK",
    "IMPACT_BIAS",
    "gather_block_impacts",
    "gather_block_postings",
    "gather_block_postings_packed",
    "scatter_accumulate_ref",
    "score_blocks_packed_ref",
    "score_blocks_ref",
    "unpack_dir",
    "unpack_locals_ref",
]


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
