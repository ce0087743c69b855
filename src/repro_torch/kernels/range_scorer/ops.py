"""Public entry point of the range scorer.

``score_blocks`` is the one function the traversal engine calls. ``impl``
selects the plain PyTorch path (``"torch"``, the oracle, and what the CPU
runs) or the CUDA kernels (``"cuda"``). ``docs_format`` selects how block
docids reach the scorer: ``"int32"`` gathers the raw docid array,
``"packed"`` decodes per-block bit-packed deltas in place (DESIGN.md §12)
— the two are bitwise identical by contract.

Under ``impl="cuda"`` the gather of impacts and docids stays plain
PyTorch around the two standalone kernels, as it stayed XLA around the
Pallas kernels. The engine's range step does not come through here: it
runs the fused ``kernel.range_step`` (``core.range_daat.score_range_step``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._abstract import is_abstract, record_launch, record_reads
from repro_torch.kernels.range_scorer import kernel, ref
from repro_torch.kernels.range_scorer.ref import DOCS_FORMATS, IMPACT_BIAS  # noqa: F401

IMPLS = ("torch", "cuda")

__all__ = ["DOCS_FORMATS", "IMPACT_BIAS", "IMPLS", "score_blocks"]


def score_blocks(
    post_docs: torch.Tensor,
    post_imps: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    keep: torch.Tensor,
    range_start,
    *,
    s_pad: int,
    impl: str = "torch",
    docs_format: str = "int32",
    pack_words: torch.Tensor | None = None,
    pack_dir: torch.Tensor | None = None,
    pack_firsts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Accumulate surviving posting blocks into an int32 [s_pad] accumulator.

    Under ``docs_format="packed"``, ``post_docs`` is ignored (pass any
    placeholder) and the per-block merged directory (``pack_dir``, see
    ``core.clustered_index.pack_dir_entries``) and first-docid column plus
    the shared ``pack_words`` stream are required; impacts stay
    offset-addressed via ``starts`` in both formats. On fake or meta
    tensors it returns an empty accumulator (``kernels._abstract``).
    """
    if docs_format not in DOCS_FORMATS:
        raise ValueError(f"docs_format {docs_format!r} not in {DOCS_FORMATS}")
    if docs_format == "packed" and (
        pack_words is None or pack_dir is None or pack_firsts is None
    ):
        raise ValueError("docs_format='packed' requires all pack_* arrays")
    if is_abstract(starts):  # a dry run: the shape rule, no data
        if impl == "cuda":
            if docs_format == "packed":
                record_launch("unpack_locals", pack_words, starts, lens, pack_dir,
                              pack_firsts, keep)
            record_launch("scatter_accumulate", post_docs, post_imps, starts, lens, keep)
        else:  # the plain version reads the same inputs and launches nothing
            record_reads(post_docs, post_imps, starts, lens, keep, pack_words, pack_dir,
                         pack_firsts)
        return torch.empty((s_pad,), dtype=torch.int32, device=starts.device)
    if impl == "torch":
        if docs_format == "packed":
            return ref.score_blocks_packed_ref(
                pack_words, post_imps, starts, lens,
                pack_dir, pack_firsts, keep, range_start, s_pad,
            )
        return ref.score_blocks_ref(
            post_docs, post_imps, starts, lens, keep, range_start, s_pad
        )
    if impl == "cuda":
        if docs_format == "packed":
            local = kernel.unpack_locals(
                pack_words, starts, lens, pack_dir, pack_firsts, keep, range_start
            )
            valid = ref._lane_valid(starts, lens, keep)
            v = ref.gather_block_impacts(post_imps, starts)
            vals = torch.where(valid, v, 0).to(torch.int32).reshape(local.shape)
        else:
            local, vals = ref.gather_block_postings(
                post_docs, post_imps, starts, lens, keep, range_start
            )
        return kernel.scatter_accumulate(local, vals, s_pad)
    raise ValueError(f"impl {impl!r} not in {IMPLS}")
