"""Range-aware anytime DAAT traversal on one device (paper §3, DESIGN.md §2).

The port of the JAX package's single-query engine. Two ways to drive the
same per-range scoring step:

  * host-driven — ``Engine.step`` scores one range, with the go/no-go
    decision taken on the host between steps (the paper's steady_clock
    loop), used by ``core.anytime``;
  * whole-query — ``device_traverse`` runs the query to an exit condition
    under a postings budget (the deterministic JASS-style proxy).

The whole-query loop runs on the host here: it reads θ and the postings
counter once per range (one device->host copy per range) to take the same
exit decisions as the reference's ``lax.while_loop``. Under ``impl="cuda"``
a range step is one launch of the fused ``range_step`` kernel; under
``impl="torch"`` it is that kernel's plain version. Scores, ids and
counters stay int32 on the device; every host-observable matches the
reference bitwise.

Baselines share this engine via flags (DESIGN.md §2 table):
  ordering="boundsum"|"docid"  ×  bounds="range"|"global"  ×  safe/budget/fixed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.clustered_index import BLOCK, ClusteredIndex, pack_dir_entries
from repro_torch.kernels.range_scorer import kernel as scorer_kernel
from repro_torch.kernels.range_scorer import ops as scorer_ops
from repro_torch.kernels.range_scorer import ref as scorer_ref
from repro_torch.kernels.range_scorer.ref import TopKState, init_state, merge_topk, theta

__all__ = [
    "DOCS_FORMATS",
    "DeviceIndex",
    "IMPACT_BIAS",
    "IMPACT_DTYPES",
    "IMPLS",
    "TopKState",
    "TraverseCarry",
    "TraverseResult",
    "QueryPlan",
    "Engine",
    "init_state",
    "init_carry",
    "carry_done",
    "carry_result",
    "merge_topk",
    "pack_impacts",
    "resolve_device",
    "score_range_step",
    "device_traverse",
    "theta",
    "topk_docs",
    "exit_reason",
    "exit_reasons",
]

IMPACT_BIAS = scorer_ops.IMPACT_BIAS
IMPACT_DTYPES = ("int32", "int8")
DOCS_FORMATS = scorer_ops.DOCS_FORMATS
IMPLS = scorer_ops.IMPLS
INT32_MAX = scorer_ref.INT32_MAX
# The range top-k under lax.top_k's tie order, which the tests pin here.
_range_topk = scorer_ref.range_topk


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``None`` means the card; a missing card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def pack_impacts(impacts: np.ndarray, impact_dtype: str) -> np.ndarray:
    """Host impacts (true int32 codes) -> device storage representation.

    ``"int32"`` uploads impacts verbatim; ``"int8"`` stores the biased code
    ``impact - IMPACT_BIAS`` so 8-bit quantized impacts (range [1, 255])
    fit a signed byte — 1 B/posting on the device, widened back inside the
    scorer gather (DESIGN.md §8). Requires every impact <= 2^8 - 1; the
    caller (``Engine``) enforces this via the quantizer's bit width.
    """
    if impact_dtype == "int32":
        return np.asarray(impacts, np.int32)
    if impact_dtype == "int8":
        return (np.asarray(impacts, np.int64) - IMPACT_BIAS).astype(np.int8)
    raise ValueError(f"impact_dtype {impact_dtype!r} not in {IMPACT_DTYPES}")


class DeviceIndex(NamedTuple):
    """Device mirror of the host index: flat tensors on one device.

    Under ``docs_format="packed"`` (DESIGN.md §12), ``docs`` shrinks to a
    (1,)-placeholder (never gathered) and the three ``pack_*`` tensors
    carry the bit-packed delta stream plus its per-block merged directory
    (``pack_dir_entries``), parallel to ``blk_start``. ``pack_words`` is
    int32 holding the uint32 bit pattern (PyTorch has no uint32 shifts on
    the CPU); its bytes equal the reference's uint32 upload.
    """

    docs: torch.Tensor  # [nnz] int32 (packed: [1] placeholder)
    impacts: torch.Tensor  # [nnz] int32, or int8 biased by IMPACT_BIAS (§8)
    blk_start: torch.Tensor  # [NB] int32
    blk_len: torch.Tensor  # [NB] int32
    blk_maximp: torch.Tensor  # [NB] int32
    bounds_dense: torch.Tensor  # [V, R] int32
    range_starts: torch.Tensor  # [R] int32
    range_sizes: torch.Tensor  # [R] int32
    pack_words: torch.Tensor | None = None  # [n_words] int32 (uint32 bits)
    pack_dir: torch.Tensor | None = None  # [NB] int32 merged (start | width)
    pack_first: torch.Tensor | None = None  # [NB] int32 first docid per block


def score_range_step(
    dix: DeviceIndex,
    state: TopKState,
    blk_ids: torch.Tensor,  # [B] int32, -1 padded
    rest: torch.Tensor,  # [B] int32 — bound sum of *other* terms for pruning
    range_start: torch.Tensor,  # 0-d int32
    *,
    s_pad: int,
    k: int,
    impl: str = "torch",
    prune_blocks: bool = True,
    docs_format: str = "int32",
) -> TopKState:
    """Score one range and merge its top-k into the running state.

    ``impl="cuda"`` is one launch of the fused ``range_step`` kernel;
    ``impl="torch"`` its plain version. The old state stays valid.
    """
    kw = dict(s_pad=s_pad, k=k, prune_blocks=prune_blocks, docs_format=docs_format)
    if impl == "cuda":
        return scorer_kernel.range_step(dix, state, blk_ids, rest, range_start, **kw)
    if impl == "torch":
        return scorer_ref.range_step_ref(dix, state, blk_ids, rest, range_start, **kw)
    raise ValueError(f"impl {impl!r} not in {IMPLS}")


class TraverseResult(NamedTuple):
    state: TopKState
    ranges_processed: int
    exit_safe: bool  # stopped because remaining bounds <= theta
    exit_budget: bool  # stopped by postings budget / fixed-n


class TraverseCarry(NamedTuple):
    """Resumable mid-flight traversal state (DESIGN.md §11).

    The cursor into the processing order, the running top-k state (whose
    ``postings`` counter is cumulative, so the budget keeps its meaning
    across calls) and the two exit flags. The loop runs on the host, so
    the cursor and flags are host values; a query stepped ``quantum``
    ranges at a time finishes identical to one uninterrupted call.
    """

    i: int
    state: TopKState
    exit_safe: bool
    exit_budget: bool


def init_carry(k: int, device="cpu") -> TraverseCarry:
    """A fresh single-query carry (cursor 0, empty heap, no exit flags)."""
    return TraverseCarry(i=0, state=init_state(k, device), exit_safe=False,
                         exit_budget=False)


def carry_done(carry: TraverseCarry, n_ranges: int) -> bool:
    """Completion: an exit flag fired, or the order is spent."""
    return bool(carry.exit_safe or carry.exit_budget or carry.i >= n_ranges)


def carry_result(carry: TraverseCarry) -> TraverseResult:
    """View a (finished) carry as the equivalent ``TraverseResult``."""
    return TraverseResult(
        state=carry.state,
        ranges_processed=carry.i,
        exit_safe=carry.exit_safe,
        exit_budget=carry.exit_budget,
    )


def _host_list(x) -> list:
    return x.tolist() if isinstance(x, torch.Tensor) else np.asarray(x).tolist()


def _traverse_loop(
    dix: DeviceIndex,
    blk_tab: torch.Tensor,  # [R, B]
    rest_tab: torch.Tensor,  # [R, B]
    order,  # [R] processing order (tensor or host array)
    ordered_bounds,  # [R] BoundSum of order[i]
    carry: TraverseCarry,
    budget: int,
    maxr: int,
    *,
    s_pad: int,
    k: int,
    quantum: int | None,
    safe_stop: bool,
    prune_blocks: bool,
    impl: str,
    docs_format: str = "int32",
) -> TraverseCarry:
    """The one range-at-a-time loop both entry points share.

    ``quantum=None`` runs to an exit condition (``device_traverse``);
    ``quantum=Q`` also stops after Q iterations, returning the carry
    mid-flight. As in the reference, the stop flags are computed at the top
    of each iteration from the state so far, and the iteration that finds
    an exit scores nothing and leaves the cursor alone.
    """
    R = blk_tab.shape[0]
    order_h = _host_list(order)
    bounds_h = _host_list(ordered_bounds)
    i, state = int(carry.i), carry.state
    s_safe, s_budget = bool(carry.exit_safe), bool(carry.exit_budget)
    steps = 0
    while i < R and not s_safe and not s_budget and (
        quantum is None or steps < quantum
    ):
        # One device->host read per range: θ and the postings counter.
        th, postings = scorer_ref.theta_postings(state)
        s_safe = safe_stop and bounds_h[i] <= th and th > 0
        s_budget = postings >= budget or i >= maxr
        if not (s_safe or s_budget):
            r = order_h[i]
            state = score_range_step(
                dix,
                state,
                blk_tab[r],
                rest_tab[r],
                dix.range_starts[r],
                s_pad=s_pad,
                k=k,
                impl=impl,
                prune_blocks=prune_blocks,
                docs_format=docs_format,
            )
            i += 1
        steps += 1
    return TraverseCarry(i=i, state=state, exit_safe=s_safe, exit_budget=s_budget)


def device_traverse(
    dix: DeviceIndex,
    blk_tab: torch.Tensor,  # [R, B] int32, -1 padded — per-range block ids
    rest_tab: torch.Tensor,  # [R, B] int32
    order,  # [R] int32 — processing order of ranges
    ordered_bounds,  # [R] int32 — BoundSum of order[i] (0 if unused)
    *,
    s_pad: int,
    k: int,
    budget_postings: int = INT32_MAX,
    max_ranges: int = INT32_MAX,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    impl: str = "torch",
    docs_format: str = "int32",
) -> TraverseResult:
    """Whole-query traversal to an exit condition."""
    carry = _traverse_loop(
        dix,
        blk_tab,
        rest_tab,
        order,
        ordered_bounds,
        init_carry(k, dix.blk_start.device),
        int(budget_postings),
        int(max_ranges),
        s_pad=s_pad,
        k=k,
        quantum=None,
        safe_stop=safe_stop,
        prune_blocks=prune_blocks,
        impl=impl,
        docs_format=docs_format,
    )
    return carry_result(carry)


def topk_docs(state: TopKState) -> tuple[np.ndarray, np.ndarray]:
    """(docids, scores) for one query's state with empty slots stripped."""
    vals = state.vals.cpu().numpy()
    ids = state.ids.cpu().numpy()
    keep = ids >= 0
    return ids[keep], vals[keep]


def exit_reason(safe: bool, budget: bool) -> str:
    """Collapse the two exit flags into the host-facing reason string."""
    if safe:
        return "safe"
    if budget:
        return "budget"
    return "exhausted"


def exit_reasons(result: TraverseResult) -> list[str]:
    """Exit reason strings of a ``TraverseResult`` (one per query)."""
    safe = np.asarray(result.exit_safe).reshape(-1)
    budget = np.asarray(result.exit_budget).reshape(-1)
    return [exit_reason(bool(s), bool(b)) for s, b in zip(safe, budget)]


# --------------------------------------------------------------------------
# Host-facing engine
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Device-ready per-query traversal inputs."""

    q_terms: np.ndarray  # [L] int32, -1 padded
    blk_tab: torch.Tensor  # [R, B] int32
    rest_tab: torch.Tensor  # [R, B] int32
    order: torch.Tensor  # [R] int32
    ordered_bounds: torch.Tensor  # [R] int32
    order_host: np.ndarray  # same as order, on host
    bounds_host: np.ndarray  # ordered bounds, on host


def _next_pow2(n: int, lo: int = 32) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class Engine:
    """Cluster-skipping anytime query engine over a built index.

    ``ordering``: "boundsum" (the paper's proposal) or "docid" (range-
    oblivious baseline). ``bounds``: "range" (U[t,r], enables safe stop and
    tight block pruning) or "global" (listwise U_t only — the Default-index
    baseline; safe stop then uses the whole-collection bound).
    ``impact_dtype``: "int32" (default) or "int8" — native 8-bit postings
    impacts on the device, widened only inside the scorer gather.
    ``docs_format``: "int32" (default) or "packed" — bit-packed per-block
    docid deltas on the device, decoded inside the scorer; bitwise
    identical results by contract.

    ``device=None`` is the card and raises where there is none; pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. ``impl=None``
    is ``"cuda"`` (the fused range-step kernel) on a CUDA device and
    ``"torch"`` (its plain version) on the CPU; ``impl="cuda"`` on the CPU
    raises, and so does ``impl="cuda"`` with k above the kernel's limit
    (``kernels.range_scorer.kernel.MAX_K``).
    """

    def __init__(
        self,
        index: ClusteredIndex,
        k: int = 10,
        ordering: str = "boundsum",
        bounds: str = "range",
        impl: str | None = None,
        impact_dtype: str = "int32",
        docs_format: str = "int32",
        device=None,
    ):
        self.device = resolve_device(device)
        if impl is None:
            impl = "cuda" if self.device.type == "cuda" else "torch"
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not in {IMPLS}")
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"impl='cuda' launches CUDA kernels and needs a CUDA device, "
                f"got device={str(self.device)!r}; use impl='torch' on the CPU"
            )
        if impl == "cuda" and not 1 <= k <= scorer_kernel.MAX_K:
            raise ValueError(
                f"impl='cuda' takes 1 <= k <= {scorer_kernel.MAX_K} (the range_step "
                f"kernel's limit), got k={k}; use impl='torch' for a larger k"
            )
        self.index = index
        self.k = k
        self.ordering = ordering
        self.bounds = bounds
        self.impl = impl
        if impact_dtype not in IMPACT_DTYPES:
            raise ValueError(f"impact_dtype {impact_dtype!r} not in {IMPACT_DTYPES}")
        if impact_dtype == "int8" and index.quantizer.bits > 8:
            raise ValueError(
                f"impact_dtype='int8' needs quantizer.bits <= 8, "
                f"got {index.quantizer.bits}"
            )
        self.impact_dtype = impact_dtype
        if docs_format not in DOCS_FORMATS:
            raise ValueError(f"docs_format {docs_format!r} not in {DOCS_FORMATS}")
        self.docs_format = docs_format
        self.s_pad = int(
            (index.max_range_size + BLOCK - 1) // BLOCK * BLOCK
        ) or BLOCK

        def up(a, dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        if docs_format == "packed":
            packed = index.packed_postings()
            # The raw docid array stays on the host; the scorer never
            # gathers it, so a (1,)-placeholder keeps the layout.
            docs_dev = torch.zeros(1, dtype=torch.int32, device=self.device)
            pack_dev = dict(
                pack_words=up(np.asarray(packed.words, np.uint32).view(np.int32),
                              np.int32),
                pack_dir=up(pack_dir_entries(packed), np.int32),
                pack_first=up(packed.blk_first, np.int32),
            )
        else:
            docs_dev = up(index.docs, np.int32)
            pack_dev = {}
        self.dix = DeviceIndex(
            docs=docs_dev,
            impacts=torch.from_numpy(pack_impacts(index.impacts, impact_dtype)).to(
                self.device
            ),
            blk_start=up(index.blk_start, np.int32),
            blk_len=up(index.blk_len, np.int32),
            blk_maximp=up(index.blk_maximp, np.int32),
            bounds_dense=up(index.bounds_dense, np.int32),
            range_starts=up(index.range_starts, np.int32),
            range_sizes=up(index.arrangement.range_sizes, np.int32),
            **pack_dev,
        )

    # ------------------------------------------------------------- planning
    def plan(self, q_terms: np.ndarray) -> QueryPlan:
        q = np.asarray(q_terms, dtype=np.int32).reshape(-1)
        blk, rest_range = self.index.query_block_table(q)
        R, width = blk.shape
        pad = _next_pow2(width)
        if pad != width:
            blk = np.pad(blk, ((0, 0), (0, pad - width)), constant_values=-1)
            rest_range = np.pad(rest_range, ((0, 0), (0, pad - width)))

        bsums = self.index.bounds_dense[q[q >= 0]].sum(axis=0).astype(np.int64)
        if self.bounds == "global":
            # Listwise bounds only: rest = sum of other terms' GLOBAL bounds.
            gsum = int(self.index.term_bound[q[q >= 0]].sum())
            rest = np.where(
                blk >= 0,
                gsum - self.index.term_bound[self.index.blk_term[blk.clip(0)]],
                0,
            ).astype(np.int32)
            # Safe stop bound per range = whole-collection bound (loose).
            per_range_bound = np.full(R, gsum, dtype=np.int64)
        else:
            rest = rest_range.astype(np.int32)
            per_range_bound = bsums

        if self.ordering == "boundsum":
            order = np.argsort(-bsums, kind="stable").astype(np.int32)
        elif self.ordering == "docid":
            order = np.arange(R, dtype=np.int32)
        else:
            raise ValueError(f"unknown ordering {self.ordering!r}")
        # The device tables are int32; a BoundSum past 2^31 must saturate,
        # not wrap — a negative bound satisfies `bound <= theta` at once and
        # defeats safe termination. Saturation only errs conservative.
        bounds_host = per_range_bound[order].astype(np.int64)
        ordered_bounds = np.clip(bounds_host, 0, INT32_MAX).astype(np.int32)

        def up(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

        return QueryPlan(
            q_terms=q,
            blk_tab=up(blk),
            rest_tab=up(rest),
            order=up(order),
            ordered_bounds=up(ordered_bounds),
            order_host=order,
            bounds_host=bounds_host,
        )

    # ------------------------------------------------------- execution modes
    def init_state(self) -> TopKState:
        return init_state(self.k, self.device)

    def synchronize(self) -> None:
        """Wait for the engine's device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, plan: QueryPlan, state: TopKState, i: int) -> TopKState:
        """Host-driven: score the i-th range of the plan's order."""
        r = int(plan.order_host[i])
        return score_range_step(
            self.dix,
            state,
            plan.blk_tab[r],
            plan.rest_tab[r],
            self.dix.range_starts[r],
            s_pad=self.s_pad,
            k=self.k,
            impl=self.impl,
            prune_blocks=True,
            docs_format=self.docs_format,
        )

    def traverse(
        self,
        plan: QueryPlan,
        budget_postings: int = INT32_MAX,
        max_ranges: int = INT32_MAX,
        safe_stop: bool = True,
        prune_blocks: bool = True,
    ) -> TraverseResult:
        """Whole-query traversal to an exit condition."""
        return device_traverse(
            self.dix,
            plan.blk_tab,
            plan.rest_tab,
            plan.order_host,
            plan.bounds_host.clip(0, INT32_MAX),
            s_pad=self.s_pad,
            k=self.k,
            budget_postings=budget_postings,
            max_ranges=max_ranges,
            safe_stop=safe_stop,
            prune_blocks=prune_blocks,
            impl=self.impl,
            docs_format=self.docs_format,
        )

    # ----------------------------------------------------------------- util
    def topk_docs(self, state: TopKState):
        """(docids, scores) with empty slots stripped, host-side."""
        return topk_docs(state)
