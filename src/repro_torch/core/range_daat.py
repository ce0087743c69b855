"""Range-aware anytime DAAT traversal on one device (paper §3, DESIGN.md §2).

The port of the JAX package's single-query engine. Two ways to drive the
same per-range scoring step:

  * host-driven — ``Engine.step`` scores one range, with the go/no-go
    decision taken on the host between steps (the paper's steady_clock
    loop), used by ``core.anytime``;
  * whole-query — ``device_traverse`` runs the query to an exit condition
    under a postings budget (the deterministic JASS-style proxy).

and their batched forms, ``batched_traverse`` (N queries to an exit, the
reference's vmap) and ``batched_traverse_resume`` (N carries advanced at
most ``quantum`` ranges). Every whole-query entry point goes through
``traverse_lanes``: under ``impl="cuda"`` one launch of the ``traverse``
kernel, one CTA per query walking its processing order and taking the
reference's ``lax.while_loop`` exit decisions on the device; under
``impl="torch"`` its plain version, a host loop that reads θ and the
postings counter once per range. ``Engine.step`` scores one range with
the fused ``range_step`` kernel (or its plain version). Scores, ids and
counters stay int32 on the device; every host-observable matches the
reference bitwise.

Baselines share this engine via flags (DESIGN.md §2 table):
  ordering="boundsum"|"docid"  ×  bounds="range"|"global"  ×  safe/budget/fixed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.clustered_index import BLOCK, ClusteredIndex, pack_dir_entries
from repro_torch.kernels._abstract import is_abstract, record_launch, record_reads
from repro_torch.kernels.range_scorer import kernel as scorer_kernel
from repro_torch.kernels.range_scorer import ops as scorer_ops
from repro_torch.kernels.range_scorer import ref as scorer_ref
from repro_torch.kernels.range_scorer.ref import TopKState, init_state, merge_topk, theta

__all__ = [
    "DOCS_FORMATS",
    "DeviceIndex",
    "DeviceTimer",
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
    "batched_init_carry",
    "carry_buffer",
    "carry_done",
    "carry_from_buffer",
    "carry_result",
    "carry_to_host",
    "lane_caps",
    "merge_topk",
    "pack_impacts",
    "resolve_device",
    "score_range_step",
    "device_traverse",
    "batched_traverse",
    "batched_traverse_resume",
    "theta",
    "topk_docs",
    "batched_topk_docs",
    "traverse_lanes",
    "upload_int32",
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


class DeviceTimer:
    """The device time of the work queued between ``start`` and ``stop``.

    On a CUDA device, two CUDA events recorded on the current stream
    (``kernel.traverse`` records them right around its launch); ``ms()`` reads
    them and is called only after the caller's own read of the results has
    waited for the stream, so timing adds no synchronisation. On the CPU
    the plain versions run inside the call, and ``ms()`` is None: not
    measured.
    """

    def __init__(self, device: torch.device):
        self._events = None
        if device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self._events is not None:
            self._events[0].record()

    def stop(self) -> None:
        if self._events is not None:
            self._events[1].record()

    def ms(self) -> float | None:
        if self._events is None:
            return None
        return float(self._events[0].elapsed_time(self._events[1]))


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
    """A finished traversal: host values for one query, [N] tensors for N."""

    state: TopKState
    ranges_processed: int
    exit_safe: bool  # stopped because remaining bounds <= theta
    exit_budget: bool  # stopped by postings budget / fixed-n


class TraverseCarry(NamedTuple):
    """Resumable mid-flight traversal state of N lanes (DESIGN.md §11).

    The cursors into the processing orders ([N] int32), the running top-k
    states ([N, k]; the ``postings`` counter is cumulative, so the budget
    keeps its meaning across calls) and the two exit flags ([N] bool):
    numpy from ``batched_init_carry``, tensors from
    ``batched_traverse_resume``. A query stepped ``quantum`` ranges at a
    time finishes identical to one uninterrupted call.
    """

    i: np.ndarray | torch.Tensor
    state: TopKState
    exit_safe: np.ndarray | torch.Tensor
    exit_budget: np.ndarray | torch.Tensor


def init_carry(k: int, device="cpu") -> TraverseCarry:
    """A fresh single-query carry (cursor 0, empty heap, no exit flags):
    0-d int32 cursor and bool flags and ``init_state``'s empty heap, on
    ``device``."""
    return TraverseCarry(
        i=torch.zeros((), dtype=torch.int32, device=device),
        state=init_state(k, device),
        exit_safe=torch.zeros((), dtype=torch.bool, device=device),
        exit_budget=torch.zeros((), dtype=torch.bool, device=device),
    )


def batched_init_carry(n: int, k: int, parked: bool = False) -> TraverseCarry:
    """[n]-lane host (numpy) carry, fresh on every lane.

    ``parked=True`` raises every lane's ``exit_budget`` flag: a parked lane
    is inert (the loop stops before any work), which is how vacant
    in-flight slots ride along in a dispatch at zero cost.
    """
    return TraverseCarry(
        i=np.zeros(n, np.int32),
        state=TopKState(
            vals=np.zeros((n, k), np.int32),
            ids=np.full((n, k), -1, np.int32),
            postings=np.zeros(n, np.int32),
            blocks=np.zeros(n, np.int32),
        ),
        exit_safe=np.zeros(n, bool),
        exit_budget=np.full(n, parked, bool),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def carry_done(carry: TraverseCarry, n_ranges: int) -> np.ndarray:
    """Host-side [N] completion mask: an exit flag fired, or the order is
    spent. A lane whose flags are still False but whose cursor reached R
    exited "exhausted"."""
    return (_host(carry.exit_safe) | _host(carry.exit_budget)
            | (_host(carry.i) >= n_ranges))


def carry_result(carry: TraverseCarry) -> TraverseResult:
    """View a (finished) carry as the equivalent ``TraverseResult``."""
    return TraverseResult(
        state=carry.state,
        ranges_processed=carry.i,
        exit_safe=carry.exit_safe,
        exit_budget=carry.exit_budget,
    )


def carry_buffer(carry: TraverseCarry):
    """A batched carry as the kernels' [N, 2k+5] int32 rows
    ``vals[k] | postings | blocks | ids[k] | i | exit_safe | exit_budget``:
    numpy for a host carry (``batched_init_carry``), a tensor on the
    carry's device for a device one (``batched_traverse_resume``'s)."""
    st = carry.state
    cols = (st.vals, st.postings, st.blocks, st.ids, carry.i, carry.exit_safe,
            carry.exit_budget)
    n = len(carry.i)
    if isinstance(carry.i, torch.Tensor):
        return torch.cat([c.to(torch.int32).reshape(n, -1) for c in cols], dim=1)
    return np.concatenate([np.asarray(c, np.int32).reshape(n, -1) for c in cols], axis=1)


def carry_from_buffer(buf: torch.Tensor, k: int) -> TraverseCarry:
    """The batched carry over an [N, 2k+5] buffer: [N] tensors (views, and
    bool flags), the state's fields views of the buffer."""
    return TraverseCarry(
        i=buf[:, 2 * k + 2],
        state=TopKState(vals=buf[:, :k], ids=buf[:, k + 2:2 * k + 2],
                        postings=buf[:, k], blocks=buf[:, k + 1]),
        exit_safe=buf[:, 2 * k + 3] != 0,
        exit_budget=buf[:, 2 * k + 4] != 0,
    )


def carry_to_host(carry: TraverseCarry) -> TraverseCarry:
    """A batched carry as writable host (numpy) arrays, read in one copy.

    A carry from ``batched_traverse_resume`` holds views of one
    [N, 2k+5] buffer, which is read whole; any other carry is laid out
    first (``carry_buffer``). The cursor and the counters are int32 and
    the flags bool, as ``batched_init_carry`` makes them.
    """
    k = carry.state.vals.shape[1]
    base = getattr(carry.i, "_base", None)
    if base is None or base.dim() != 2 or base.shape[1] != 2 * k + 5:
        base = carry_buffer(carry)
    host = np.array(_host(base), np.int32)
    return TraverseCarry(
        i=host[:, 2 * k + 2],
        state=TopKState(vals=host[:, :k], ids=host[:, k + 2:2 * k + 2],
                        postings=host[:, k], blocks=host[:, k + 1]),
        exit_safe=host[:, 2 * k + 3] != 0,
        exit_budget=host[:, 2 * k + 4] != 0,
    )


def upload_int32(arrays, device) -> list[torch.Tensor]:
    """Int32 tensors on ``device`` for ``arrays``, the host ones in one copy.

    Every array that is not a tensor is written into one flat int32
    staging buffer, which is uploaded once; its tensors are views of that
    buffer in the arrays' shapes. A tensor passes through as it is.
    """
    host = [np.asarray(a) for a in arrays if not isinstance(a, torch.Tensor)]
    flat = np.empty(sum(a.size for a in host), np.int32)
    offsets, o = [], 0
    for a in host:
        flat[o:o + a.size] = a.reshape(-1)
        offsets.append(o)
        o += a.size
    if not host:
        return list(arrays)
    dev = torch.from_numpy(flat).to(device)
    views = iter([dev[o:o + a.size].view(a.shape) for o, a in zip(offsets, host)])
    return [a if isinstance(a, torch.Tensor) else next(views) for a in arrays]


def lane_caps(x):
    """Per-lane postings budgets or range caps, clamped to [0, 2^31 - 1]
    (a tensor passes through)."""
    if isinstance(x, torch.Tensor):
        return x
    return np.clip(np.asarray(x, np.int64).reshape(-1), 0, INT32_MAX)


def traverse_lanes(
    dix: DeviceIndex,
    blk_tabs: torch.Tensor,  # [N, R, B] int32, -1 padded
    rest_tabs: torch.Tensor,  # [N, R, B] int32
    orders: torch.Tensor,  # [N, R] int32
    ordered_bounds: torch.Tensor,  # [N, R] int32
    budgets: torch.Tensor,  # [N] int32
    max_ranges: torch.Tensor,  # [N] int32
    carry: torch.Tensor,  # [N, 2k+5] int32 carry in
    *,
    s_pad: int,
    k: int,
    quantum: int | None = None,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    impl: str = "torch",
    docs_format: str = "int32",
    timer: DeviceTimer | None = None,
) -> torch.Tensor:
    """N lanes' loops from a carry buffer; the [N, 2k+5] carry out.

    ``impl="cuda"`` is one launch of the ``traverse`` kernel (no host
    round trip until the caller reads the result); ``impl="torch"`` its
    plain version, ``kernels.range_scorer.ref.traverse_ref``. ``dix`` may
    be S range shards stacked row by row (``serving.sharded``): lane n
    then reads shard n % S. A ``timer`` (the profiler's) times the
    kernel's launch on the card. On fake or meta tensors it returns an
    empty carry of the kernel's shape, and counts a launch on the ``cuda``
    route only (``kernels._abstract``).
    """
    if is_abstract(carry):  # a dry run: the shape rule, no data
        ins = (dix, blk_tabs, rest_tabs, orders, ordered_bounds, budgets, max_ranges, carry)
        if impl == "cuda":
            record_launch("traverse", *ins)
        else:  # the plain loop reads the same inputs and launches nothing
            record_reads(*ins)
        return torch.empty((carry.shape[0], 2 * k + 5), dtype=torch.int32,
                           device=carry.device)
    kw = dict(s_pad=s_pad, k=k, quantum=quantum, safe_stop=safe_stop,
              prune_blocks=prune_blocks, docs_format=docs_format)
    args = (dix, blk_tabs, rest_tabs, orders, ordered_bounds, budgets, max_ranges, carry)
    if impl == "cuda":
        return scorer_kernel.traverse(*args, **kw, timer=timer)
    if impl == "torch":
        return scorer_ref.traverse_ref(*args, **kw)
    raise ValueError(f"impl {impl!r} not in {IMPLS}")


def device_traverse(
    dix: DeviceIndex,
    blk_tab,  # [R, B] int32, -1 padded — per-range block ids
    rest_tab,  # [R, B] int32
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
    """Whole-query traversal to an exit condition.

    The tables may be host arrays or tensors on the index's device. Under
    ``impl="cuda"``: one upload (the host tables, the carry, the budget
    and the cap together), one ``traverse`` launch and one read of the
    carry row; the state stays on the device.
    """
    return _device_traverse(
        dix, blk_tab, rest_tab, order, ordered_bounds, s_pad=s_pad, k=k,
        budget_postings=budget_postings, max_ranges=max_ranges, safe_stop=safe_stop,
        prune_blocks=prune_blocks, impl=impl, docs_format=docs_format,
    )[0]


def _device_traverse(
    dix, blk_tab, rest_tab, order, ordered_bounds, *, s_pad, k, budget_postings,
    max_ranges, safe_stop, prune_blocks, impl, docs_format,
) -> tuple[TraverseResult, list[int]]:
    """``device_traverse`` and the host copy of the [2k+5] carry row, read
    in the one copy that also gives the cursor and the flags."""
    lanes = upload_int32(
        (blk_tab[None], rest_tab[None], order[None], ordered_bounds[None],
         lane_caps(budget_postings), lane_caps(max_ranges),
         carry_buffer(batched_init_carry(1, k))),
        dix.blk_start.device,
    )
    out = traverse_lanes(
        dix, *lanes, s_pad=s_pad, k=k, safe_stop=safe_stop, prune_blocks=prune_blocks,
        impl=impl, docs_format=docs_format,
    )[0]
    row = out.tolist()
    i, s_safe, s_budget = row[2 * k + 2:]
    return TraverseResult(state=scorer_ref.state_views(out[: 2 * k + 2], k),
                          ranges_processed=i, exit_safe=bool(s_safe),
                          exit_budget=bool(s_budget)), row


def batched_traverse(
    dix: DeviceIndex,
    blk_tabs: torch.Tensor,  # [N, R, B] int32, -1 padded
    rest_tabs: torch.Tensor,  # [N, R, B] int32
    orders: torch.Tensor,  # [N, R] int32
    ordered_bounds: torch.Tensor,  # [N, R] int32
    budgets,  # [N] int32 — per-query postings budgets
    max_ranges,  # [N] int32 — per-query range budgets
    *,
    s_pad: int,
    k: int,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    impl: str = "torch",
    docs_format: str = "int32",
) -> TraverseResult:
    """``device_traverse`` over a stacked batch of query plans.

    Every plan leaf and both budgets map over the leading batch axis, so
    one lagging query cannot consume another query's budget: each lane
    carries its own stop flags. The result has [N] leaves on the device:
    ``state.vals`` is [N, k], ``ranges_processed`` [N] int32 and the exit
    flags [N] bool, all from one carry buffer (``traverse_lanes``).
    """
    n = blk_tabs.shape[0]
    lanes = upload_int32(
        (blk_tabs, rest_tabs, orders, ordered_bounds, lane_caps(budgets),
         lane_caps(max_ranges), carry_buffer(batched_init_carry(n, k))),
        dix.blk_start.device,
    )
    out = traverse_lanes(
        dix, *lanes, s_pad=s_pad, k=k, safe_stop=safe_stop, prune_blocks=prune_blocks,
        impl=impl, docs_format=docs_format,
    )
    return carry_result(carry_from_buffer(out, k))


def batched_traverse_resume(
    dix: DeviceIndex,
    blk_tabs: torch.Tensor,  # [N, R, B] int32, -1 padded
    rest_tabs: torch.Tensor,  # [N, R, B] int32
    orders: torch.Tensor,  # [N, R] int32
    ordered_bounds: torch.Tensor,  # [N, R] int32
    budgets,  # [N] int32 — per-lane postings budgets
    max_ranges,  # [N] int32 — per-lane range budgets
    carry: TraverseCarry,  # [N]-batched leaves
    *,
    s_pad: int,
    k: int,
    quantum: int,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    impl: str = "torch",
    docs_format: str = "int32",
    timer: DeviceTimer | None = None,
) -> TraverseCarry:
    """Advance every lane at most ``quantum`` ranges from its carry.

    Lanes whose exit flags are already set (finished queries, parked
    slots) stop at once and ride along untouched. Chaining dispatches
    until ``carry_done`` ends bitwise equal to one ``device_traverse``
    per lane: same heap, counters and exit flags.
    """
    lanes = upload_int32(
        (blk_tabs, rest_tabs, orders, ordered_bounds, lane_caps(budgets),
         lane_caps(max_ranges), carry_buffer(carry)),
        dix.blk_start.device,
    )
    out = traverse_lanes(
        dix, *lanes, s_pad=s_pad, k=k, quantum=quantum, safe_stop=safe_stop,
        prune_blocks=prune_blocks, impl=impl, docs_format=docs_format, timer=timer,
    )
    return carry_from_buffer(out, k)


def topk_docs(state: TopKState) -> tuple[np.ndarray, np.ndarray]:
    """(docids, scores) for one query's state with empty slots stripped."""
    vals = _host(state.vals)
    ids = _host(state.ids)
    keep = ids >= 0
    return ids[keep], vals[keep]


def batched_topk_docs(state: TopKState) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-query (docids, scores) lists from an [N, k] state."""
    vals = _host(state.vals)
    ids = _host(state.ids)
    out = []
    for n in range(ids.shape[0]):
        keep = ids[n] >= 0
        out.append((ids[n][keep], vals[n][keep]))
    return out


def exit_reason(safe: bool, budget: bool) -> str:
    """Collapse the two exit flags into the host-facing reason string."""
    if safe:
        return "safe"
    if budget:
        return "budget"
    return "exhausted"


def exit_reasons(result: TraverseResult) -> list[str]:
    """Exit reason strings of a ``TraverseResult`` (one per query)."""
    safe = _host(result.exit_safe).reshape(-1)
    budget = _host(result.exit_budget).reshape(-1)
    return [exit_reason(bool(s), bool(b)) for s, b in zip(safe, budget)]


# --------------------------------------------------------------------------
# Host-facing engine
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Per-query traversal inputs, held on the host.

    The whole-query and batch paths stage the host tables into their one
    upload per launch. ``Engine.step`` (the anytime loop) reads the device
    tables, which are uploaded together, once, on first use.
    """

    q_terms: np.ndarray  # [L] int32, -1 padded
    blk_tab_host: np.ndarray  # [R, B] int32, -1 padded — per-range block ids
    rest_tab_host: np.ndarray  # [R, B] int32
    order_host: np.ndarray  # [R] int32 — processing order of ranges
    bounds_host: np.ndarray  # [R] ordered bounds (int64, unsaturated)
    device: torch.device

    @property
    def ordered_bounds_host(self) -> np.ndarray:
        """The ordered bounds saturated to int32, as the device reads them."""
        return np.clip(self.bounds_host, 0, INT32_MAX).astype(np.int32)

    @functools.cached_property
    def _device_tables(self) -> list[torch.Tensor]:
        return upload_int32((self.blk_tab_host, self.rest_tab_host, self.order_host,
                             self.ordered_bounds_host), self.device)

    def upload(self) -> list[torch.Tensor]:
        """The device tables (block ids, rest bounds, order, ordered
        bounds), uploaded together on the first call."""
        return self._device_tables

    @property
    def blk_tab(self) -> torch.Tensor:  # [R, B] int32 on the device
        return self._device_tables[0]

    @property
    def rest_tab(self) -> torch.Tensor:  # [R, B] int32 on the device
        return self._device_tables[1]

    @property
    def order(self) -> torch.Tensor:  # [R] int32 on the device
        return self._device_tables[2]

    @property
    def ordered_bounds(self) -> torch.Tensor:  # [R] int32 on the device
        return self._device_tables[3]


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
    raises. Both take any k the reference takes (1 <= k <= ``s_pad``).

    The positional order is the reference's. ``interpret`` names Pallas's
    interpret mode, which has no counterpart here: it is accepted and
    ignored. ``obs`` is a ``repro_torch.obs`` instrumentation handle (None:
    ``NOOP``); ``traverse`` counts exit reasons and postings through it,
    from the carry row it reads anyway.
    """

    def __init__(
        self,
        index: ClusteredIndex,
        k: int = 10,
        ordering: str = "boundsum",
        bounds: str = "range",
        impl: str | None = None,
        interpret: bool = True,
        impact_dtype: str = "int32",
        docs_format: str = "int32",
        obs=None,
        device=None,
    ):
        from repro_torch.obs import NOOP  # local: obs is import-cycle-free by design

        self.obs = obs if obs is not None else NOOP
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

    @classmethod
    def from_artifact(cls, path: str, **kwargs) -> "Engine":
        """Load a saved index artifact (``repro_torch.index_io``) into an engine.

        ``impact_dtype`` and ``docs_format`` default to how the artifact
        was saved, so an int8/packed artifact serves int8/packed on the
        device unless overridden; ``device`` (default: the card) and the
        other keywords pass through to ``Engine``.
        """
        from repro_torch import index_io  # local: index_io sits above core

        index = index_io.load_index(path)
        manifest = index_io.read_manifest(path)
        kwargs.setdefault("impact_dtype", manifest["impact_dtype"])
        kwargs.setdefault("docs_format", manifest.get("docs_format", "int32"))
        return cls(index, **kwargs)

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
        # defeats safe termination (``ordered_bounds_host`` saturates).
        return QueryPlan(
            q_terms=q,
            blk_tab_host=np.ascontiguousarray(blk, np.int32),
            rest_tab_host=np.ascontiguousarray(rest, np.int32),
            order_host=order,
            bounds_host=per_range_bound[order].astype(np.int64),
            device=self.device,
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
        """Whole-query traversal to an exit condition (one ``traverse``
        launch under ``impl="cuda"``)."""
        res, row = _device_traverse(
            self.dix,
            plan.blk_tab_host,
            plan.rest_tab_host,
            plan.order_host,
            plan.ordered_bounds_host,
            s_pad=self.s_pad,
            k=self.k,
            budget_postings=budget_postings,
            max_ranges=max_ranges,
            safe_stop=safe_stop,
            prune_blocks=prune_blocks,
            impl=self.impl,
            docs_format=self.docs_format,
        )
        if self.obs.enabled:
            # The reference reads the flags and postings from the device
            # here; the port reads the host row the traversal already read.
            self.obs.count(
                "engine_queries",
                reason=exit_reason(res.exit_safe, res.exit_budget),
            )
            self.obs.observe("engine_postings", row[self.k])
        return res

    # ----------------------------------------------------------------- util
    def topk_docs(self, state: TopKState):
        """(docids, scores) with empty slots stripped, host-side.

        Accepts a single-query [k] state or an [N, k] state; the latter
        returns a per-query list of (docids, scores) pairs.
        """
        if state.ids.ndim == 2:
            return batched_topk_docs(state)
        return topk_docs(state)
