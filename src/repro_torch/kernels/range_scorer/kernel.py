"""The range scorer's CUDA kernels: build, binding and launch wrappers.

``csrc/range_scorer.cu`` holds four kernels written by hand for Hopper
(``sm_90a``):

  * ``range_step`` — one whole range step of the engine (block pruning,
    gather, packed decode, scatter into an on-chip accumulator, range top-k
    and merge into the running state) in one launch; the engine's path,
    fusing both Pallas TPU kernels of the JAX package;
  * ``traverse`` — N queries' whole-query loops in one launch, one CTA per
    lane running ``range_step``'s step from a carry and taking the
    reference's exit decisions on the device; the whole-query and batched
    paths (``core.range_daat.device_traverse``, ``batched_traverse`` and
    ``batched_traverse_resume`` under ``impl="cuda"``);
  * ``scatter_accumulate`` — range-local impact accumulation, the port of
    ``_scatter_kernel``, run by ``ops.score_blocks``;
  * ``unpack_locals`` — decode of bit-packed docid deltas to range-local
    ids, the port of ``_unpack_kernel``, run by ``ops.score_blocks`` under
    ``docs_format="packed"``.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under ``.cache/repro_torch_kernels/`` of the
checkout, keyed by a hash of the source and flags, and loaded with
``ctypes`` (``kernels/_nvcc.py``). Importing this module builds nothing.

Each wrapper takes tensors on one device. On a CPU tensor it returns its
kernel's plain version from ``ref.py``; on a CUDA tensor it launches the
kernel on the current stream or raises — nothing falls back. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``;
``range_step`` and ``traverse`` also expose ``_cache_size()``, the number of
libraries this process has loaded for them (0 or 1), which the profiler of
``repro_torch.obs`` reads as its compile count.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._nvcc import I64, INT, NVCC_FLAGS, PTR, CudaLibrary, find_nvcc
from repro_torch.kernels._nvcc import data_ptr as _ptr
from repro_torch.kernels.range_scorer import ref

__all__ = [
    "CAND_CAP",
    "NVCC_FLAGS",
    "TOP_SHARED_MAX",
    "TOUCHED_CAP",
    "acc_placement",
    "build",
    "find_nvcc",
    "PHASES",
    "range_step",
    "range_step_phases",
    "scatter_accumulate",
    "shared_acc_slots",
    "top_bytes",
    "top_placement",
    "traverse",
    "traverse_phases",
    "unpack_locals",
]

SOURCE = Path(__file__).parent / "csrc" / "range_scorer.cu"
BLOCK = ref.BLOCK
# The placements of range_step and traverse (the source's kCandCap,
# kTouchedCap, kTopSharedMax, kSmemOptIn and kStaticReserve, and its cap_c,
# top_bytes and shared_acc_slots): both take any 1 <= k <= s_pad. The top-k
# scratch (sorted candidate keys, a sorted copy of the state and, in
# traverse, the two states) lies in shared memory up to TOP_SHARED_MAX
# bytes, else in a global scratch; the accumulator (s_pad slots, a
# CAND_CAP survivor list and a TOUCHED_CAP list of touched slots) lies in
# shared memory when it fits beside it, else in a global scratch.
CAND_CAP = 2048
TOUCHED_CAP = 8192
TOP_SHARED_MAX = 98_304
SMEM_OPT_IN = 232_448
STATIC_RESERVE = 20_480
KERNELS = ("range_step", "traverse")

# The phase timer's columns (enum Phase in the source): cycles of thread 0's
# clock64 per phase of the range step, summed over a lane's steps, then the
# number of steps. Only range_step_phases and traverse_phases launch the
# timed variant, and only at int8 impacts, packed docids and the shared
# accumulator.
PHASES = ("decide", "zero", "directory", "scatter", "select", "candidates", "merge",
          "write")

# docs, impacts (and whether int8), block rows, packed stream and directory.
_INDEX_ARGTYPES = (PTR, I64, PTR, I64, INT, PTR, PTR, PTR, PTR, I64, PTR, PTR, INT)

_LIB = CudaLibrary(
    SOURCE,
    {
        "rs_scatter_accumulate": [PTR, PTR, I64, PTR, I64, PTR],
        "rs_unpack_locals": [PTR, I64, PTR, PTR, PTR, PTR, PTR, PTR, I64, PTR, PTR],
        "rs_range_step": [
            *_INDEX_ARGTYPES,
            PTR, PTR, I64, PTR, PTR, PTR, PTR, PTR, I64, I64, INT, PTR, PTR, PTR, PTR, PTR,
        ],
        "rs_traverse": [
            *_INDEX_ARGTYPES,
            PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
            I64, I64, I64, I64, I64, I64, INT, INT, PTR, PTR,
            I64, I64, I64, I64, I64, PTR, PTR,
        ],
    },
    error_fn="rs_error_string",
)


def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: (library path, seconds, compiler log)."""
    return _LIB.build()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")


def _same_device(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` on ``device``'s current stream.

    A device context is opened only when ``device`` is not the current one.
    """
    if device.index == torch.cuda.current_device():
        _LIB.launch(fn, *args, torch.cuda.current_stream().cuda_stream)
        return
    with torch.cuda.device(device):
        _LIB.launch(fn, *args, torch.cuda.current_stream().cuda_stream)


def scatter_accumulate(ids: torch.Tensor, vals: torch.Tensor, s_pad: int) -> torch.Tensor:
    """acc[s] = sum of vals at ids == s, for s in [0, s_pad); int32 [s_pad].

    ``ids`` and ``vals`` are int32 [P]; ids < 0 or >= s_pad are dropped.
    """
    _check(ids, "ids", torch.int32, 1)
    _check(vals, "vals", torch.int32, 1)
    if ids.shape != vals.shape:
        raise ValueError(f"ids {tuple(ids.shape)} and vals {tuple(vals.shape)} differ")
    s_pad = int(s_pad)
    if s_pad <= 0:
        raise ValueError(f"s_pad must be positive, got {s_pad}")
    if ids.device.type == "cpu":
        return ref.scatter_accumulate_ref(ids, vals, s_pad)
    if ids.device.type != "cuda":
        raise ValueError(f"scatter_accumulate runs on cuda or cpu, not {ids.device}")
    _same_device(ids.device, vals=vals)
    acc = torch.zeros(s_pad, dtype=torch.int32, device=ids.device)
    if ids.numel() == 0:
        return acc
    _launch("rs_scatter_accumulate", ids.device,
            _ptr(ids), _ptr(vals), ids.numel(), _ptr(acc), s_pad)
    scatter_accumulate.launches += 1
    return acc


scatter_accumulate.launches = 0


def unpack_locals(
    pack_words: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    pack_dir: torch.Tensor,
    pack_firsts: torch.Tensor,
    keep: torch.Tensor,
    range_start,
) -> torch.Tensor:
    """Decode packed blocks to [B*BLOCK] range-local ids (-1 invalid).

    ``pack_words`` is the int32 tensor carrying the uint32 delta stream;
    ``starts``, ``lens``, ``pack_dir`` and ``pack_firsts`` are int32 [B],
    ``keep`` is bool [B], and ``range_start`` a 0-d int32 tensor (or int).
    """
    _check(pack_words, "pack_words", torch.int32, 1)
    B = starts.shape[0] if isinstance(starts, torch.Tensor) else -1
    for name, t in (("starts", starts), ("lens", lens), ("pack_dir", pack_dir),
                    ("pack_firsts", pack_firsts)):
        _check(t, name, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, starts has {B}")
    _check(keep, "keep", torch.bool, 1)
    if keep.shape[0] != B:
        raise ValueError(f"keep has {keep.shape[0]} rows, starts has {B}")
    device = starts.device
    if not isinstance(range_start, torch.Tensor):
        range_start = torch.tensor(int(range_start), dtype=torch.int32, device=device)
    _check(range_start, "range_start", torch.int32, 0)
    if device.type == "cpu":
        return ref.unpack_locals_ref(
            pack_words, starts, lens, pack_dir, pack_firsts, keep, range_start
        )
    if device.type != "cuda":
        raise ValueError(f"unpack_locals runs on cuda or cpu, not {device}")
    _same_device(
        device, pack_words=pack_words, lens=lens, pack_dir=pack_dir,
        pack_firsts=pack_firsts, keep=keep, range_start=range_start,
    )
    out = torch.empty(B * BLOCK, dtype=torch.int32, device=device)
    if B == 0:
        return out
    _launch("rs_unpack_locals", device,
            _ptr(pack_words), pack_words.numel(), _ptr(starts), _ptr(lens),
            _ptr(pack_dir), _ptr(pack_firsts), _ptr(keep), _ptr(range_start),
            B, _ptr(out))
    unpack_locals.launches += 1
    return out


unpack_locals.launches = 0


def _is_traverse(kernel: str) -> bool:
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r} not in {KERNELS}")
    return kernel == "traverse"


def top_bytes(k: int, kernel: str = "range_step") -> int:
    """Bytes of ``kernel``'s top-k scratch at k (per lane for ``traverse``):
    next_pow2(max(k, 32)) candidate keys, a sorted state copy and, in
    ``traverse``, the two states."""
    traverse = _is_traverse(kernel)
    k = int(k)
    cap = max(32, 1 << (k - 1).bit_length())
    return 8 * cap + 8 * k + (8 * (2 * k + 2) if traverse else 0)


def top_placement(k: int, kernel: str = "range_step") -> str:
    """Where ``kernel`` keeps its top-k scratch: ``"shared"`` or ``"global"``."""
    return "shared" if top_bytes(k, kernel) <= TOP_SHARED_MAX else "global"


def shared_acc_slots(k: int, kernel: str = "range_step") -> int:
    """The largest ``s_pad`` whose accumulator ``kernel`` keeps in shared
    memory at k: what the opt-in limit leaves beside the static memory, the
    top-k scratch (when it is shared) and the two slot lists."""
    top = top_bytes(k, kernel) if top_placement(k, kernel) == "shared" else 0
    return (SMEM_OPT_IN - STATIC_RESERVE - top) // 4 - CAND_CAP - TOUCHED_CAP


def acc_placement(s_pad: int, kernel: str = "range_step", k: int = 10) -> str:
    """Where ``kernel`` keeps its accumulator at k: ``"shared"`` or ``"global"``."""
    return "shared" if int(s_pad) <= shared_acc_slots(k, kernel) else "global"


def _scratch(kernel: str, s_pad: int, k: int, shape: tuple, device) -> tuple:
    """(accumulator, top-k) global scratch of ``kernel``, None where shared;
    ``shape`` is () for ``range_step``, (N,) for ``traverse``'s lanes."""
    acc = None if acc_placement(s_pad, kernel, k) == "shared" else torch.empty(
        (*shape, s_pad + CAND_CAP + TOUCHED_CAP), dtype=torch.int32, device=device)
    top = None if top_placement(k, kernel) == "shared" else torch.empty(
        (*shape, top_bytes(k, kernel) // 8), dtype=torch.int64, device=device)
    return acc, top


def _check_k(name: str, s_pad: int, k: int) -> None:
    if not 1 <= k <= s_pad:
        raise ValueError(f"{name} takes 1 <= k <= s_pad = {s_pad}, got k={k}")


def _index_tensors(dix, docs_format: str, ndim: int = 1) -> tuple:
    """(name, tensor, ndim) of the index columns a step reads, dtype-checked.

    ``ndim`` is 2 for an index of stacked shards (``traverse``)."""
    if docs_format not in ref.DOCS_FORMATS:
        raise ValueError(f"docs_format {docs_format!r} not in {ref.DOCS_FORMATS}")
    if dix.impacts.dtype not in (torch.int32, torch.int8):
        raise TypeError(f"dix.impacts must be int32 or int8, got {dix.impacts.dtype}")
    if dix.impacts.dim() != ndim:
        raise ValueError(f"dix.impacts must have {ndim} dims, got shape "
                         f"{tuple(dix.impacts.shape)}")
    docs = (("dix.pack_words", dix.pack_words, ndim), ("dix.pack_dir", dix.pack_dir, ndim),
            ("dix.pack_first", dix.pack_first, ndim)) if docs_format == "packed" else (
        ("dix.docs", dix.docs, ndim),)
    return (("dix.blk_start", dix.blk_start, ndim), ("dix.blk_len", dix.blk_len, ndim),
            ("dix.blk_maximp", dix.blk_maximp, ndim), *docs)


def _check_all(tensors, docs_format: str) -> None:
    for name, t, ndim in tensors:
        if t is None:
            raise ValueError(f"docs_format={docs_format!r} needs {name}")
        _check(t, name, torch.int32, ndim)


def _check_on(device: torch.device, dix, tensors) -> None:
    # get_device() is an int: cheaper than comparing torch.device objects.
    index = device.index
    for name, t, _ in (*tensors, ("dix.impacts", dix.impacts, 1)):
        if t.get_device() != index:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _index_args(dix, packed: bool) -> tuple:
    """The index arguments both entry points take, in their order: a
    column's length is its row width (the whole column when unstacked)."""
    return (
        0 if packed else _ptr(dix.docs), 0 if packed else dix.docs.shape[-1],
        _ptr(dix.impacts), dix.impacts.shape[-1], int(dix.impacts.dtype == torch.int8),
        _ptr(dix.blk_start), _ptr(dix.blk_len), _ptr(dix.blk_maximp),
        _ptr(dix.pack_words) if packed else 0, dix.pack_words.shape[-1] if packed else 0,
        _ptr(dix.pack_dir) if packed else 0, _ptr(dix.pack_first) if packed else 0,
        int(packed),
    )


def _shard_strides(dix, tensors) -> tuple:
    """(docs, impacts, block columns, packed words) row widths of a stacked
    index (its rows are contiguous: ``data_ptr`` checks); all 0 unstacked."""
    if dix.range_starts.dim() == 1:
        return (0, 0, 0, 0)
    n_shards = dix.range_starts.shape[0]
    cols = {name: t for name, t, _ in (*tensors, ("dix.impacts", dix.impacts, 2))
            if name.startswith("dix.")}
    for name, t in cols.items():
        if t.shape[0] != n_shards:
            raise ValueError(f"{name} has {t.shape[0]} shard rows, dix.range_starts "
                             f"{n_shards}")
    blk = {cols[n].shape[1] for n in ("dix.blk_start", "dix.blk_len", "dix.blk_maximp",
                                       "dix.pack_dir", "dix.pack_first") if n in cols}
    if len(blk) != 1:
        raise ValueError(f"the stacked block columns differ in width: {sorted(blk)}")
    words = cols.get("dix.pack_words")
    docs = cols.get("dix.docs")
    return (0 if docs is None else docs.shape[1], dix.impacts.shape[1], blk.pop(),
            0 if words is None else words.shape[1])


def _timed_on_card(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} times the kernel and runs on the card only, not {device}")


def _range_step(dix, state, blk_ids, rest, range_start, s_pad, k, prune_blocks,
                docs_format, timing) -> tuple[ref.TopKState, bool]:
    """``range_step``'s checks and launch: (new state, whether it launched)."""
    s_pad, k = int(s_pad), int(k)
    _check_k("range_step", s_pad, k)
    tensors = (
        ("blk_ids", blk_ids, 1), ("rest", rest, 1), ("range_start", range_start, 0),
        ("state.vals", state.vals, 1), ("state.ids", state.ids, 1),
        ("state.postings", state.postings, 0), ("state.blocks", state.blocks, 0),
        *_index_tensors(dix, docs_format),
    )
    _check_all(tensors, docs_format)
    if rest.shape != blk_ids.shape:
        raise ValueError(f"rest {tuple(rest.shape)} and blk_ids {tuple(blk_ids.shape)} differ")
    if state.vals.shape[0] != k or state.ids.shape[0] != k:
        raise ValueError(f"state holds {state.vals.shape[0]} slots, k is {k}")
    device = blk_ids.device
    if device.type == "cpu":
        return ref.range_step_ref(dix, state, blk_ids, rest, range_start, s_pad=s_pad,
                                  k=k, prune_blocks=prune_blocks,
                                  docs_format=docs_format), False
    if device.type != "cuda":
        raise ValueError(f"range_step runs on cuda or cpu, not {device}")
    _check_on(device, dix, tensors)
    out = torch.empty(2 * k + 2, dtype=torch.int32, device=device)
    acc, top = _scratch("range_step", s_pad, k, (), device)
    _launch(
        "rs_range_step", device, *_index_args(dix, docs_format == "packed"),
        _ptr(blk_ids), _ptr(rest), blk_ids.numel(), _ptr(range_start),
        _ptr(state.vals), _ptr(state.ids), _ptr(state.postings), _ptr(state.blocks),
        k, s_pad, int(bool(prune_blocks)), 0 if acc is None else _ptr(acc),
        0 if top is None else _ptr(top), _ptr(out), 0 if timing is None else _ptr(timing),
    )
    return ref.state_views(out, k), True


def range_step(
    dix,
    state: ref.TopKState,
    blk_ids: torch.Tensor,
    rest: torch.Tensor,
    range_start: torch.Tensor,
    *,
    s_pad: int,
    k: int,
    prune_blocks: bool = True,
    docs_format: str = "int32",
) -> ref.TopKState:
    """One range step of the engine in one launch; see ``ref.range_step_ref``.

    ``dix`` is the engine's ``core.range_daat.DeviceIndex``; ``blk_ids`` and
    ``rest`` are int32 [B] (-1 padded ids), ``range_start`` is 0-d int32,
    and the state's fields are int32 (``vals``/``ids`` [k], counters 0-d).
    The new state is a fresh buffer laid out as ``ref.state_views``.
    Raises for k outside [1, s_pad].
    """
    new, launched = _range_step(dix, state, blk_ids, rest, range_start, s_pad, k,
                                prune_blocks, docs_format, None)
    if launched:
        range_step.launches += 1
    return new


range_step.launches = 0
range_step._cache_size = _LIB.programs


def range_step_phases(dix, state, blk_ids, rest, range_start, *, s_pad: int, k: int,
                      prune_blocks: bool = True,
                      docs_format: str = "packed") -> tuple[ref.TopKState, torch.Tensor]:
    """``range_step``'s timed variant on the card: (new state, int64 clocks).

    The clocks are ``PHASES``' cycles and the step count, ``[len(PHASES) + 1]``.
    Int8 impacts, packed docids and the shared accumulator only; the launch
    is not counted in ``range_step.launches``.
    """
    _timed_on_card("range_step_phases", blk_ids.device)
    timing = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=blk_ids.device)
    new, _ = _range_step(dix, state, blk_ids, rest, range_start, s_pad, k, prune_blocks,
                         docs_format, timing)
    return new, timing


def traverse(
    dix,
    blk_tab: torch.Tensor,
    rest_tab: torch.Tensor,
    order: torch.Tensor,
    ordered_bounds: torch.Tensor,
    budget: torch.Tensor,
    maxr: torch.Tensor,
    carry: torch.Tensor,
    *,
    s_pad: int,
    k: int,
    quantum: int | None = None,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    docs_format: str = "int32",
    timer=None,
) -> torch.Tensor:
    """N lanes' whole-query loops in one launch; see ``ref.traverse_ref``.

    ``blk_tab``/``rest_tab`` are int32 [N, R, B], ``order``/``ordered_bounds``
    int32 [N, R], ``budget``/``maxr`` int32 [N], and ``carry`` the int32
    [N, 2k+5] carry in (``vals[k] | postings | blocks | ids[k] | i |
    exit_safe | exit_budget`` per lane); ``dix.range_starts`` has R entries.
    Returns the carry out, a fresh buffer of the same layout. ``quantum``
    (None: run to an exit) caps each lane's loop iterations. Raises for k
    outside [1, s_pad].

    ``dix`` may be S range shards stacked row by row (every column
    ``[S, W]``, ``range_starts`` ``[S, R]``): lane n then reads shard
    n % S, so N = N_queries * S lanes in the reference's [N, S] row-major
    order run every (query, shard) pair in one launch.

    A ``timer`` (``core.range_daat.DeviceTimer``, the profiler's) records
    its two events on the stream right around the launch.
    """
    out, launched = _traverse(dix, blk_tab, rest_tab, order, ordered_bounds, budget, maxr,
                              carry, s_pad, k, quantum, safe_stop, prune_blocks,
                              docs_format, None, timer)
    if launched:
        traverse.launches += 1
    return out


traverse.launches = 0
traverse._cache_size = _LIB.programs


def traverse_phases(dix, blk_tab, rest_tab, order, ordered_bounds, budget, maxr, carry, *,
                    s_pad: int, k: int, quantum: int | None = None, safe_stop: bool = True,
                    prune_blocks: bool = True,
                    docs_format: str = "packed") -> tuple[torch.Tensor, torch.Tensor]:
    """``traverse``'s timed variant on the card: (carry out, int64 clocks).

    The clocks are ``[N, len(PHASES) + 1]``: per lane, ``PHASES``' cycles
    summed over its steps, then its scored steps. Int8 impacts, packed
    docids and the shared accumulator only; not counted in
    ``traverse.launches``.
    """
    _timed_on_card("traverse_phases", carry.device)
    timing = torch.zeros((blk_tab.shape[0], len(PHASES) + 1), dtype=torch.int64,
                         device=carry.device)
    out, _ = _traverse(dix, blk_tab, rest_tab, order, ordered_bounds, budget, maxr, carry,
                       s_pad, k, quantum, safe_stop, prune_blocks, docs_format, timing)
    return out, timing


def _traverse(dix, blk_tab, rest_tab, order, ordered_bounds, budget, maxr, carry, s_pad,
              k, quantum, safe_stop, prune_blocks, docs_format,
              timing, timer=None) -> tuple[torch.Tensor, bool]:
    """``traverse``'s checks and launch: (carry out, whether it launched)."""
    s_pad, k = int(s_pad), int(k)
    _check_k("traverse", s_pad, k)
    if quantum is not None and not 0 <= int(quantum) <= ref.INT32_MAX:
        raise ValueError(f"quantum must be None or in [0, 2^31), got {quantum}")
    if not isinstance(dix.range_starts, torch.Tensor):
        raise TypeError("dix.range_starts must be a torch.Tensor")
    stacked = dix.range_starts.dim() == 2
    n_shards = int(dix.range_starts.shape[0]) if stacked else 1
    ndim = 2 if stacked else 1
    tensors = (
        ("blk_tab", blk_tab, 3), ("rest_tab", rest_tab, 3), ("order", order, 2),
        ("ordered_bounds", ordered_bounds, 2), ("budget", budget, 1), ("maxr", maxr, 1),
        ("carry", carry, 2), ("dix.range_starts", dix.range_starts, ndim),
        *_index_tensors(dix, docs_format, ndim),
    )
    _check_all(tensors, docs_format)
    N, R, B = blk_tab.shape
    want = {"rest_tab": (N, R, B), "order": (N, R), "ordered_bounds": (N, R),
            "budget": (N,), "maxr": (N,), "carry": (N, ref.carry_width(k)),
            "dix.range_starts": (n_shards, R) if stacked else (R,)}
    for name, t, _ in tensors:
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]} "
                             f"(N={N}, R={R}, B={B}, k={k})")
    if R == 0:
        raise ValueError("traverse needs at least one range")
    if n_shards < 1 or N % n_shards:
        raise ValueError(f"{N} lanes do not divide into {n_shards} shards")
    kw = dict(s_pad=s_pad, k=k, quantum=None if quantum is None else int(quantum),
              safe_stop=bool(safe_stop), prune_blocks=bool(prune_blocks),
              docs_format=docs_format)
    device = carry.device
    if device.type == "cpu":
        return ref.traverse_ref(dix, blk_tab, rest_tab, order, ordered_bounds, budget,
                                maxr, carry, **kw), False
    if device.type != "cuda":
        raise ValueError(f"traverse runs on cuda or cpu, not {device}")
    _check_on(device, dix, tensors)
    strides = _shard_strides(dix, tensors)
    out = torch.empty_like(carry)
    if N == 0:
        return out, False
    acc, top = _scratch("traverse", s_pad, k, (N,), device)
    args = (
        *_index_args(dix, docs_format == "packed"),
        _ptr(dix.range_starts), _ptr(blk_tab), _ptr(rest_tab), _ptr(order),
        _ptr(ordered_bounds), _ptr(budget), _ptr(maxr), _ptr(carry), _ptr(out),
        N, R, B, k, s_pad, -1 if quantum is None else int(quantum),
        int(kw["safe_stop"]), int(kw["prune_blocks"]), 0 if acc is None else _ptr(acc),
        0 if top is None else _ptr(top), n_shards, *strides,
        0 if timing is None else _ptr(timing),
    )
    if timer is not None:
        timer.start()
    _launch("rs_traverse", device, *args)
    if timer is not None:
        timer.stop()
    return out, True
