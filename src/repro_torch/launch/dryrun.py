"""Dry run: every (arch x shape x mesh) cell's step on shapes alone.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell with ``ShapeDtypeStruct`` inputs on 512 host
placeholder devices. Here, for each cell:

  1. this process becomes rank 0 of a group of 512 ranks under torch's
     ``fake`` backend (``sharding.init_fake_group``), and the production
     mesh (16 x 16, or 2 x 16 x 16 multi-pod) is laid over it;
  2. the arch's full published config, its parameter specs (TP/EP by
     ``param_pspecs``; an ``fsdp`` arch's baseline also FSDP by
     ``trainer.fsdp_param_specs``), the ZeRO-1 optimizer state
     (``trainer.init_zero1_state``, the layout of ``zero1_state_specs``)
     and the batch (``batch_pspecs``) give rank 0's blocks, as fake tensors
     (``FakeTensorMode``: shapes, types and a device, no memory);
  3. one call of ``build_step(cfg, shape, shard_ctx=ctx)``: for a train
     shape forward, backward and the AdamW update. Collectives return at
     once on the fake group and the kernels' callers return their output
     shapes (``kernels._abstract``).

Each cell records the reference's keys:

  * ``memory``: ``argument_size_in_bytes`` (rank 0's blocks of the
    parameters, optimizer state and batch, from their specs; those the
    step reads, as XLA's ``memory_analysis`` counts a jitted step that
    drops its unused arguments; ``arguments`` keeps every block's bytes
    by part),
    ``output_size_in_bytes`` (the step's outputs, aliased arguments
    included, as XLA counts donated outputs), ``temp_size_in_bytes`` (the
    most bytes live above the arguments during the step: every storage a
    dispatched op creates, counted until it is freed) and
    ``peak_memory_in_bytes`` (arguments + temp). Raw tensor bytes: the
    caching allocator's rounding and fragmentation are not modelled;
  * ``per_device_flops``: ``torch.utils.flop_counter.FlopCounterMode``
    over the whole step (every loop trip and the remat recomputation,
    which XLA's CPU cost analysis counts once);
  * ``per_device_bytes_accessed``: the input plus output bytes of every
    aten op but views, allocations and metadata queries (a fill counts its
    output only), and each hand-written kernel's inputs once (its shape
    rule reads no data): an unfused upper bound (a fused kernel reads its
    inputs once and writes its outputs once);
  * ``collectives``: ``bytes_by_kind``, ``count_by_kind`` and
    ``total_bytes``: the bytes that land on rank 0 in the port's
    ``sharding`` collectives (``sharding.collective_census``);
  * ``model_flops_per_token`` and, new, ``kernel_launches``: the hand
    written kernels the step would launch on the card, by name.

A cell that raises writes ``ok: false`` with the error and makes the run
exit 1. Results go to ``chiprun_out/dryrun/<arch>__<shape>__<mesh>
[__v-<variant>].json``; ``launch/roofline.py`` reads them.

Usage (the fake tensors are card tensors and a card is needed, unless
``--device cpu`` asks for CPU ones, whose records the roofline skips;
``--jobs`` runs cells in that many worker processes):

  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh both --perf-variants --device cpu \\
      --jobs 4 [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import multiprocessing
import os
import sys
import time
import traceback
import weakref

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.kernels._abstract import launch_census, launch_inputs
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import fsdp_param_specs, init_zero1_state

__all__ = ["RESULTS_DIR", "WORLD", "PERF_VARIANTS", "Cell", "ensure_fake_group",
           "measure_step", "block_shape", "prepare_cell", "argument_bytes", "run_cell",
           "sweep_cells", "run_cells", "main"]

RESULTS_DIR = os.path.join("chiprun_out", "dryrun")
WORLD = 512  # the multi-pod mesh; the single-pod one is its first 256 ranks
# The six cells the reference's deliverable test holds to one device's memory.
PERF_VARIANTS = (
    ("deepseek-67b", "decode_32k", "single", "split_kv"),
    ("deepseek-v3-671b", "decode_32k", "single", "split_kv"),
    ("deepseek-67b", "prefill_32k", "single", "split_kv"),
    ("graphsage-reddit", "ogb_products", "single", "sharded"),
    ("anytime-ir", "serve_anytime", "single", "i8"),
    ("deepseek-v3-671b", "train_4k", "single", "baseline"),
)


def ensure_fake_group(world: int = WORLD, device="cuda"):
    """This process as rank 0 of a fake group of at least ``world`` ranks
    (one of ``max(world, WORLD)`` is brought up if there is none); raises
    beside a real group."""
    rt = sh.runtime()
    if rt is None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda fakes card tensors and needs a card; "
                               "pass --device cpu")
        return sh.init_fake_group(max(world, WORLD), dev)
    if rt.backend != "fake" or rt.world < world:
        raise RuntimeError(f"a dry run needs a fake group of {world} ranks, "
                           f"have {rt.backend} x {rt.world}")
    return rt


# --------------------------------------------------------------------------
# What a step holds and moves
# --------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# Ops that move no data (allocations, metadata), and ops that only write.
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
_WRITE_ONLY = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "fill_", "zero_", "arange"}


class _Meter(TorchDispatchMode):
    """Live bytes of the storages the dispatched ops create (their peak),
    the bytes each op that moves data reads and writes, and which of the
    held (argument) storages an op or a kernel read."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._seen = WeakIdKeyDictionary()
        self._held: dict = {}  # id(storage) -> [storage, read by an op]

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def hold(self, tree) -> None:
        """Count nothing for the storages under ``tree`` (the arguments):
        ops that view or update them in place create no memory. Which of
        them an op reads is recorded (``unread``)."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = weakref.ref(st)
            self._held.setdefault(id(st), [st, False])

    def kernel_inputs(self, tree) -> None:
        """A hand-written kernel's inputs (its shape rule's): read, each
        once, so the held storages under ``tree`` are read."""
        for t in _tensors(tree):
            self.accessed += _nbytes(t)
            hit = self._held.get(id(t.untyped_storage()))
            if hit is not None:
                hit[1] = True

    def unread(self) -> int:
        """Bytes of the held storages no op read."""
        return sum(st.nbytes() for st, read in self._held.values() if not read)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = weakref.ref(st, functools.partial(self._free, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        name = func._opname
        if not func.is_view and func.namespace != "prim" and name not in _NO_DATA:
            self.accessed += sum(map(_nbytes, outs))
            if name not in _WRITE_ONLY:  # the op reads its inputs
                for a in tree_leaves((args, kwargs)):
                    if isinstance(a, torch.Tensor):
                        self.accessed += _nbytes(a)
                        hit = self._held.get(id(a.untyped_storage()))
                        if hit is not None:
                            hit[1] = True
        for o in outs:
            self._track(o)
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _unique_bytes(tree) -> int:
    """Bytes of the storages under ``tree`` (tensors, ``Params``, dicts,
    sequences, dataclasses), each storage once."""
    stores = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        stores.setdefault(id(st), st)
    return sum(st.nbytes() for st in stores.values())


def measure_step(step, args, argument_bytes: int | None = None) -> dict:
    """Run ``step(*args)`` once on fake tensors (the caller's
    ``FakeTensorMode`` is active) and return the dry run's record of it:
    memory, FLOPs, bytes accessed, collectives and kernel launches.
    (``run_cell`` adds ``arguments``, the argument bytes by part.)
    ``argument_bytes`` defaults to the bytes of the arguments' tensors."""
    if argument_bytes is None:
        argument_bytes = _unique_bytes(args)
    meter, flops = _Meter(), FlopCounterMode(display=False)
    meter.hold(args)
    with sh.collective_census() as coll, launch_census() as launches:
        with flops, meter:
            out = step(*args)
        meter.kernel_inputs(launch_inputs())
    out_bytes = _unique_bytes(out)
    del out
    # As XLA's memory analysis with jit's keep_unused=False: the arguments
    # the step reads (a serve step never reads a training-only leaf).
    argument_bytes -= meter.unread()
    return {
        "memory": {
            "argument_size_in_bytes": int(argument_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(meter.peak),
            "peak_memory_in_bytes": int(argument_bytes + meter.peak),
        },
        "per_device_flops": float(flops.get_total_flops()),
        "per_device_bytes_accessed": float(meter.accessed),
        "collectives": {
            "bytes_by_kind": dict(coll["bytes_by_kind"]),
            "count_by_kind": dict(coll["count_by_kind"]),
            "total_bytes": int(sum(coll["bytes_by_kind"].values())),
        },
        "kernel_launches": dict(launches),
    }


# --------------------------------------------------------------------------
# One cell
# --------------------------------------------------------------------------


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a global ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec.spec if isinstance(spec, sh.NamedSharding)
                                    else spec)):
        n = int(np.prod([sh._size(mesh, a) for a in sh._axes(entry)] or [1]))
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split over "
                             f"{entry} ({n})")
        out[d] //= n
    return tuple(out)


def _block_bytes(tree, specs, mesh) -> int:
    n = 0

    def one(x, s):
        nonlocal n
        n += int(np.prod(block_shape(x.shape, s, mesh))) * x.element_size()
        return x

    sh._map_tree(one, tree, specs)
    return n


def _fake_blocks(tree, specs, mesh, dev):
    def one(x, s):
        return torch.empty(block_shape(x.shape, s, mesh), dtype=x.dtype, device=dev)

    return sh._map_tree(one, tree, specs)


_IR_FIELDS = ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
              "doc_base")


def _ir_arrays(arrays, dev):
    """An ``anytime-ir`` index's arrays, global, as fake tensors: the mesh
    step takes them whole and hands each rank its shard."""
    return dataclasses.replace(arrays, **{
        f: torch.empty(getattr(arrays, f).shape, dtype=getattr(arrays, f).dtype, device=dev)
        for f in _IR_FIELDS})


@dataclasses.dataclass
class Cell:
    """A cell ready to run: its step, kind and fake arguments (made under
    the caller's ``FakeTensorMode``), rank 0's argument bytes, the mesh."""

    arch: object
    cfg: object
    step: object
    kind: str
    args: tuple
    argument_bytes: int
    mesh: object
    device: torch.device
    parts: dict  # argument bytes by part: params, batch (and moments, step)


def prepare_cell(arch_name: str, shape: str, mesh_kind: str = "single",
                 variant: str = "baseline", *, device="cuda", reduced: bool = False,
                 mesh_shape: tuple | None = None, cfg=None, batch_shapes=None) -> Cell:
    """Build a cell's step and rank 0's fake blocks (call it under a
    ``FakeTensorMode``). ``reduced`` takes the arch's reduced config and
    ``mesh_shape`` a (data, model) mesh of that shape in place of the
    production one; ``cfg`` and ``batch_shapes`` (meta tensors) override
    the config and the batch."""
    arch = get_arch(arch_name)
    dev = torch.device(device)
    with unset_fake_temporarily():  # a mesh reads its real rank layout
        if mesh_shape is not None:
            ensure_fake_group(int(np.prod(mesh_shape)), dev)
            mesh = sh.make_mesh(tuple(mesh_shape),
                                ("pod", "data", "model")[-len(mesh_shape):])
        else:
            ensure_fake_group(WORLD, dev)
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    ctx = make_ctx(mesh)
    if cfg is None:
        cfg = arch.model_config(reduced=reduced)
        if arch.family == "gnn":
            cfg = arch._resolved(cfg, shape)
        if hasattr(arch, "_with_variant"):
            cfg = arch._with_variant(cfg, variant)
        if arch.family == "ir" and reduced:  # a shard per model rank, a query per data rank
            cfg = dict(cfg, n_shards=ctx.n_model,
                       n_queries=max(cfg["n_queries"], ctx.n_data))

    params_sh = arch.param_shapes(cfg)
    if variant != "baseline":
        if variant not in getattr(arch, "variants", ("baseline",)):
            raise ValueError(f"{arch_name} does not support variant {variant}")
        p_specs = arch.param_pspecs(cfg, params_sh, variant=variant, ctx=ctx)
        step, kind = arch.build_step(cfg, shape, shard_ctx=ctx, variant=variant)
        try:
            batch_sh = arch.input_specs(cfg, shape, variant=variant)
        except TypeError:
            batch_sh = arch.input_specs(cfg, shape)
        b_specs = arch.batch_pspecs(cfg, shape, ctx, variant=variant)
    else:
        p_specs = arch.param_pspecs(cfg, params_sh)
        if getattr(arch, "fsdp", False):
            p_specs = fsdp_param_specs(arch, cfg, p_specs, params_sh, ctx)
            ctx = dataclasses.replace(ctx, fsdp_specs=p_specs)
        step, kind = arch.build_step(cfg, shape, shard_ctx=ctx)
        batch_sh = arch.input_specs(cfg, shape)
        b_specs = arch.batch_pspecs(cfg, shape, ctx)
    if batch_shapes is not None:
        batch_sh = batch_shapes

    is_ir = arch.family == "ir"
    parts = {"batch": _block_bytes(batch_sh, b_specs, mesh)}
    if is_ir:
        fields = [f for f in _IR_FIELDS if isinstance(getattr(params_sh, f), torch.Tensor)]
        parts["params"] = _block_bytes([getattr(params_sh, f) for f in fields],
                                       [getattr(p_specs, f) for f in fields], mesh)
        # the mesh step takes the global arrays and tables, each rank its block
        params = _ir_arrays(params_sh, dev)
        batch = {"tables": tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                                 for t in batch_sh["tables"])}
    else:
        parts["params"] = _block_bytes(params_sh, p_specs, mesh)
        params = _fake_blocks(params_sh, p_specs, mesh, dev)
        batch = _fake_blocks(batch_sh, b_specs, mesh, dev)
        if "pos" in batch:  # the fill position is a host int, as make_batch's
            seg = next(iter(batch_sh["cache"].values()))
            batch["pos"] = np.int32(next(iter(seg.values())).shape[2] // 2)
    if kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=arch.moment_dtype(cfg))
        opt = init_zero1_state(params, opt_cfg, p_specs, ctx)
        parts["moments"] = _unique_bytes([opt["m"], opt["v"]])
        parts["step"] = _unique_bytes(opt["step"])
        args = (params, opt, batch)
    else:
        args = (params, batch)
    return Cell(arch, cfg, step, kind, args, sum(parts.values()), mesh, dev, parts)


def argument_bytes(arch_name: str, shape: str, mesh_kind: str = "single",
                   variant: str = "baseline", **kw) -> int:
    """Rank 0's argument bytes of a cell, without running its step."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        return prepare_cell(arch_name, shape, mesh_kind, variant, **kw).argument_bytes


def run_cell(arch_name: str, shape: str, mesh_kind: str = "single",
             variant: str = "baseline", **kw) -> dict:
    """One cell's record (``ok: true``; raises on failure); the keywords
    are ``prepare_cell``'s."""
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = prepare_cell(arch_name, shape, mesh_kind, variant, **kw)
        rec = measure_step(cell.step, cell.args, cell.argument_bytes)
        del cell.args
    mesh_shape = kw.get("mesh_shape")
    result = {
        "arch": arch_name,
        "shape": shape,
        "mesh": mesh_kind if mesh_shape is None else "x".join(map(str, mesh_shape)),
        "variant": variant,
        "kind": cell.kind,
        "n_devices": int(cell.mesh.mesh.numel()),
        "device": cell.device.type,
        "ok": True,
        "trace_s": round(time.time() - t0, 2),
        **rec,
        "arguments": dict(cell.parts),
        "model_flops_per_token": cell.arch.model_flops_per_token(cell.cfg),
    }
    mem = result["memory"]
    print(f"[{arch_name}/{shape}/{result['mesh']}{'' if variant == 'baseline' else '/' + variant}]"
          f" args {mem['argument_size_in_bytes'] / 2**30:.3f} GiB, peak "
          f"{mem['peak_memory_in_bytes'] / 2**30:.3f} GiB, flops "
          f"{result['per_device_flops']:.3e}, collective bytes "
          f"{result['collectives']['total_bytes']:.3e}, launches "
          f"{result['kernel_launches']}, {result['trace_s']} s", flush=True)
    return result


# --------------------------------------------------------------------------
# Many cells
# --------------------------------------------------------------------------


def _cell_path(out_dir: str, arch: str, shape: str, mesh: str, variant: str) -> str:
    suffix = "" if variant == "baseline" else f"__v-{variant}"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def _run_and_write(job) -> tuple:
    arch, shape, mesh, variant, device, out_dir = job
    try:
        torch.set_num_threads(1)
        res = run_cell(arch, shape, mesh, variant=variant, device=device)
    except Exception as e:  # noqa: BLE001: record and continue
        traceback.print_exc()
        res = {"arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
               "ok": False, "error": f"{type(e).__name__}: {e}"}
    path = _cell_path(out_dir, arch, shape, mesh, variant)
    with open(path + ".tmp", "w") as f:
        json.dump(res, f, indent=1)
    os.replace(path + ".tmp", path)
    return (arch, shape, mesh, variant), res["ok"]


_SLOW = ("deepseek-v3-671b", "deepseek-67b", "moonshot-v1-16b-a3b", "qwen3-4b", "qwen2.5-3b")


def sweep_cells(meshes=("single", "multi"), perf_variants: bool = True) -> list:
    """Every (arch, shape) cell on each of ``meshes``, and the five
    non-baseline ``PERF_VARIANTS`` (the sixth is a baseline cell), the
    slowest first (the LMs' train and prefill steps), so that a pool of
    workers ends together."""
    cells = [(a, s, m, "baseline") for a, s, _ in all_cells() for m in meshes]
    if perf_variants:
        cells += [c for c in PERF_VARIANTS if c[3] != "baseline" and c[2] in meshes]
    def cost(c):
        rank = _SLOW.index(c[0]) if c[0] in _SLOW else len(_SLOW)
        return (c[1] not in ("train_4k", "prefill_32k"), rank)

    return sorted(cells, key=cost)


def run_cells(cells, *, device="cuda", out_dir: str = RESULTS_DIR, force: bool = False,
              jobs: int = 1) -> list:
    """Run ``cells`` ((arch, shape, mesh, variant) tuples), writing one JSON
    each; returns the failed cells. ``jobs`` > 1 runs them in that many
    spawned processes (each its own fake group)."""
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for arch, shape, mesh, variant in cells:
        path = _cell_path(out_dir, arch, shape, mesh, variant)
        if os.path.exists(path) and not force:
            print(f"skip (cached): {path}")
            continue
        todo.append((arch, shape, mesh, variant, device, out_dir))
    if jobs > 1 and len(todo) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(jobs, len(todo)), maxtasksperchild=4) as pool:
            done = pool.map(_run_and_write, todo, chunksize=1)
    else:
        done = [_run_and_write(job) for job in todo]
    return [cell for cell, ok in done if not ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors name: cuda (the default) needs a "
                         "card and never falls back; cpu only for a machine without one")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    ap.add_argument("--perf-variants", action="store_true",
                    help="with --all: also the five non-baseline PERF_VARIANTS")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda fakes card tensors and needs a card; pass --device cpu")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = sweep_cells(meshes, args.perf_variants)
        if args.variant != "baseline":
            cells = [(a, s, m, args.variant) for a, s, m, _ in cells]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape, m, args.variant) for m in meshes]
    failures = run_cells(cells, device=args.device, out_dir=args.out_dir,
                         force=args.force, jobs=args.jobs)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all requested cells ran OK")


if __name__ == "__main__":
    main()
