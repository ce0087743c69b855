"""Meshes and sharding contexts on ``torch.distributed`` (DESIGN.md §4, §9).

The counterpart of the JAX package's ``distributed/sharding.py``. A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group, laid out row-major (rank ``r`` of a
``(data, shard)`` mesh sits at ``divmod(r, n_shards)``), and every rank
computes on its own device: its own card when the node has one per rank,
else ``cuda:0`` (ranks that share one card), or the CPU when asked.

``shard_map`` is the reference's ``shard_map`` restated for SPMD ranks:
every rank calls the mapped function with the same global inputs; each
takes its block of every input along the mesh axes its ``P`` spec names
(``LOCAL`` passes an input that is already the rank's own, such as an
index shard, through unsliced), runs the body, and ``all_gather``s every
output along the axes its out-spec names, so every rank sees the global
result, as in the reference. Inside the body ``all_gather``, ``psum``,
``axis_index`` and ``axis_size`` name mesh axes, as ``jax.lax``'s do.

The reference has one controller; ``torch.distributed`` runs one Python
process per rank. Serving decisions come from the clock (the budgeter's
alpha, micro-batching, the control plane's planner), so ranks that made
them each for themselves would call different collectives and hang.
Rank 0 therefore drives: inside ``driving()`` every call of a mesh
engine's step (``mesh_call``) and every mesh engine built on rank 0
(``announce``) is first broadcast to the other ranks, which execute what
they receive in ``worker_loop`` until ``driving`` ends. Outside
``driving()`` the same calls are plain SPMD: every rank makes them.

Placed trees (the model paths, DESIGN.md §5). ``place_tree`` is the
reference's ``jax.device_put(tree, NamedSharding(mesh, spec))``: each rank
keeps only its block of every leaf, on its own device; ``gather_tree`` is
its inverse, the global arrays on every rank. A model entry point given a
sharding context takes placed trees (parameters by ``param_pspecs``, a
batch by ``batch_pspecs``) and returns placed outputs: every product is
lowered as its operands' specs imply (a column-sharded weight gives the
rank's columns, a row-sharded one a partial product and a ``psum``), and
no rank assembles a sharded weight. ``bound(mesh)`` lets such code call the
collectives outside a ``shard_map`` body. Under autograd ``psum`` passes
its gradient through unchanged and ``sum_grads`` sums it over an axis
(the two halves of a tensor-parallel region), and ``all_gather_tiled``
scatters the summed gradient back to the blocks; so each rank's backward
pass gives its share of the gradient, and a train step sums the shares
over the data axes.

Backends: NCCL when every rank has a card of its own; gloo when ranks share
a card or run on the CPU. Gloo's collectives on card tensors are staged
through the host here (``RankRuntime.staged``), one copy each way.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import importlib
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "ShardCtx",
    "named",
    "data_spec",
    "shard_map",
    "axis_size",
    "replica_mesh",
    "retrieval_mesh",
    "LOCAL",
    "LocalMesh",
    "NamedSharding",
    "P",
    "RankRuntime",
    "all_gather",
    "all_gather_tiled",
    "announce",
    "axis_index",
    "bound",
    "close_mesh_group",
    "collective_census",
    "driving",
    "fsdp_gather",
    "gather",
    "gather_seq",
    "gather_tree",
    "init_fake_group",
    "init_mesh_group",
    "make_mesh",
    "mesh_call",
    "mesh_coord",
    "mesh_sizes",
    "mesh_world_size",
    "place",
    "place_tree",
    "pmax",
    "psum",
    "psum_scatter",
    "register",
    "release",
    "require_group",
    "runtime",
    "spec_at",
    "split_seq",
    "sum_grads",
    "worker_loop",
]


class P(tuple):
    """A partition spec: one entry per array dimension, each None
    (replicated), a mesh axis name, or a tuple of axis names (the
    dimension split over their product, the first the major one). One
    axis in a tuple is stored as that axis, as ``PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else tuple(p)) if isinstance(p, (tuple, list)) else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# The spec of an input that is already the rank's own block.
LOCAL = "local"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec laid over a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P


# --------------------------------------------------------------------------
# The process group
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RankRuntime:
    """This rank's place in the process group and what it computes on."""

    rank: int
    world: int
    backend: str
    device: torch.device
    control: object  # the gloo group carrying rank 0's messages
    objects: dict = dataclasses.field(default_factory=dict)
    meshes: dict = dataclasses.field(default_factory=dict)
    next_id: int = 0
    driving: bool = False

    @property
    def staged(self) -> bool:
        """Gloo collectives on card tensors go through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def describe(self) -> str:
        """The backend, as a log line names it."""
        return f"{self.backend}{' (host-staged)' if self.staged else ''}"


_RT: RankRuntime | None = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_mesh_group(
    device=None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout_s: float = 600.0,
) -> RankRuntime:
    """Bring up (or adopt) the process group the meshes span.

    ``rank`` and ``world_size`` default to the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``);
    ``init_method`` to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), or a
    ``file://`` path. ``device="cpu"`` computes on the CPU; otherwise each
    rank takes card ``LOCAL_RANK`` when the node has a card per local rank
    and ``cuda:0`` when ranks must share it. The backend follows: NCCL for
    a card per rank, gloo otherwise. Every rank calls this once.
    """
    global _RT
    if _RT is not None:
        return _RT
    rank = _env_int("RANK", 0) if rank is None else rank
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if device is not None and torch.device(device).type == "cpu":
        dev, own_card = torch.device("cpu"), False
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the mesh "
                "on the CPU")
        own_card = torch.cuda.device_count() >= local_world
        dev = torch.device("cuda", local_rank if own_card else 0)
        torch.cuda.set_device(dev)
    backend = "nccl" if own_card else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    control = (dist.new_group(backend="gloo") if backend != "gloo"
               else dist.group.WORLD)
    _RT = RankRuntime(rank=dist.get_rank(), world=dist.get_world_size(),
                      backend=backend, device=dev, control=control)
    return _RT


def init_fake_group(world_size: int, device="cpu") -> RankRuntime:
    """This process as rank 0 of a group of ``world_size`` ranks that do not
    exist: torch's ``fake`` backend, whose collectives return at once and
    move nothing (the dry run's counterpart of the reference's
    ``--xla_force_host_platform_device_count``). Meshes over it are laid out
    as over a real group; tensors are meant to be fake (``FakeTensorMode``)
    on ``device``."""
    global _RT
    if _RT is not None:
        raise RuntimeError("a process group is already up; close_mesh_group() first")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    _RT = RankRuntime(rank=0, world=world_size, backend="fake",
                      device=torch.device(device), control=dist.group.WORLD)
    return _RT


def close_mesh_group() -> None:
    """Tear down the process group ``init_mesh_group`` brought up."""
    global _RT
    if dist.is_initialized():
        dist.destroy_process_group()
    _RT = None


def runtime() -> RankRuntime | None:
    """This rank's runtime, or None before ``init_mesh_group``."""
    return _RT


def mesh_world_size() -> int:
    """Ranks a mesh may span: the process group's size, 1 without one."""
    return _RT.world if _RT is not None else 1


def require_group(what: str, need: int = 1) -> RankRuntime:
    """This rank's runtime; raises ValueError without an initialised
    process group of at least ``need`` ranks."""
    if _RT is None:
        raise ValueError(
            f"{what} needs an initialised process group of {need} ranks "
            "(init_mesh_group, under torchrun or with a file:// init_method); "
            "without one, serve on the single-card stacked path")
    if _RT.world < need:
        raise ValueError(f"{what} needs {need} ranks, have {_RT.world}")
    return _RT


def make_mesh(shape: tuple, axis_names: tuple):
    """A mesh of ``shape`` over ranks ``0..prod(shape)-1``, row-major, with
    ``axis_names`` (the reference's ``jax.make_mesh``). Raises when the
    process group is smaller than the mesh, or not initialised. Building
    a mesh is collective: every rank builds the same meshes in one order
    (each shape once; later calls reuse it)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    rt = require_group(f"a {' x '.join(map(str, shape))} mesh", int(np.prod(shape)))
    key = (shape, axis_names)
    if key not in rt.meshes:
        rt.meshes[key] = DeviceMesh(
            "cuda" if rt.backend == "nccl" else "cpu",
            torch.arange(int(np.prod(shape))).reshape(shape), mesh_dim_names=axis_names)
    return rt.meshes[key]


class LocalMesh:
    """A mesh of this process alone, every axis of size 1: the mesh paths
    run on it without a process group, each collective the identity (the
    reference's functions on a one-device mesh)."""

    def __init__(self, axis_names: tuple = ("data", "model")):
        self.mesh_dim_names = tuple(axis_names)
        self.mesh = torch.zeros((1,) * len(self.mesh_dim_names), dtype=torch.int64)

    def get_coordinate(self) -> list[int]:
        return [0] * len(self.mesh_dim_names)


def retrieval_mesh(n_shards: int, axis: str = "shard"):
    """1-D mesh for range-sharded retrieval (DESIGN.md §4): ranks
    ``0..n_shards-1``, one shard each."""
    return make_mesh((n_shards,), (axis,))


def replica_mesh(
    n_replicas: int,
    n_shards: int,
    data_axis: str = "data",
    shard_axis: str = "shard",
):
    """2-D (data x shard) mesh for replicated shard groups (DESIGN.md §9).

    Rows carry full index replicas (query parallelism over ``data_axis``),
    columns carry range shards; needs ``n_replicas * n_shards`` ranks.
    """
    return make_mesh((n_replicas, n_shards), (data_axis, shard_axis))


def _dim(mesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


_SIZES: dict = {}  # id(mesh) -> (mesh, {axis: size}); a mesh's layout never changes


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh`` (read once per mesh: a
    ``DeviceMesh`` rebuilds its rank tensor on every ``.mesh``)."""
    hit = _SIZES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)})
        _SIZES[id(mesh)] = hit
    return hit[1]


def _size(mesh, name: str) -> int:
    return mesh_sizes(mesh)[name]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Which mesh axes carry data parallelism and which carry model/TP/EP.

    data_axes is ("pod", "data") on the multi-pod mesh, ("data",) otherwise.
    ``fsdp_specs`` (the port's own field) is the parameters' spec tree when
    their placement also splits leaves over the data axes (FSDP,
    ``trainer.fsdp_param_specs``), else None: the steps gather those
    leaves where they are used (``fsdp_gather``) and the sharded update
    lays them out by it.
    """

    mesh: object
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp_specs: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_model(self) -> int:
        return _size(self.mesh, self.model_axis)

    @property
    def n_data(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= _size(self.mesh, a)
        return n

    def sharding(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)


def named(ctx: ShardCtx | None, tree, specs):
    """The reference's sharding constraint: a layout hint for XLA. Arrays
    on a rank are already its own blocks, so the tree comes back as is."""
    del ctx, specs
    return tree


def data_spec(ctx: ShardCtx, *trailing) -> P:
    """Batch-sharded spec: first dim over all data axes."""
    return P(ctx.data_axes, *trailing)


# --------------------------------------------------------------------------
# Collectives inside a mapped body
# --------------------------------------------------------------------------

_BOUND: list = []  # the meshes of the shard_map bodies running on this rank


def _bound_mesh():
    if not _BOUND:
        raise RuntimeError("mesh collectives run inside a shard_map body")
    return _BOUND[-1]


def mesh_coord(mesh, axes) -> tuple[int, int]:
    """(this rank's linear index, their count) over mesh axes ``axes``, the
    first the major one (the order of a ``P`` entry naming them)."""
    idx, n = 0, 1
    coord = mesh.get_coordinate()
    for a in _names(axes):
        k = _size(mesh, a)
        idx, n = idx * k + int(coord[_dim(mesh, a)]), n * k
    return idx, n


def axis_size(name) -> int:
    """Size of mesh axis ``name`` (a tuple: their product) in the body."""
    mesh = _bound_mesh()
    names = name if isinstance(name, tuple) else (name,)
    return int(np.prod([_size(mesh, a) for a in names]))


def axis_index(name: str) -> int:
    """This rank's coordinate along mesh axis ``name`` in the body."""
    mesh = _bound_mesh()
    return int(mesh.get_coordinate()[_dim(mesh, name)])


@contextlib.contextmanager
def bound(mesh):
    """Run the collectives on ``mesh`` outside a ``shard_map`` body: the
    code inside works on placed blocks, as a mapped body does."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


_CENSUS: list = []  # the open collective censuses, innermost last


@contextlib.contextmanager
def collective_census():
    """``{"bytes_by_kind", "count_by_kind"}`` of the collectives this rank
    makes inside the block: per kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``), the bytes that land on this rank (an all-reduce's
    tensor, an all-gather's gathered result, a reduce-scatter's block: the
    reference's result bytes), once per mesh axis a collective spans."""
    out = {"bytes_by_kind": {}, "count_by_kind": {}}
    _CENSUS.append(out)
    try:
        yield out
    finally:
        _CENSUS.pop()


def _note(kind: str, nbytes: int) -> None:
    if _CENSUS:
        c = _CENSUS[-1]
        c["bytes_by_kind"][kind] = c["bytes_by_kind"].get(kind, 0) + int(nbytes)
        c["count_by_kind"][kind] = c["count_by_kind"].get(kind, 0) + 1


def _stage(x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if _RT.staged and x.is_cuda else x


def _names(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _all_reduce(x: torch.Tensor, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    mesh = _bound_mesh()
    axes = [a for a in _names(axis) if _size(mesh, a) > 1]
    if not axes:
        return x.detach().clone()
    y = _stage(x.detach()).clone()
    for a in axes:
        dist.all_reduce(y, op=op, group=mesh.get_group(a))
        _note("all-reduce", y.numel() * y.element_size())
    return y.to(x.device)


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """[n_axis, *x.shape]: every rank's ``x`` along ``axis``, in axis order."""
    mesh = _bound_mesh()
    n = _size(mesh, axis)
    if n == 1:
        return x.detach()[None]
    src = _stage(x.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    _note("all-gather", n * src.numel() * src.element_size())
    return torch.stack(parts).to(x.device)


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    mesh = _bound_mesh()
    n = _size(mesh, axis)
    if n == 1:
        return x.detach().clone()
    parts = [c.contiguous() for c in _stage(x.detach()).chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.get_group(axis))
    _note("reduce-scatter", out.numel() * out.element_size())
    return out.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.mesh = axis, _bound_mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):  # the backward pass runs outside the body: rebind
        with bound(ctx.mesh):
            return _all_reduce(g, ctx.axis), None


class _GatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n, ctx.mesh = axis, dim, x.shape[dim], _bound_mesh()
        ctx.idx = axis_index(axis)
        return torch.cat(list(all_gather(x, axis)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        with bound(ctx.mesh):
            g = _all_reduce(g, ctx.axis)
        # A copy of the block: a view would keep the whole sum alive as long
        # as the gradient (an FSDP leaf's, to the end of the backward pass).
        return g.narrow(ctx.dim, ctx.idx * ctx.n, ctx.n).clone(), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.dim, ctx.n, ctx.idx = dim, x.shape[dim], axis_index(axis)
        return torch.cat(list(all_gather(x, axis)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.idx * ctx.n, ctx.n).clone(), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        n = axis_size(axis)
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, _bound_mesh()
        w = x.shape[dim] // n
        return x.narrow(dim, axis_index(axis) * w, w).clone()

    @staticmethod
    def backward(ctx, g):
        with bound(ctx.mesh):
            return torch.cat(list(all_gather(g, ctx.axis)), dim=ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, dtype):
        ctx.axis, ctx.dim, ctx.mesh, ctx.in_dtype = axis, dim, _bound_mesh(), x.dtype
        return _reduce_scatter(x, axis, dim).to(dtype)

    @staticmethod
    def backward(ctx, g):
        with bound(ctx.mesh):
            g = torch.cat(list(all_gather(g, ctx.axis)), dim=ctx.dim)
        return g.to(ctx.in_dtype), None, None, None


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0, dtype=None) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over mesh axis
    ``axis`` (``dim`` divisible by its size), in ``dtype`` (None: ``x``'s):
    one reduce-scatter in ``x``'s type, the reference's
    ``psum_scatter(..., tiled=True)``. Its backward gathers the blocks'
    gradients (in ``dtype``), which is each rank's gradient of its whole
    ``x``."""
    dtype = dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        return _PsumScatter.apply(x, axis, dim, dtype)
    return _reduce_scatter(x, axis, dim).to(dtype)


def gather_seq(x: torch.Tensor, axis: str, dim: int = 1) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated over mesh axis
    ``axis``: a sequence-parallel activation made whole for a region that
    uses it replicated (each rank's gradient of it is then the whole one,
    so the backward pass keeps this rank's block of it)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherSeq.apply(x, axis, dim)
    return torch.cat(list(all_gather(x, axis)), dim=dim)


def split_seq(x: torch.Tensor, axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim`` over mesh axis
    ``axis`` (``dim`` divisible by its size): a sequence-parallel
    activation. Its backward gathers the blocks' gradients, which is the
    whole one every rank held for the replicated value."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SplitSeq.apply(x, axis, dim)
    w = x.shape[dim] // axis_size(axis)
    return x.narrow(dim, axis_index(axis) * w, w).clone()


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over mesh axis ``axis`` (a tuple: over each). Its
    gradient passes through unchanged: the sum's every use is replicated
    over ``axis``, so each rank's gradient of it is the whole one."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Psum.apply(x, axis)
    return _all_reduce(x, axis)


def sum_grads(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axis``: a replicated value
    entering computation that each rank does for its own block."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumGrads.apply(x, axis)
    return x


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max over mesh axis ``axis`` (no gradient)."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_gather_tiled(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (a tuple:
    over each, the first the major one), as ``lax.all_gather(tiled=True)``.
    Under autograd each block gets the gradient summed over ``axis``."""
    for a in reversed(_names(axis)):
        if torch.is_grad_enabled() and x.requires_grad:
            x = _GatherTiled.apply(x, a, dim)
        else:
            x = torch.cat(list(all_gather(x, a)), dim=dim)
    return x


# --------------------------------------------------------------------------
# shard_map
# --------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block(x, spec: P, mesh, device):
    """This rank's block of global ``x`` under ``spec``."""
    coord = mesh.get_coordinate()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:  # row-major over the entry's axes
            n, idx = n * _size(mesh, a), idx * _size(mesh, a) + coord[_dim(mesh, a)]
        if x.shape[d] % n:
            raise ValueError(
                f"dimension {d} of size {x.shape[d]} does not split over {axes} ({n})")
        b = x.shape[d] // n
        sl = [slice(None)] * x.ndim
        sl[d] = slice(idx * b, (idx + 1) * b)
        x = x[tuple(sl)]
    if isinstance(x, torch.Tensor) and device is not None:
        return x.to(device)
    return x


def _map_in(x, spec, mesh, device):
    if isinstance(x, dict):  # a spec prefix: a P covers every leaf under it
        return {k: _map_in(v, spec[k] if isinstance(spec, dict) else spec, mesh, device)
                for k, v in x.items()}
    if isinstance(spec, P):
        return _block(x, spec, mesh, device)
    if spec == LOCAL:
        return x
    if isinstance(spec, (tuple, list)):
        parts = [_map_in(a, s, mesh, device) for a, s in zip(x, spec)]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
    raise TypeError(f"in_spec {spec!r} is not a P, LOCAL or a tuple of them")


def _gather_out(y, spec, mesh):
    if isinstance(y, dict):
        return {k: _gather_out(v, spec[k] if isinstance(spec, dict) else spec, mesh)
                for k, v in y.items()}
    if isinstance(spec, (tuple, list)) and not isinstance(spec, P):
        parts = [_gather_out(a, s, mesh) for a, s in zip(y, spec)]
        return type(y)(*parts) if hasattr(y, "_fields") else type(y)(parts)
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):  # minor axis first, then the major
            g = all_gather(y, a)
            y = torch.cat(list(g), dim=d)
    return y


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None, check_vma=None):
    """``f`` over the mesh, one block per rank (see the module docstring).

    A rank outside ``mesh`` (a mesh over fewer ranks than the group)
    returns None and takes part in nothing. ``axis_names`` and
    ``check_vma`` are the reference's compiler options and are ignored:
    every axis is manual here, and nothing is checked for replication.
    """
    del axis_names, check_vma

    def mapped(*args):
        if mesh.get_coordinate() is None:
            return None
        device = _RT.device if _RT is not None else None  # a LocalMesh: where they are
        local = [_map_in(a, s, mesh, device) for a, s in zip(args, in_specs)]
        _BOUND.append(mesh)
        try:
            out = f(*local)
            return _gather_out(out, out_specs, mesh)
        finally:
            _BOUND.pop()

    return mapped


# --------------------------------------------------------------------------
# Placed trees
# --------------------------------------------------------------------------


def _spec_of(s) -> P:
    return s.spec if isinstance(s, NamedSharding) else s


def spec_at(specs, path) -> P:
    """The spec of the leaf at ``path`` (names, list indices as digits) in
    a spec tree of the reference's layout. A digit under a dict is a layer
    of a stacked segment (the reference's ``[L, ...]`` leaf): the spec's
    leading entry is dropped for it."""
    node, drop = specs, 0
    for part in path:
        part = str(part)
        if isinstance(node, (list, tuple)) and not isinstance(node, P):
            node = node[int(part)]
        elif part.isdigit() and part not in node:
            drop += 1
        else:
            node = node[part]
    return P(*tuple(_spec_of(node))[drop:])


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from repro_torch.models.layers import tensor_from_numpy

    return tensor_from_numpy(x, "cpu")


def place(x, spec, mesh, device=None) -> torch.Tensor:
    """This rank's block of global ``x`` (a tensor or a numpy array) under
    ``spec``, on ``device`` (None: the rank's own; without a process group,
    a ``LocalMesh``, where ``x`` is)."""
    if device is not None:
        dev = torch.device(device)
    elif _RT is not None:
        dev = _RT.device
    else:
        dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = _host_tensor(np.ascontiguousarray(_block(a, _spec_of(spec), mesh, dev)))
        return x.to(dev)
    out = _block(x, _spec_of(spec), mesh, dev)
    if out.numel() < x.numel() and out.untyped_storage().data_ptr() == (
            x.untyped_storage().data_ptr()):
        return out.clone(memory_format=torch.contiguous_format)  # not a view of the whole
    return out.contiguous()


def gather(x: torch.Tensor, spec, mesh, root: int | None = None):
    """The global array of the placed block ``x``: on every rank, or with
    ``root`` on the host of that rank alone (the others get None; each
    block then travels once, to the root)."""
    spec = _spec_of(spec)
    if root is None or _RT is None or int(mesh.mesh.numel()) != _RT.world:
        with bound(mesh):
            y = _gather_out(x, spec, mesh)
        if root is None:
            return y
        return y.cpu() if _RT is None or _RT.rank == root else None
    src = _stage(x.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(_RT.world)] if _RT.rank == root else None
    dist.gather(src, parts, dst=root)
    if _RT.rank != root:
        return None
    shape = list(x.shape)
    for d, entry in enumerate(spec):
        shape[d] *= int(np.prod([_size(mesh, a) for a in _axes(entry)] or [1]))
    out = torch.empty(shape, dtype=x.dtype)
    layout = mesh.mesh
    for coord in np.ndindex(*layout.shape):
        idx = [slice(None)] * x.ndim
        for d, entry in enumerate(spec):
            k = 0
            for a in _axes(entry):
                k = k * _size(mesh, a) + coord[_dim(mesh, a)]
            idx[d] = slice(k * x.shape[d], (k + 1) * x.shape[d])
        # the root assembles the global array on its host, block by block
        out[tuple(idx)] = parts[int(layout[coord])].cpu()  # analysis: allow[HOSTSYNC]
    return out


def _map_tree(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and tuples, or a
    ``Params`` module (whose parameters are replaced in place)."""
    if isinstance(tree, torch.nn.Module):
        for name, prm in list(tree.named_parameters()):
            *mods, leaf = name.split(".")
            owner = tree
            for m in mods:
                owner = owner._modules[m]
            new = fn(prm.detach(), spec_at(specs, name.split(".")))
            owner._parameters[leaf] = torch.nn.Parameter(new, requires_grad=False)
        return tree
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, _spec_of(specs))


def place_tree(tree, specs, mesh):
    """Every leaf's block on this rank (``jax.device_put`` of the tree with
    ``NamedSharding(mesh, spec)``). ``specs`` is a tree of ``P`` (or
    ``NamedSharding``) in the reference's layout; a ``Params`` tree is
    placed in place, layer by layer. The global leaves are not kept."""
    return _map_tree(lambda x, s: place(x, s, mesh), tree, specs)


_FSDP_PLANS: dict = {}  # id(fsdp_specs) -> (fsdp_specs, {(path, data axes): leaves})


def _fsdp_leaves(node, path: str, shard_ctx) -> list:
    """(leaf, axes, dim) of ``node``'s own leaves that ``fsdp_specs``
    splits over the data axes alone (an entry with a model axis too is
    expert parallelism, not FSDP)."""
    specs, da = shard_ctx.fsdp_specs, tuple(shard_ctx.data_axes)
    hit = _FSDP_PLANS.get(id(specs))
    if hit is None or hit[0] is not specs:
        hit = _FSDP_PLANS[id(specs)] = (specs, {})
    plan = hit[1]
    if (path, da) not in plan:
        out = []
        for leaf in node._parameters:
            spec = spec_at(specs, (f"{path}.{leaf}" if path else leaf).split("."))
            for d, entry in enumerate(spec):
                axes = _axes(entry)
                if axes and all(a in da for a in axes):
                    out.append((leaf, axes if len(axes) > 1 else axes[0], d))
        plan[path, da] = out
    return plan[path, da]


def fsdp_gather(node, shard_ctx, path: str = "", deep: bool = True):
    """``node``, the ``Params`` node at ``path`` of the parameters ("" the
    root, ``dense.3`` a layer), with every leaf that ``shard_ctx.fsdp_specs``
    splits over the data axes (FSDP) gathered whole over them, as a dict of
    its children; ``node`` itself when nothing is split or the context
    has no FSDP specs. ``deep`` gathers the leaves of every ``Params``
    below it too (a layer); otherwise only ``node``'s own. Call it inside
    the mesh's ``bound`` where the weights are used: the whole weights live
    as long as the view, and under autograd each block's gradient is the
    whole one's, summed over the data axes and sliced
    (``all_gather_tiled``)."""
    if (shard_ctx is None or shard_ctx.fsdp_specs is None
            or not isinstance(node, torch.nn.Module) or not hasattr(node, "keys")):
        return node
    leaves = _fsdp_leaves(node, path, shard_ctx)
    kids = {}
    if deep:
        for name, child in node._modules.items():
            g = fsdp_gather(child, shard_ctx, f"{path}.{name}" if path else name, True)
            if g is not child:
                kids[name] = g
    if not leaves and not kids:
        return node
    view = {name: node[name] for name in node.keys()}
    for leaf, axes, dim in leaves:
        view[leaf] = all_gather_tiled(view[leaf], axes, dim)
    view.update(kids)
    return view


def gather_tree(tree, specs, mesh, root: int | None = None):
    """The global arrays of a placed tree, on every rank (a ``Params`` tree
    comes back as a new one; the placed tree is left as it was). With
    ``root`` the arrays land on that rank's host, one leaf at a time, and
    the other ranks get None."""
    mine = root is None or _RT is None or _RT.rank == root
    if isinstance(tree, torch.nn.Module) and mine:
        tree = copy.deepcopy(tree)  # the copy holds global arrays

    def one(x, s):
        y = gather(x, s, mesh, root)
        return y if mine else x

    out = _map_tree(one, tree, specs)
    return out if mine else None


# --------------------------------------------------------------------------
# Rank 0 drives, the other ranks execute
# --------------------------------------------------------------------------


class _Ref(int):
    """A registered object in a message: its id on every rank."""


def register(obj) -> int:
    """Give ``obj`` the next id (once per object). Ids agree across ranks
    as long as every rank registers the same objects in the same order:
    in lockstep construction, or through ``announce`` while driving."""
    rt = _RT
    for i, o in rt.objects.items():
        if o is obj:
            return i
    i, rt.next_id = rt.next_id, rt.next_id + 1
    rt.objects[i] = obj
    return i


def _ref(obj):
    for i, o in _RT.objects.items():
        if o is obj:
            return _Ref(i)
    return obj


def _send(msg) -> None:
    dist.broadcast_object_list([msg], src=0, group=_RT.control)


def _resolve(a):
    return _RT.objects[int(a)] if isinstance(a, _Ref) else a


def mesh_call(obj, method: str, *args, **kwargs):
    """``obj.method(*args, **kwargs)`` on every rank of the mesh.

    While rank 0 drives, the call is broadcast first and the other ranks
    run it from ``worker_loop``; otherwise every rank makes the call
    itself (SPMD). ``obj`` must be registered.
    """
    rt = _RT
    if rt is not None and rt.driving:
        ref = _ref(obj)
        if not isinstance(ref, _Ref):
            raise ValueError(f"{type(obj).__name__} is not registered on the mesh")
        _send(("call", ref, method, args, kwargs))
    return getattr(obj, method)(*args, **kwargs)


def announce(factory, *args) -> None:
    """While rank 0 drives, have every other rank call ``factory(*args)``
    (a module-level function; registered objects among ``args`` arrive as
    the receiving rank's own). Rank 0 calls this before it builds its own
    counterpart, so any collective the construction makes lines up."""
    rt = _RT
    if rt is None or not rt.driving:
        return
    name = f"{factory.__module__}:{factory.__qualname__}"
    _send(("new", name, tuple(_ref(a) for a in args)))


def release(obj) -> None:
    """Drop ``obj`` from the registry (while driving, on every rank)."""
    rt = _RT
    if rt is None:
        return
    ref = _ref(obj)
    if not isinstance(ref, _Ref):
        return
    if rt.driving:
        _send(("release", ref))
    rt.objects.pop(int(ref), None)


@contextlib.contextmanager
def driving():
    """Rank 0's serving section: mesh calls and constructions inside it
    are sent to the other ranks (which run ``worker_loop``), and leaving it
    stops them (leaving on an exception makes them raise). On a group of
    one rank it only marks the section."""
    rt = _RT
    if rt is None or rt.rank != 0:
        raise RuntimeError("driving() runs on rank 0 of an initialised group")
    rt.driving = True
    stop = ("stop",)
    try:
        yield rt
    except BaseException:
        stop = ("abort",)  # the other ranks raise too, instead of waiting
        raise
    finally:
        rt.driving = False
        if rt.world > 1:
            _send(stop)


def worker_loop() -> int:
    """A rank other than 0: execute rank 0's messages until it stops
    driving. Returns the number of messages executed."""
    rt = _RT
    n = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=rt.control)
        msg = box[0]
        kind = msg[0]
        if kind == "stop":
            return n
        if kind == "abort":
            raise RuntimeError("rank 0 stopped driving on an error")
        if kind == "call":
            _, ref, method, args, kwargs = msg
            getattr(_resolve(ref), method)(*args, **kwargs)
        elif kind == "new":
            mod, qual = msg[1].split(":")
            factory = importlib.import_module(mod)
            for part in qual.split("."):
                factory = getattr(factory, part)
            factory(*(_resolve(a) for a in msg[2]))
        elif kind == "release":
            rt.objects.pop(int(msg[1]), None)
        n += 1
