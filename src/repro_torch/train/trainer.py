"""Training loop substrate: the train step and the host loop, one device.

The counterpart of the JAX package's ``train/trainer.py``.
``make_train_step`` assembles loss -> gradients (autograd over the
parameters, which ``layers.trainable`` makes differentiable for the pass)
-> AdamW into one step ``(params, opt_state, batch) -> (params, opt_state,
metrics)``, the metrics ``loss``, ``lr`` and ``grad_norm`` as 0-d tensors.
As in the reference:

  * with ``accum == 1`` the gradients have the parameters' dtype; with
    ``accum > 1`` the batch's leaves carry a leading ``accum`` dim, the
    gradients are a float32 sum from float32 zeros, and the loss and the
    gradients are divided by ``accum``;
  * the learning rate is the schedule at the state's step BEFORE the
    update (the first step under a warmup runs at lr 0).

The step updates the parameters and the optimizer state in place and
returns them (the reference's jitted step donates both).

``Trainer`` is the host loop: microbatch accumulation, the wall-clock step
watchdog (``slow_steps``), SIGTERM -> checkpoint-and-exit (preemption),
checkpoints every ``checkpoint_every`` steps, and a resume from the stored
step (the data function is deterministic in the step, so a resume replays
the exact batch sequence). It waits for the card once at each step
boundary (``torch.cuda.synchronize``), where the reference blocks on the
loss. Checkpoints hold the reference's trees (``layers.params_to_tree``,
``opt_state_to_tree``), so either package resumes the other's run.

On a mesh (``make_train_step(..., shard_ctx=, param_specs=)``, the step
an ``Arch.build_step`` with a context returns) the step takes parameters
placed by ``param_specs``, an optimizer state placed by
``zero1_state_specs`` (``place_opt_state``, or ``init_zero1_state``) and a
batch placed by ``batch_pspecs``; every rank calls it. The reference gets
this layout from GSPMD; here each rank's backward pass gives its share of
the gradient of its blocks, the shares are summed over the data axes, the
clip norm sums each leaf's squares over the axes that shard it, and each
data rank updates only its ZeRO-1 slice of the moments and of the
parameter block (``zero1_spec`` names the dim; a stacked segment's layer
dim gives each data rank whole layers), then the updated slices are
gathered back over the data axes. The result is the single-device step's.

Int8 moments are laid out as the reference's ``zero1_state_specs`` lays
them out: ``q`` [..., nblk, 256] and ``scale`` [..., nblk, 1] each by
``zero1_spec`` of its own shape, which may split the 256-wide block dim
over the data axes (the scale then stays whole, and the block's absmax is
a ``pmax`` over them) or leave a model-sharded parameter dim whole in the
moment. Each rank then updates the part of the parameter its moment block
covers: its parameter and gradient blocks gathered over the axes the
moment does not split, sliced to the moment's block (a strided view of
each block of 256 when the block dim is split), and the new values taken
back to the parameter's layout the same way.

FSDP (``fsdp_param_specs``, the reference dry run's placement of an
``fsdp`` arch, given to the step as its context's ``fsdp_specs``): a leaf
whose spec there splits it over the data axes is the rank's own block,
updated whole; the model gathers it where it is used
(``sharding.fsdp_gather``, which reads the same specs), and its gradient
arrives summed over the data axes.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    P,
    all_gather_tiled,
    bound,
    mesh_coord,
    mesh_sizes,
    place,
    pmax,
    psum,
    runtime,
    spec_at,
)
from repro_torch.models.layers import (
    _ref_key,
    flat_to_tree,
    host_array,
    param_leaves,
    params_from_tree,
    params_to_tree,
    tensor_from_numpy,
    trainable,
    tree_to_flat,
)
from repro_torch.optim.adamw import (
    _BLOCK,
    AdamWConfig,
    _decode,
    _encode,
    _global_norm,
    _leaf_step,
    _scale_and_corrections,
    adamw_update,
    init_opt_state,
    is_q8_leaf,
)
from repro_torch.optim.schedule import cosine_with_warmup

__all__ = ["make_train_step", "zero1_state_specs", "Trainer", "TrainerConfig",
           "opt_state_to_tree", "opt_state_from_tree", "zero1_spec", "init_zero1_state",
           "place_opt_state", "gather_opt_state", "fsdp_param_specs"]


# ------------------------------------------------------------------ ZeRO-1


def _axes_size(axes, mesh_shape: dict) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_shape.get(axes, 1)
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def _fit_spec(spec: P, shape, mesh_shape: dict) -> P:
    """Drop spec axes that no longer divide their dimension (e.g. a
    model-sharded FFN dim after int8 block-reshaping)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts = parts[: len(shape)]
    for i, (s, d) in enumerate(zip(parts, shape)):
        if s is not None and d % _axes_size(s, mesh_shape) != 0:
            parts[i] = None
    return P(*parts)


def _uses_axes(parts, axes) -> bool:
    names = set(axes)
    for s in parts:
        if s is None:
            continue
        for a in (s,) if isinstance(s, str) else s:
            if a in names:
                return True
    return False


def zero1_spec(spec: P, shape, n_data: int, data_axes, mesh_shape=None) -> P:
    """Add a data-axis shard on the first unsharded divisible dim (idempotent:
    specs already carrying a data axis, e.g. FSDP params, pass through)."""
    if mesh_shape is not None:
        spec = _fit_spec(spec, shape, mesh_shape)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts = parts[: len(shape)]
    if _uses_axes(parts, data_axes):
        return P(*parts)
    for i, (s, d) in enumerate(zip(parts, shape)):
        if s is None and d % n_data == 0 and d > 0:
            parts[i] = data_axes
            return P(*parts)
    return P(*parts)


def _shape_tree(flat: dict, stacked) -> dict:
    """Port-named leaves as the reference's nested tree of shapes (a stacked
    segment's layers as one ``(L, ...)`` shape; q8 leaves as dicts)."""
    def shape(v):
        return {k: tuple(t.shape) for k, t in v.items()} if is_q8_leaf(v) else tuple(v.shape)

    root, layers = {}, {}
    for name, v in flat.items():
        path, layer = _ref_key(name, stacked)
        if layer is None:
            _put_path(root, path, shape(v))
        else:
            layers.setdefault(path, []).append(shape(v))
    for path, shapes in layers.items():
        first = shapes[0]
        _put_path(root, path, {k: (len(shapes), *v) for k, v in first.items()}
                  if isinstance(first, dict) else (len(shapes), *first))
    return root


def _put_path(root: dict, path: tuple, value) -> None:
    node = root
    for c in path[:-1]:
        node = node.setdefault(str(c), {})
    node[str(path[-1])] = value


def _at(tree, key):
    if isinstance(tree, (list, tuple)):
        return tree[int(key)]
    return tree[key] if key in tree else tree[str(key)]


def _as_shape_trees(params, opt_state):
    """(param shapes, m shapes, v shapes) in the reference's layout, from
    either package's trees: a ``Params`` and the port's state, or nested
    trees of arrays."""
    if isinstance(params, torch.nn.Module):
        stacked = params.stacked
        leaves = param_leaves(params)
        return (_shape_tree(leaves, stacked), _shape_tree(opt_state["m"], stacked),
                _shape_tree(opt_state["v"], stacked))

    def shapes(t):
        if is_q8_leaf(t):
            return {k: tuple(np.shape(v)) for k, v in t.items()}
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [shapes(v) for v in t]
        return tuple(np.shape(t))
    return shapes(params), shapes(opt_state["m"]), shapes(opt_state["v"])


def zero1_state_specs(param_specs, params, opt_state, n_data: int, data_axes,
                      mesh_shape: dict | None = None):
    """PartitionSpecs for the optimizer state matching init_opt_state's
    structure, in the reference's layout.

    mesh_shape ({axis: size}) enables divisibility sanitization, required
    for int8 moments whose block reshaping can break param-spec alignment.
    ``params``/``opt_state`` are a ``Params`` and the port's state, or the
    reference's trees.
    """
    p_shapes, m_shapes, v_shapes = _as_shape_trees(params, opt_state)

    def moment_spec(p_spec: P, p_shape, s):
        if isinstance(s, dict):
            q_shape = s["q"]
            base = list(p_spec) + [None] * (len(q_shape) - len(p_spec))
            qspec = zero1_spec(P(*base), q_shape, n_data, data_axes, mesh_shape)
            scspec = zero1_spec(P(*base), s["scale"], n_data, data_axes, mesh_shape)
            return {"q": qspec, "scale": scspec}
        return zero1_spec(p_spec, p_shape, n_data, data_axes, mesh_shape)

    def walk(spec, ps, ms):
        if isinstance(spec, P):
            return moment_spec(spec, ps, ms)
        if isinstance(spec, dict):
            return {k: walk(v, _at(ps, k), _at(ms, k)) for k, v in spec.items()}
        return [walk(v, _at(ps, i), _at(ms, i)) for i, v in enumerate(spec)]

    return {"m": walk(param_specs, p_shapes, m_shapes),
            "v": walk(param_specs, p_shapes, v_shapes), "step": P()}


# The reference dry run's FSDP threshold: a leaf of fewer elements stays
# replicated over the data axes.
FSDP_MIN_SIZE = 65536


def fsdp_param_specs(arch, cfg, param_specs, params, ctx):
    """The reference dry run's FSDP placement of an ``fsdp`` arch: every leaf
    of at least ``FSDP_MIN_SIZE`` elements is also split over the data axes on
    its first free divisible dim (``zero1_spec``, on top of the TP spec);
    smaller leaves keep ``param_specs``. Place the parameters by them and
    run the steps with ``dataclasses.replace(ctx, fsdp_specs=...)`` of
    them: the steps gather and update the split leaves by the context. ``params`` is the arch's
    ``Params`` (``param_shapes``) or the reference's tree of arrays.
    Another arch's specs come back as they are. The port holds a stacked
    segment's layers as separate modules, so the layer dim is never the
    FSDP dim: where it would be (its length a multiple of the data axes'
    size, as at no published depth), the next free dim is taken."""
    del cfg
    if not getattr(arch, "fsdp", False):
        return param_specs
    mesh_shape = _mesh_shape(ctx.mesh)
    da, n = tuple(ctx.data_axes), ctx.n_data
    stacked = getattr(params, "stacked", getattr(arch, "stacked", ()))
    shapes = _as_shape_trees(params, {"m": {}, "v": {}})[0]

    def one(spec: P, shape, is_stacked: bool) -> P:
        if int(np.prod(shape)) < FSDP_MIN_SIZE:
            return spec
        out = zero1_spec(spec, shape, n, da, mesh_shape)
        if is_stacked and out and out[0] is not None and _uses_axes([out[0]], da):
            lead = _fit_spec(spec, shape, mesh_shape)
            inner = zero1_spec(P(*tuple(lead)[1:]), shape[1:], n, da, mesh_shape)
            out = P(tuple(lead)[0] if len(lead) else None, *inner)
        return out

    def walk(spec, shp, path):
        if isinstance(spec, P):
            return one(spec, shp, bool(path) and path[0] in stacked)
        if isinstance(spec, dict):
            return {k: walk(v, _at(shp, k), path + (k,)) for k, v in spec.items()}
        return type(spec)(walk(v, _at(shp, i), path + (str(i),)) for i, v in enumerate(spec))

    return walk(param_specs, shapes, ())


@dataclasses.dataclass(frozen=True)
class _Q8:
    """An int8 moment's layout against its parameter block, per layer:
    ``pe`` the parameter's spec entries, ``qe`` those of the moment's ``q``
    [..., nblk, 256] (``zero1_state_specs``; its ``scale`` [..., nblk, 1]
    is split as ``q`` but for the last dim), ``shape`` the parameter's
    global shape, ``aligned`` when the parameter's last-dim split falls on
    whole blocks of 256 that ``q`` splits alike, and ``layer`` the data
    axes that split a stacked segment's layers (the rank then holds the
    moments of its own layers only)."""

    pe: tuple
    qe: tuple
    shape: tuple
    aligned: bool
    layer: tuple = ()


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A parameter block's place in the sharded step. ``axes``: the mesh
    axes its spec shards it over (its squares are summed over them for the
    clip norm); ``reduce``: the data axes its gradient is summed over;
    ``kind``: "whole" (every data rank updates the block), "layer" (the
    data rank ``own`` updates this layer of a stacked segment), "slice"
    (``[lo, hi)`` of dim ``dim``, over the data axes) or "q8" (an int8
    moment's block, ``q8``)."""

    axes: tuple
    reduce: tuple
    kind: str
    own: bool = True
    dim: int = 0
    lo: int = 0
    hi: int = 0
    q8: _Q8 | None = None


def _spec_axes(spec) -> tuple:
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend((e,) if isinstance(e, str) else e)
    return tuple(out)


def _mesh_shape(mesh) -> dict:
    return dict(mesh_sizes(mesh))


def _leaf_layout(name, block: torch.Tensor, param_specs, stacked, n_layers: dict,
                 shard_ctx, moment_dtype: str) -> _Leaf:
    mesh = shard_ctx.mesh
    shape = _mesh_shape(mesh)
    da = tuple(shard_ctx.data_axes)
    path, layer = _ref_key(name, stacked)
    # The stacked spec, layer dim included; an FSDP placement is the
    # context's (what the rank holds, a block split over data its own).
    if shard_ctx.fsdp_specs is not None:
        param_specs = shard_ctx.fsdp_specs
    full = spec_at(param_specs, path)
    per = P(*tuple(full)[1:]) if layer is not None else full
    parts = list(per) + [None] * (block.ndim - len(per))
    gshape = [d * _axes_size(e, shape) for d, e in zip(block.shape, parts)]
    axes = _spec_axes(per)
    reduce = tuple(a for a in da if a not in axes)
    n_data = _axes_size(da, shape)
    lead = (n_layers[path[0]],) if layer is not None else ()
    gfull = (*lead, *gshape)
    if moment_dtype == "int8":
        q_shape = (*gfull[:-1], -(-gfull[-1] // _BLOCK), _BLOCK)
        base = P(*(list(full) + [None] * (len(q_shape) - len(full))))
        qs = list(zero1_spec(base, q_shape, n_data, da, shape))
        qs += [None] * (len(q_shape) - len(qs))
        layer_axes, own = (), True
        if layer is not None:
            if qs[0] is not None and _uses_axes([qs[0]], da):
                layer_axes = qs[0]
                idx, n = mesh_coord(mesh, layer_axes)
                own = layer // (n_layers[path[0]] // n) == idx
            qs = qs[1:]
        pe = tuple(parts)
        aligned = (qs[-2] == pe[-1]
                   and gshape[-1] % (_BLOCK * _axes_size(pe[-1], shape)) == 0)
        return _Leaf(axes, reduce, "q8", own=own,
                     q8=_Q8(pe, tuple(qs), tuple(gshape), aligned, layer_axes))
    mspec = zero1_spec(full, gfull, n_data, da, shape)
    j = _data_dim(mspec, da)
    if j is None or _uses_axes(list(full), da):
        return _Leaf(axes, reduce, "whole")
    idx, n = mesh_coord(mesh, da)
    if layer is not None and j == 0:
        per_rank = n_layers[path[0]] // n
        return _Leaf(axes, reduce, "layer", own=layer // per_rank == idx)
    dim = j - len(lead)
    w = block.shape[dim] // n
    return _Leaf(axes, reduce, "slice", dim=dim, lo=idx * w, hi=(idx + 1) * w)


def _data_dim(spec: P, data_axes) -> int | None:
    for i, e in enumerate(spec):
        if e is not None and _uses_axes([e], data_axes):
            return i
    return None


def _layouts(params, param_specs, shard_ctx, moment_dtype: str) -> dict:
    stacked = params.stacked
    n_layers = {seg: len(params[seg]) for seg in stacked if seg in params}
    return {n: _leaf_layout(n, p, param_specs, stacked, n_layers, shard_ctx, moment_dtype)
            for n, p in param_leaves(params).items()}


def _part(mesh, entry, size: int) -> tuple[int, int]:
    """(start, length) of this rank's part of a dim of ``size`` split over
    spec entry ``entry``."""
    if entry is None:
        return 0, size
    idx, n = mesh_coord(mesh, entry)
    return idx * (size // n), size // n


def _q8_region(x: torch.Tensor, q: _Q8, mesh) -> torch.Tensor:
    """The part of parameter-shaped block ``x`` (a parameter or its
    gradient) that this rank's int8 moment block covers, as blocks
    [..., nblk_loc, 256_loc]: gathered over the axes the moment does not
    split, then sliced to the moment's part."""
    nd = len(q.shape)
    for d in range(nd - 1):
        if q.qe[d] != q.pe[d]:
            if q.pe[d] is not None:
                x = all_gather_tiled(x, q.pe[d], d)
            if q.qe[d] is not None:
                x = x.narrow(d, *_part(mesh, q.qe[d], q.shape[d]))
    if q.aligned:
        x = x.reshape(*x.shape[:-1], -1, _BLOCK)
    else:
        if q.pe[-1] is not None:
            x = all_gather_tiled(x, q.pe[-1], nd - 1)
        nb = -(-q.shape[-1] // _BLOCK)
        x = F.pad(x, (0, nb * _BLOCK - q.shape[-1])).reshape(*x.shape[:-1], nb, _BLOCK)
        if q.qe[nd - 1] is not None:
            x = x.narrow(nd - 1, *_part(mesh, q.qe[nd - 1], nb))
    if q.qe[nd] is not None:
        x = x.narrow(nd, *_part(mesh, q.qe[nd], _BLOCK))
    return x


def _q8_back(y: torch.Tensor, q: _Q8, mesh) -> torch.Tensor:
    """``_q8_region``'s inverse: the parameter block of every rank's new
    values on its moment block."""
    nd = len(q.shape)
    if q.qe[nd] is not None:
        y = all_gather_tiled(y, q.qe[nd], nd)
    if q.aligned:
        y = y.reshape(*y.shape[:-2], -1)
    else:
        if q.qe[nd - 1] is not None:
            y = all_gather_tiled(y, q.qe[nd - 1], nd - 1)
        y = y.reshape(*y.shape[:-2], -1)[..., :q.shape[-1]]
        if q.pe[-1] is not None:
            y = y.narrow(nd - 1, *_part(mesh, q.pe[-1], q.shape[-1]))
    for d in range(nd - 1):
        if q.qe[d] != q.pe[d]:
            if q.qe[d] is not None:
                y = all_gather_tiled(y, q.qe[d], d)
            if q.pe[d] is not None:
                y = y.narrow(d, *_part(mesh, q.pe[d], q.shape[d]))
    return y


def _q8_codec(q: _Q8):
    """The int8 moment's decode and encode on blocks [..., nblk_loc,
    256_loc], the single-device ``_q8`` element for element; a block split
    over data ranks takes its absmax over them."""
    def decode(s, like):
        del like
        return s["q"].to(torch.float32) * s["scale"]

    def encode(x):
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        if q.qe[-1] is not None:
            amax = pmax(amax, q.qe[-1])
        scale = amax / 127.0
        return {"q": torch.round(x / torch.clamp(scale, min=1e-12)).to(torch.int8),
                "scale": scale.to(torch.float32)}

    return decode, encode


def _q8_shapes(q: _Q8, mesh) -> tuple[tuple, tuple]:
    """This rank's ``q`` and ``scale`` block shapes."""
    shape = _mesh_shape(mesh)
    full = (*q.shape[:-1], -(-q.shape[-1] // _BLOCK), _BLOCK)
    qs = tuple(n // _axes_size(e, shape) for n, e in zip(full, q.qe))
    return qs, qs[:-1] + (1,)


def _slice(x: torch.Tensor, lay: _Leaf) -> torch.Tensor:
    return x.narrow(lay.dim, lay.lo, lay.hi - lay.lo) if lay.kind == "slice" else x


def _empty(dev) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32, device=dev)


def _moment_block(m, lay: _Leaf):
    """This rank's part of a global moment under ``lay`` (an int8 moment is
    always whole)."""
    if lay.kind == "layer" and not lay.own:
        return _empty(m.device)
    return _slice(m, lay)


def init_zero1_state(params, cfg: AdamWConfig, param_specs, shard_ctx) -> dict:
    """Zero moments of placed ``params``, each rank holding its ZeRO-1 part
    (``zero1_state_specs``) and nothing else."""
    lays = _layouts(params, param_specs, shard_ctx, cfg.moment_dtype)
    leaves = param_leaves(params)
    dev = next(iter(leaves.values())).device

    def zero(n):
        lay = lays[n]
        if lay.kind in ("layer", "q8") and not lay.own:
            return _empty(dev)
        if lay.kind == "q8":
            qs, ss = _q8_shapes(lay.q8, shard_ctx.mesh)
            return {"q": torch.zeros(qs, dtype=torch.int8, device=dev),
                    "scale": torch.zeros(ss, dtype=torch.float32, device=dev)}
        z = torch.zeros(_slice(leaves[n], lay).shape, dtype=torch.float32, device=dev)
        return _encode(z, cfg.moment_dtype)

    return {"m": {n: zero(n) for n in leaves}, "v": {n: zero(n) for n in leaves},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def place_opt_state(state, params, param_specs, shard_ctx, moment_dtype: str = "fp32"):
    """This rank's ZeRO-1 part of a global optimizer state (the port's, or
    the reference's tree as ``opt_state_from_tree`` reads it), next to
    ``params`` placed by ``param_specs``: each moment first placed as its
    parameter is, then sliced over the data axes."""
    if not isinstance(state["m"], dict) or any(isinstance(v, dict) and not is_q8_leaf(v)
                                               for v in state["m"].values()):
        state = opt_state_from_tree(state, params.stacked, "cpu")
    lays = _layouts(params, param_specs, shard_ctx, moment_dtype)
    mesh = shard_ctx.mesh
    dev = next(iter(params.parameters())).device

    def one(name, m):
        spec = spec_at(param_specs, name.split("."))
        lay = lays[name]
        if lay.kind == "q8":
            if not lay.own:
                return _empty(dev)
            return {"q": place(m["q"], P(*lay.q8.qe), mesh),
                    "scale": place(m["scale"], P(*lay.q8.qe[:-1], None), mesh)}
        if is_q8_leaf(m):
            base = P(*(list(spec) + [None] * (m["q"].ndim - len(spec))))
            blk = {"q": place(m["q"], base, mesh), "scale": place(m["scale"], P(
                *(list(base)[:-1] + [None])), mesh)}
        else:
            blk = place(m, spec, mesh)
        return _moment_block(blk, lays[name])

    return {"m": {n: one(n, v) for n, v in state["m"].items()},
            "v": {n: one(n, v) for n, v in state["v"].items()},
            "step": torch.as_tensor(state["step"]).to(device=dev, dtype=torch.int32)}


def _gather_moment(m, p_block: torch.Tensor, lay: _Leaf, data_axes, dtype: str):
    if lay.kind == "whole":
        return m
    if lay.kind == "layer":
        full = _decode(m, p_block) if lay.own else torch.zeros(
            p_block.shape, dtype=torch.float32, device=p_block.device)
        return _encode(psum(full, data_axes), dtype)
    return all_gather_tiled(m, data_axes, lay.dim)


def gather_opt_state(state, params, param_specs, shard_ctx, moment_dtype: str = "fp32",
                     root: int | None = None):
    """The global optimizer state (the port's, on every rank) from every
    rank's ZeRO-1 parts: gathered over the data axes, then as each
    moment's parameter is placed. With ``root`` it lands on that rank's
    host, one leaf at a time, and the other ranks get None."""
    from repro_torch.distributed.sharding import gather

    lays = _layouts(params, param_specs, shard_ctx, moment_dtype)
    leaves = param_leaves(params)
    da = tuple(shard_ctx.data_axes)
    mesh = shard_ctx.mesh

    def whole(name, m):
        spec = spec_at(param_specs, name.split("."))
        lay = lays[name]
        if lay.kind == "q8":
            q8 = lay.q8
            if q8.layer:  # the owners' layers, zeros elsewhere, summed
                qs, ss = _q8_shapes(q8, mesh)
                dev = leaves[name].device
                q = m["q"] if lay.own else torch.zeros(qs, dtype=torch.int8, device=dev)
                sc = m["scale"] if lay.own else torch.zeros(ss, dtype=torch.float32,
                                                             device=dev)
                m = {"q": psum(q.to(torch.int32), q8.layer).to(torch.int8),
                     "scale": psum(sc, q8.layer)}
            return {"q": gather(m["q"], P(*q8.qe), mesh, root),
                    "scale": gather(m["scale"], P(*q8.qe[:-1], None), mesh, root)}
        blk = _gather_moment(m, leaves[name], lay, da, moment_dtype)
        if is_q8_leaf(blk):
            base = P(*(list(spec) + [None] * (blk["q"].ndim - len(spec))))
            return {k: gather(v, base, mesh, root) for k, v in blk.items()}
        return gather(blk, spec, mesh, root)

    with bound(mesh):
        out = {k: {n: whole(n, v) for n, v in state[k].items()} for k in ("m", "v")}
    if root is not None and runtime() is not None and runtime().rank != root:
        return None
    return out | {"step": state["step"].cpu() if root is not None else state["step"]}


def _sharded_update(params, grads, state, cfg: AdamWConfig, lr, lays, shard_ctx):
    """``adamw_update`` on blocks: the clip norm over the whole gradient,
    then each data rank's ZeRO-1 slice updated and the slices gathered."""
    leaves = param_leaves(params)
    da = tuple(shard_ctx.data_axes)
    groups: dict = {}
    for n, g in grads.items():
        groups.setdefault(lays[n].axes, []).append(g)
    sq = torch.zeros((), dtype=torch.float32, device=state["step"].device)
    for axes, gs in sorted(groups.items()):
        part = _global_norm(gs) ** 2
        sq = sq + (psum(part, axes) if axes else part)
    gnorm = torch.sqrt(sq)
    step = state["step"] + 1
    scale, bc1, bc2 = _scale_and_corrections(gnorm, step, cfg)
    mesh = shard_ctx.mesh
    with torch.no_grad():
        for name, p in leaves.items():
            lay = lays[name]
            if lay.kind == "q8":
                q8 = lay.q8
                if lay.own:
                    new, state["m"][name], state["v"][name] = _leaf_step(
                        _q8_region(p, q8, mesh), _q8_region(grads[name], q8, mesh),
                        state["m"][name], state["v"][name], scale, bc1, bc2, lr, cfg,
                        codec=_q8_codec(q8))
                    new = _q8_back(new.to(p.dtype), q8, mesh)
                else:
                    new = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                p.copy_(psum(new, q8.layer) if q8.layer else new)
                continue
            if lay.kind == "layer" and not lay.own:
                new = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
            else:
                new, state["m"][name], state["v"][name] = _leaf_step(
                    _slice(p, lay), _slice(grads[name], lay), state["m"][name],
                    state["v"][name], scale, bc1, bc2, lr, cfg)
                new = new.to(p.dtype)
            if lay.kind == "layer":
                p.copy_(psum(new, da))
            elif lay.kind == "slice":
                p.copy_(all_gather_tiled(new, da, lay.dim))
            else:
                p.copy_(new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}


def opt_state_to_tree(state, stacked: tuple[str, ...] = ()) -> dict:
    """The optimizer state as the reference's tree of host numpy arrays
    (``init_opt_state``'s structure, stacked segments ``[L, ...]``)."""
    return {"m": flat_to_tree(state["m"], stacked), "v": flat_to_tree(state["v"], stacked),
            "step": host_array(state["step"])}


def opt_state_from_tree(tree, stacked: tuple[str, ...] = (), device=None, specs=None,
                        mesh=None) -> dict:
    """The reference's optimizer-state tree (numpy arrays or tensors) as the
    port's state on ``device``. A tree of this rank's blocks (a restore with
    ``shardings``) passes its moment specs and mesh: a stacked leaf whose
    layer dim is sharded holds layers [i * L_b, (i + 1) * L_b) of L, and the
    port's state names them so, with empty moments for the other layers."""
    def moments(t, mspecs):
        flat = {}
        for n, v in tree_to_flat(t, stacked).items():
            flat[n] = ({k: tensor_from_numpy(a, device) for k, a in v.items()}
                       if isinstance(v, dict) else tensor_from_numpy(v, device))
        if specs is None:
            return flat
        out = {}
        for n, v in flat.items():
            path, layer = _ref_key(n, stacked)
            spec = _node_at(mspecs, path) if layer is not None else None
            spec = tuple(spec["q"] if isinstance(spec, dict) else spec or ())
            if not spec or spec[0] is None:
                out[n] = v
                continue
            axes = (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
            idx, cnt = mesh_coord(mesh, axes)
            nb = _n_block_layers(t, path)
            rest = tuple(map(str, path[1:]))
            for i in range(nb * cnt):
                out.setdefault(".".join((path[0], str(i), *rest)), _empty(
                    torch.device(device) if device is not None else torch.device("cpu")))
            out[".".join((path[0], str(idx * nb + layer), *rest))] = v
        return out

    m_specs = specs["m"] if specs is not None else None
    v_specs = specs["v"] if specs is not None else None
    return {"m": moments(tree["m"], m_specs), "v": moments(tree["v"], v_specs),
            "step": tensor_from_numpy(tree["step"], device).to(torch.int32)}


def _node_at(tree, path):
    for c in path:
        tree = _at(tree, c)
    return tree


def _n_block_layers(tree, path) -> int:
    node = tree
    for c in path:
        node = _at(node, c)
    first = node["q"] if is_q8_leaf(node) else node
    return int(first.shape[0])


def _grads(loss_fn, params, batch, leaves):
    with trainable(params):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), grads


def make_train_step(
    loss_fn: Callable,  # loss_fn(params, batch) -> scalar
    opt_cfg: AdamWConfig,
    *,
    accum: int = 1,
    lr_schedule: Callable | None = None,
    donate: bool = True,
    shard_ctx=None,
    param_specs=None,
):
    """Build a train step: (params, opt_state, batch) -> updated, in place.
    ``donate`` is accepted for the reference's signature; the step always
    reuses its arguments' memory. With ``shard_ctx`` and ``param_specs``
    the step runs on placed trees (the module docstring); every rank calls
    it."""
    del donate
    layouts: dict = {}

    def default_lr(step):
        return torch.tensor(opt_cfg.lr, dtype=torch.float32, device=step.device)

    lr_schedule = lr_schedule or default_lr

    def step(params, opt_state, batch):
        leaves = param_leaves(params)
        if accum == 1:
            loss, grads = _grads(loss_fn, params, batch, leaves)
        else:
            # Microbatch accumulation: batch leaves carry a leading accum dim.
            dev = opt_state["step"].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves.values()]
            for i in range(accum):
                micro = {k: v[i] for k, v in batch.items()}
                lo, g = _grads(loss_fn, params, micro, leaves)
                loss = loss + lo
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / accum
            grads = [g / accum for g in grads]

        lr = lr_schedule(opt_state["step"])
        if shard_ctx is None:
            params, opt_state, metrics = adamw_update(
                params, dict(zip(leaves, grads)), opt_state, opt_cfg, lr
            )
        else:
            if not layouts:
                layouts.update(_layouts(params, param_specs, shard_ctx, opt_cfg.moment_dtype))
            with bound(shard_ctx.mesh):
                grads = {n: (psum(g, layouts[n].reduce) if layouts[n].reduce else g)
                         for n, g in zip(leaves, grads)}
                params, opt_state, metrics = _sharded_update(
                    params, grads, opt_state, opt_cfg, lr, layouts, shard_ctx)
        metrics = dict(metrics, loss=loss, lr=lr)
        return params, opt_state, metrics

    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    step_timeout_s: float = 0.0  # >0 enables the straggler watchdog
    lr: float = 3e-4
    warmup: int = 10
    moment_dtype: str = "fp32"
    grad_clip: float = 1.0
    accum: int = 1


class Trainer:
    """Host training loop with fault tolerance, on the parameters' device.

    * SIGTERM triggers checkpoint-and-exit (preemption handling);
    * the data iterator is (re)seeded from the persisted step counter, so a
      restore resumes the exact batch sequence;
    * a per-step watchdog counts steps exceeding ``step_timeout_s`` (the
      straggler hook).
    """

    def __init__(
        self,
        loss_fn,
        params,
        cfg: TrainerConfig,
        data_fn: Callable[[int], dict],  # step -> batch (deterministic)
        checkpointer=None,
    ):
        self.cfg = cfg
        self.opt_cfg = AdamWConfig(
            lr=cfg.lr, moment_dtype=cfg.moment_dtype, grad_clip=cfg.grad_clip
        )
        self.params = params
        self.device = next(iter(params.parameters())).device
        self.opt_state = init_opt_state(params, self.opt_cfg)
        self.data_fn = data_fn
        self.checkpointer = checkpointer
        self.step_fn = make_train_step(
            loss_fn,
            self.opt_cfg,
            accum=cfg.accum,
            lr_schedule=lambda s: cosine_with_warmup(
                s, peak=cfg.lr, warmup=cfg.warmup, total=cfg.total_steps
            ),
        )
        self.history: list[dict] = []
        self.slow_steps = 0
        self._preempted = False

    def _handle_preemption(self, signum, frame):
        del signum, frame
        self._preempted = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state(self) -> dict:
        stacked = self.params.stacked
        return {"params": params_to_tree(self.params),
                "opt_state": opt_state_to_tree(self.opt_state, stacked)}

    def restore(self):
        if self.checkpointer is None:
            return 0
        # To the host first: the live state leaves the card before the
        # restored one arrives (at full width both would not fit).
        state = self.checkpointer.restore_latest(device="cpu")
        if state is None:
            return 0
        stacked = self.params.stacked
        self.params = self.opt_state = None
        self.params = params_from_tree(state["params"], self.device, stacked)
        self.opt_state = opt_state_from_tree(state["opt_state"], stacked, self.device)
        return int(self.opt_state["step"])

    def run(self, install_signal_handlers: bool = True) -> dict:
        start_step = self.restore()
        if install_signal_handlers:
            signal.signal(signal.SIGTERM, self._handle_preemption)
        exit_reason = "completed"
        step = start_step
        for step in range(start_step, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = self.data_fn(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            # Step-boundary fence: dt must measure the whole device step.
            self._sync()
            dt = time.perf_counter() - t0
            if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
                self.slow_steps += 1  # straggler hook
            if (step + 1) % self.cfg.log_every == 0 or step == start_step:
                self.history.append(
                    {
                        "step": step + 1,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "time_s": dt,
                    }
                )
            if self.checkpointer and (step + 1) % self.cfg.checkpoint_every == 0:
                self.checkpointer.save(self._state(), step=step + 1)
            if self._preempted:
                if self.checkpointer:
                    self.checkpointer.save(self._state(), step=step + 1, blocking=True)
                exit_reason = "preempted"
                break
        if self.checkpointer:
            self.checkpointer.wait()
        return {
            "exit": exit_reason,
            "last_step": step + 1,
            "history": self.history,
            "slow_steps": self.slow_steps,
        }
