"""Shared model layers: RMSNorm, RoPE, SwiGLU, initializers, the parameter tree.

The counterpart of the JAX package's ``models/layers.py``. Blocks are plain
functions on tensors; a model's parameters are a ``Params`` tree (an
``nn.Module`` whose children are read as ``params["name"]``, as the
reference reads its nested dicts), so every block takes the reference's
arguments in its order. Normalisation statistics and softmaxes run in
float32 and cast back, as in the reference.

Numbers that differ silently between the two frameworks, kept the
reference's way here:
  * ``rope_freqs`` is built in float64 numpy and cast, and its rotation
    pairs are interleaved (``0::2``, ``1::2``), not split into halves;
  * a gather out of range reads the edge row (JAX clamps; torch raises);
  * ``jnp.dot(..., preferred_element_type=float32)`` of bfloat16 operands is
    ``dot_f32``: the operands widened to float32 (a bfloat16 product is
    exact in float32), the product and its sums in float32;
  * ``topk_first`` breaks ties by the lower position, as ``lax.top_k``
    does (``torch.topk`` does not promise an order among equal values).

``init_*`` draw from an explicit ``torch.Generator`` on the target device;
the draws are not JAX's, so the tests carry the reference's weights across
with ``params_from_tree`` (float32 and ``ml_dtypes`` bfloat16 bit for bit).
On the ``meta`` device the initializers allocate nothing.

Training reads the same tree. Its leaves stay frozen (``requires_grad``
off) for serving; ``trainable`` turns them on around a loss and its
backward pass only. ``param_leaves`` lists them in the reference's
flattening order (``jax.tree.leaves``: dict keys sorted, lists in order,
the L layers of a stacked leaf together), the order of the optimizer's
global norm; ``tree_to_flat`` and ``flat_to_tree`` carry a tree between the
port's per-layer names (``dense.3.attn.wq``) and the reference's stacked
layout (``dense/attn/wq[3]``), for checkpoints and for starting both
packages from one state. Numpy has no bfloat16: a bfloat16 leaf crosses to
numpy as a 2-byte void array of its bits (``V2``, what the reference's
checkpoints hold), and a ``V2`` array comes back as bfloat16. The
differentiated paths keep the reference's gradient at ties:
``jnp.maximum`` splits it (0.5 each), as ``torch.maximum`` does and
``torch.clamp`` does not, hence ``maximum``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.range_daat import resolve_device

__all__ = [
    "Params",
    "apply_rope",
    "dense_init",
    "dot_f32",
    "flat_to_tree",
    "gather_rows",
    "host_array",
    "is_bf16_bits",
    "make_generator",
    "maximum",
    "param_leaves",
    "params_from_tree",
    "params_to_tree",
    "rms_norm",
    "rms_norm_init",
    "rope_freqs",
    "swiglu",
    "swiglu_init",
    "tensor_from_numpy",
    "topk_first",
    "trainable",
    "tree_to_flat",
]

_LOW = 2**32 - 1


class Params(nn.Module):
    """A node of a parameter tree: tensors are (frozen) parameters, other
    nodes are children; ``p["w"]`` reads a child as the reference reads its
    dict, so the state-dict keys follow the reference's tree paths (a stacked
    ``[L, ...]`` leaf of the reference is layer ``i`` of an ``nn.ModuleList``:
    ``dense.attn.wq[i]`` is ``dense.i.attn.wq``). ``stacked`` names the
    root's children that the reference stacks (the LM's ``dense`` and
    ``moe`` segments)."""

    stacked: tuple[str, ...] = ()

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            self[name] = child

    def __setitem__(self, name: str, child) -> None:
        if isinstance(child, nn.Module):
            setattr(self, name, child)
        else:
            setattr(self, name, nn.Parameter(child, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list[str]:
        return [*self._parameters, *self._modules]


def make_generator(key, device) -> torch.Generator | None:
    """A generator on ``device`` from ``key`` (an int seed, or a generator
    already there); None on the meta device, which draws nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    if isinstance(key, torch.Generator):
        if key.device.type != dev.type:
            raise ValueError(f"generator on {key.device}, parameters on {dev}")
        return key
    return torch.Generator(device=dev).manual_seed(int(key))


def _normal(gen, shape, device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)


def dense_init(key, d_in: int, d_out: int, dtype=torch.bfloat16, scale: float = 1.0,
               device=None):
    """N(0, (scale / sqrt(d_in))^2) drawn in float32, cast to ``dtype``;
    ``key`` is a generator on ``device`` (None only on the meta device)."""
    std = scale / np.sqrt(d_in)
    return (_normal(key, (d_in, d_out), device) * std).to(dtype)


def rms_norm_init(d: int, dtype=torch.bfloat16, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dt)


def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[max_len, head_dim//2, 2] (cos, sin) rotary angle table (float32)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    ang = np.outer(t, inv)
    table = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's indexing: a negative index counts from the
    end, and an index still out of range reads the nearest edge row."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def apply_rope(x: torch.Tensor, rope: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    dt = x.dtype
    cs = gather_rows(rope, positions)  # [..., seq, hd//2, 2]
    cos = cs[..., 0][..., None, :]  # [..., seq, 1, hd//2]
    sin = cs[..., 1][..., None, :]
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(dt)


def swiglu_init(key, d_model: int, d_ff: int, dtype=torch.bfloat16, device=None):
    return Params(
        w_gate=dense_init(key, d_model, d_ff, dtype, device=device),
        w_up=dense_init(key, d_model, d_ff, dtype, device=device),
        w_down=dense_init(key, d_ff, d_model, dtype, device=device),
    )


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)`` for a float ``x``, its gradient split at a tie."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 products and sums, whatever the operands' type
    (the reference's ``preferred_element_type=jnp.float32``)."""
    return a.float() @ b.float()


def topk_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest float32 values of ``x`` along its last dim and their
    positions, largest first, ties by lower position (``lax.top_k``). One
    int64 key per value: the float's order-preserving int32 image (a total
    order, -0.0 below +0.0) above ``2^32 - 1 - position``."""
    x = x.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    idx = torch.topk((ordered << 32) | (_LOW - pos), k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def is_bf16_bits(dtype: np.dtype) -> bool:
    """``ml_dtypes`` bfloat16, or the 2-byte void a checkpoint stores it as."""
    return dtype.itemsize == 2 and (dtype.name == "bfloat16" or dtype.kind == "V")


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A numpy array of the JAX package as a tensor on ``device``, bit for
    bit: ``ml_dtypes`` bfloat16 and a ``V2`` array cross as bfloat16 with
    their 16-bit patterns. A tensor is moved as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    a = np.asarray(arr)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if is_bf16_bits(a.dtype):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def host_array(t) -> np.ndarray:
    """A snapshot of a tensor (or array) as a host numpy array, bfloat16 as
    ``V2`` bits. A CPU tensor is copied too: training updates it in place."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def params_from_tree(tree, device, stacked: tuple[str, ...] = ()) -> Params:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays) as a ``Params`` on ``device``. A key in ``stacked`` holds leaves
    stacked ``[L, ...]`` for ``lax.scan``; it becomes an ``nn.ModuleList``
    of L layers, layer ``i`` holding every leaf's ``[i]``."""
    dev = resolve_device(device)

    def node(t):
        if isinstance(t, dict):
            return Params(**{k: node(v) for k, v in t.items()})
        if isinstance(t, (list, tuple)):
            return nn.ModuleList([node(v) for v in t])
        return tensor_from_numpy(t, dev)

    def unstack(t):
        n = len(next(iter(_leaves(t))))
        return nn.ModuleList([node(_index(t, i)) for i in range(n)])

    out = Params()
    out.stacked = tuple(stacked)
    for name, child in tree.items():
        out[name] = unstack(child) if name in stacked else node(child)
    return out


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _index(t, i: int):
    return {k: _index(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]


# ------------------------------------------------------------ training trees


def _ref_key(name: str, stacked: tuple[str, ...]):
    """A port name's place in the reference's tree: (path, layer), layer None
    for a leaf that is not stacked. List indices are ints, so that sorting
    keys gives ``jax.tree.leaves``' order."""
    parts = name.split(".")
    layer = None
    if parts[0] in stacked:
        layer = int(parts[1])
        parts = [parts[0], *parts[2:]]
    return tuple(int(c) if c.isdigit() else c for c in parts), layer


def _order(names, stacked) -> list[str]:
    def key(n):
        path, layer = _ref_key(n, stacked)
        return path, -1 if layer is None else layer
    return sorted(names, key=key)


def param_leaves(params) -> dict[str, torch.Tensor]:
    """Every leaf of a ``Params`` tree by name, in the reference's order."""
    named = dict(params.named_parameters())
    return {n: named[n] for n in _order(named, params.stacked)}


@contextlib.contextmanager
def trainable(params):
    """The tree's leaves require gradients inside the block, and are frozen
    again after it (serving never sees them differentiable)."""
    leaves = list(params.parameters())
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _map_leaf(fn, leaf):
    return {k: fn(v) for k, v in leaf.items()} if _is_q8(leaf) else fn(leaf)


def flat_to_tree(flat: dict, stacked: tuple[str, ...] = ()) -> dict:
    """Port-named leaves (tensors, or int8 moments ``{"q", "scale"}``) as the
    reference's nested tree of host numpy arrays (``host_array``): the
    layers of a stacked segment become one ``[L, ...]`` leaf, lists become
    lists."""
    root: dict = {}
    layers: dict = {}
    for name, value in flat.items():
        path, layer = _ref_key(name, stacked)
        if layer is None:
            _put(root, path, _map_leaf(host_array, value))
        else:
            layers.setdefault(path, []).append((layer, value))
    for path, items in layers.items():
        items = [v for _, v in sorted(items, key=lambda lv: lv[0])]
        if _is_q8(items[0]):
            value = {k: np.stack([host_array(v[k]) for v in items]) for k in items[0]}
        else:
            value = np.stack([host_array(v) for v in items])
        _put(root, path, value)
    return _listify(root)


def tree_to_flat(tree, stacked: tuple[str, ...] = ()) -> dict:
    """The reference's nested tree as port-named leaves (the inverse of
    ``flat_to_tree``): a stacked ``[L, ...]`` leaf becomes L layers' leaves;
    an int8 moment ``{"q", "scale"}`` stays one leaf."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and not _is_q8(node):
            for k, v in node.items():
                walk(v, (*path, str(k)))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, (*path, str(i)))
        elif path[0] in stacked:
            first = node["q"] if _is_q8(node) else node
            for i in range(first.shape[0]):
                out[".".join((path[0], str(i), *path[1:]))] = _map_leaf(
                    lambda a, i=i: a[i], node)
        else:
            out[".".join(path)] = node

    walk(tree, ())
    return out


def _put(root: dict, path: tuple, value) -> None:
    node = root
    for c in path[:-1]:
        node = node.setdefault(c, {})
    node[path[-1]] = value


def _listify(node):
    """Dicts keyed by list indices (ints) become lists."""
    if not isinstance(node, dict) or _is_q8(node):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def params_to_tree(params) -> dict:
    """A ``Params`` tree as the reference's nested numpy tree (the inverse of
    ``params_from_tree``)."""
    return flat_to_tree(param_leaves(params), params.stacked)
