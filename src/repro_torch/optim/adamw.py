"""AdamW with float32, bfloat16 or 8-bit-quantized moments, on one device.

The counterpart of the JAX package's ``optim/adamw.py``, its arithmetic
operation for operation in float32 (not ``torch.optim.AdamW``, which puts
eps outside the bias correction of v, decays weights differently and has
no int8 or bfloat16 moments):

  * global norm over the gradients in the reference's flattening order
    (``layers.param_leaves``), clip scale ``min(1, clip / max(norm, 1e-9))``;
  * bias corrections from the step after the increment, as float32 powers;
  * ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
    ``delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd p``,
    ``p = (p - lr delta)`` cast to the parameter's type;
  * the moments encoded by the step's ``moment_dtype`` whatever the state
    held before (an fp32 state given to an int8 step comes back int8).

Int8 moments use block-wise absmax scaling along the last axis (block 256)
and keep the leading dimensions: p [..., D] -> q [..., D/256, 256] int8 +
scale [..., D/256, 1] float32. ``torch.round`` rounds half to even, as
``jnp.round`` does. Layer i of the reference's stacked q8 leaf is the q8 of
layer i, so per-layer moments stack into the reference's layout.

The state is ``{"m": {name: moment}, "v": {name: moment}, "step": int32}``
with the parameters' names (``layers.param_leaves``). ``adamw_update``
writes the parameters and the state in place and returns them (the
reference returns new trees and donates the old ones): at full width a
second copy of the moments would not fit beside the first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import param_leaves

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "is_q8_leaf"]

_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "fp32"  # "fp32" | "bf16" | "int8"


def is_q8_leaf(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _q8(x: torch.Tensor) -> dict:
    *lead, last = x.shape
    pad = (-last) % _BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    nb = (last + pad) // _BLOCK
    blocks = x.reshape(*lead, nb, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq8(s: dict, like: torch.Tensor) -> torch.Tensor:
    *lead, last = like.shape
    flat = (s["q"].to(torch.float32) * s["scale"]).reshape(*lead, -1)
    return flat[..., :last]


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _q8(x)
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    return x.to(torch.float32)


def _decode(s, like: torch.Tensor) -> torch.Tensor:
    if is_q8_leaf(s):
        return _dq8(s, like)
    return s.to(torch.float32)


def init_opt_state(params, cfg: AdamWConfig, device=None):
    """Zero moments for every leaf of ``params`` (a ``Params`` tree), on the
    parameters' device unless ``device`` is given."""
    leaves = param_leaves(params)
    dev = device if device is not None else next(iter(leaves.values())).device

    def zero_like(p):
        return _encode(torch.zeros(p.shape, dtype=torch.float32, device=dev),
                       cfg.moment_dtype)

    return {
        "m": {n: zero_like(p) for n, p in leaves.items()},
        "v": {n: zero_like(p) for n, p in leaves.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _global_norm(leaves) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in the given order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))


def _scale_and_corrections(gnorm: torch.Tensor, step: torch.Tensor, cfg: AdamWConfig):
    """The clip scale of a global norm and the bias corrections of ``step``
    (the step after the increment)."""
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, cfg.grad_clip / torch.clamp(gnorm, min=1e-9))
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    return scale, bc1, bc2


def _leaf_step(p, g, m_state, v_state, scale, bc1, bc2, lr, cfg: AdamWConfig,
               codec=None):
    """One leaf's update: (p's new value in float32, the encoded m and v).
    ``p`` and ``g`` are the whole leaf, or the same part of it. ``codec``,
    a pair ``(decode(state, like), encode(x))``, replaces the moment
    dtype's (the sharded step's int8 blocks)."""
    decode, encode = codec or (_decode, lambda x: _encode(x, cfg.moment_dtype))
    g = g.to(torch.float32) * scale
    m = cfg.b1 * decode(m_state, p)
    m += (1 - cfg.b1) * g
    v = cfg.b2 * decode(v_state, p)
    gg = (1 - cfg.b2) * g
    gg *= g
    v += gg
    del g, gg
    den = v / bc2
    den.sqrt_()
    den += cfg.eps
    delta = m / bc1
    delta /= den
    del den
    delta += cfg.weight_decay * p.to(torch.float32)
    delta *= lr
    new = p.to(torch.float32) - delta
    del delta
    return new, encode(m), encode(v)


def adamw_update(params, grads, state, cfg: AdamWConfig, lr):
    """One AdamW step. ``grads`` maps the parameters' names to gradients.
    Returns (params, state, metrics), the first two updated in place."""
    leaves = param_leaves(params)
    step = state["step"] + 1
    gnorm = _global_norm(grads[n] for n in leaves)
    scale, bc1, bc2 = _scale_and_corrections(gnorm, step, cfg)
    with torch.no_grad():
        for name, p in leaves.items():
            new, state["m"][name], state["v"][name] = _leaf_step(
                p, grads[name], state["m"][name], state["v"][name], scale, bc1, bc2, lr, cfg)
            p.copy_(new)
            del new
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
