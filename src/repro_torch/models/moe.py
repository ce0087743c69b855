"""Mixture-of-Experts FFN with capacity-based top-k routing, on one device.

The counterpart of the JAX package's ``models/moe.py`` without its mesh
(ROADMAP A7): every expert lives on the one device, so the routed combine
needs no collective. Routing is the reference's decision for decision,
because one index that differs flips a whole expert's output:
  * ``_route`` in float32; ``topk_first`` takes the lower expert index
    first among tied probabilities, as ``lax.top_k`` does;
  * ``_dispatch_ranks`` ranks each (token, slot) within its expert by a
    stable sort, and the first ``C`` of each expert are kept (capacity
    drops follow that rank);
  * dropped slots scatter into a trash row (``index_put_`` with
    ``accumulate=True``, as ``.at[].add``) and contribute nothing.

Under autograd only the gathered top-k probabilities carry a gradient into
the router: ``topk_first``'s integer keys are built from a view that
carries none, and the dispatch indices are integers. The gradient reaches
the experts through ``index_put_`` and the gather of their outputs, as
``.at[].add`` and the gather do in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, dot_f32, maximum, topk_first

__all__ = ["MoEConfig", "init_moe", "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    n_shared: int = 0  # shared experts, each d_ff wide
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def _stacked(key, n: int, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """[n, d_in, d_out], one ``dense_init`` an expert (no float32 copy of
    all n at once)."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    if torch.device(device).type != "meta":
        for e in range(n):
            out[e] = dense_init(key, d_in, d_out, dtype, device=device)
    return out


def init_moe(key, d_model: int, cfg: MoEConfig, dtype=torch.bfloat16, device=None):
    E, Fd = cfg.n_experts, cfg.d_ff
    p = Params(
        router=dense_init(key, d_model, E, torch.float32, device=device),
        w_gate=_stacked(key, E, d_model, Fd, dtype, device),
        w_up=_stacked(key, E, d_model, Fd, dtype, device),
        w_down=_stacked(key, E, Fd, d_model, dtype, device),
    )
    if cfg.n_shared:
        fs = cfg.n_shared * cfg.d_ff
        p["shared"] = Params(
            w_gate=dense_init(key, d_model, fs, dtype, device=device),
            w_up=dense_init(key, d_model, fs, dtype, device=device),
            w_down=dense_init(key, fs, d_model, dtype, device=device),
        )
    return p


def _route(router_w, x, cfg: MoEConfig):
    """float32 routing: renormalized top-k probs + Switch-style aux loss."""
    logits = dot_f32(x, router_w)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = topk_first(probs, cfg.top_k)  # [T, k]
    topv = topv / maximum(topv.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)  # mean router prob per expert
    ce = F.one_hot(topi[:, 0], cfg.n_experts).to(torch.float32).mean(0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return topv, topi, aux


def _dispatch_ranks(flat_e: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Rank of each (token, slot) within its bucket, via a stable sort."""
    N = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_buckets, dtype=sorted_e.dtype, device=flat_e.device),
        side="left")
    rank_sorted = torch.arange(N, device=flat_e.device) - starts[sorted_e]
    return torch.zeros(N, dtype=torch.int64, device=flat_e.device).scatter_(
        0, order, rank_sorted)


def _expert_ffn(p, buf):
    """buf [E_loc, C, d] through each expert's SwiGLU."""
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def _shared_ffn(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, int(c))


def _moe_compute(params, x, cfg: MoEConfig, e_lo, E_loc: int):
    """Dispatch/compute/combine for the expert slice [e_lo, e_lo + E_loc).

    Returns the partial output (zeros for slots owned by other ranks) and
    the aux loss; on one device the slice is every expert (``e_lo`` 0).
    """
    T, d = x.shape
    topv, topi, aux = _route(params["router"], x, cfg)
    k = cfg.top_k
    C = _capacity(T, cfg)

    flat_e = topi.reshape(-1)  # [T*k] global expert ids
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_loc)
    e_local = torch.where(local, flat_e - e_lo, E_loc)  # E_loc = trash
    rank = _dispatch_ranks(e_local, E_loc + 1)
    keep = local & (rank < C)

    e_idx = torch.where(keep, e_local, E_loc)
    c_idx = torch.where(keep, rank, C - 1)
    x_rep = torch.repeat_interleave(x, k, dim=0)  # [T*k, d]
    buf = torch.zeros((E_loc + 1, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, c_idx), torch.where(keep[:, None], x_rep, 0), accumulate=True)
    del x_rep

    y_buf = _expert_ffn(params, buf[:E_loc])
    y_buf = torch.cat([y_buf, torch.zeros((1, C, d), dtype=y_buf.dtype, device=x.device)])
    y_slots = torch.where(keep[:, None], y_buf[e_idx, c_idx], 0)
    w = topv.reshape(-1).to(x.dtype)
    y = (y_slots * w[:, None]).reshape(T, k, d).sum(dim=1)
    return y, aux


def moe_ffn(params, x2d: torch.Tensor, cfg: MoEConfig, shard_ctx=None):
    """MoE FFN over flat tokens x2d [T, d]. Returns (y [T, d], aux scalar)."""
    if shard_ctx is not None:
        raise NotImplementedError(
            "moe_ffn with a sharding context (experts sharded over the mesh's model "
            "axis, shard_map in the reference) is ROADMAP A7; pass shard_ctx=None")
    y, aux = _moe_compute(params, x2d, cfg, 0, cfg.n_experts)
    if cfg.n_shared:
        y = y + _shared_ffn(params["shared"], x2d)
    return y, aux


def moe_ffn_decode_ep_all(params, x2d: torch.Tensor, cfg: MoEConfig, shard_ctx):
    """Decode-time MoE with experts over the whole (data, model) grid."""
    raise NotImplementedError(
        "moe_ffn_decode_ep_all shards experts over the (data, model) mesh grid "
        "(shard_map in the reference); the mesh paths are ROADMAP A7")
