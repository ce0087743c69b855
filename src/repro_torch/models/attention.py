"""Attention variants for the LM architectures: GQA and MLA.

The counterpart of the JAX package's ``models/attention.py``:
  * GQA with optional per-head QK RMSNorm (qwen3) and QKV bias (qwen2.5).
    Queries are reshaped to [B, S, KV, G, D] instead of repeating the KV
    heads G times.
  * MLA (DeepSeek-V2/V3): low-rank compressed KV; the cache stores only
    (c_kv, k_rope) per token. This is the reference's baseline path, which
    expands the compressed cache to per-head K/V on every call.

Full-sequence paths are query-chunked, so scores never exceed
[B, KV, G, chunk, T]. The score product runs in float32 (the reference's
``preferred_element_type``), the mask is the reference's ``_NEG = -1e30``
on causality and on the cache tail (``kv_valid_len``), the softmax in
float32, cast to the values' type for the weighted sum. No fused attention
(``F.scaled_dot_product_attention``) is used: it would not reproduce that
mask. A cache is updated in place (the reference returns a new one): the
returned cache is the one passed in, written at the clamped start
``min(max(cache_pos, 0), Smax - S)`` as ``lax.dynamic_update_slice`` does.

On a mesh (a ``ShardCtx``; ``distributed.sharding``) the functions take
this rank's blocks of placed parameters and caches and an activation that
is this rank's batch rows, replicated over ``model``:

  * ``gqa_tp``/``mla_tp`` are ``gqa``/``mla`` under the training and
    baseline specs (``transformer.param_specs``), which the reference
    leaves to GSPMD: each rank computes the heads of its ``wq``/``w_uq``
    columns (KV heads replicated unless the spec shards them), its rows of
    ``wo`` give a partial product, and one ``psum`` over ``model`` sums
    them. A batch-layout cache is replicated over ``model``: every rank
    writes every KV head.
  * ``gqa_decode_splitkv``, ``mla_decode_splitkv`` and
    ``gqa_prefill_splitkv`` are the reference's ``shard_map`` bodies over
    the cache sharded batch x sequence = data x model: each rank attends
    over its slice, the partial softmaxes merge through ``pmax`` and one
    ``psum`` (``_splitkv_merge``), the new token goes to the rank that
    owns its slot, and the row-sharded input projections are a partial
    product of the rank's feature slice and a ``psum``. ``wo`` and
    ``w_uq`` stay row-sharded as ``param_specs_splitkv`` stores them: a
    partial product and a ``psum`` (the reference's body asks for them
    column-sharded, which GSPMD reaches by resharding the weight on every
    call; the sum is the same). The three take any number of new tokens
    on MLA, so a split-layout prefill chunk runs through
    ``mla_decode_splitkv`` too.

A row-sharded contraction's partial product is taken in float32 and
summed in float32 (``rows_psum``), then cast to the activations' type:
one rounding, as the one-device product's, where bfloat16 partials
summed in bfloat16 would add one a rank (over 36 layers of qwen3-4b
that moved the decode logits by 6% relative L2 on an H100).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    axis_index,
    axis_size,
    bound,
    pmax,
    psum,
    sum_grads,
)
from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    dot_f32,
    rms_norm,
    rms_norm_init,
)

__all__ = ["GQAConfig", "MLAConfig", "init_gqa", "gqa", "init_mla", "mla", "gqa_tp", "mla_tp",
           "gqa_decode_splitkv", "mla_decode_splitkv", "gqa_prefill_splitkv", "rows_psum"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 copy of ``x`` (one pass, whatever its layout)."""
    return torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)


def _grouped_attention(q5, k, v, *, q_positions, kv_valid_len, chunk: int):
    """Causal grouped attention.

    q5: [B, S, KV, G, Dk]; k: [B, T, KV, Dk]; v: [B, T, KV, Dv].
    q_positions: [S] absolute position of each query row.
    kv_valid_len: keys at index >= this are masked (cache tail);
                  causality additionally masks keys beyond each query's pos.
    Returns [B, S, KV, G, Dv].
    """
    B, S, KV, G, Dk = q5.shape
    T = k.shape[1]
    scale = 1.0 / np.sqrt(Dk)
    if S % chunk != 0:
        chunk = S
    kpos = torch.arange(T, device=k.device)
    # One contiguous copy each: keys as float32 [B, KV, Dk, T], values
    # [B, KV, T, Dv]; the G query heads of a KV head fold into the rows.
    kt = _f32_copy(k.permute(0, 2, 3, 1))
    vt = v.permute(0, 2, 1, 3).contiguous()
    outs = []
    for c0 in range(0, S, chunk):
        qc = q5[:, c0:c0 + chunk].permute(0, 2, 3, 1, 4)  # [B, KV, G, C, Dk]
        C = qc.shape[3]
        qc = _f32_copy(qc)
        s = torch.matmul(qc.view(B, KV, G * C, Dk), kt).view(B, KV, G, C, T)
        s *= scale
        pc = q_positions[c0:c0 + chunk]
        mask = (kpos[None, :] <= pc[:, None]) & (kpos[None, :] < kv_valid_len)
        s.masked_fill_(~mask, _NEG)
        w = torch.softmax(s, dim=-1)
        del s
        w = w.to(v.dtype)
        o = torch.matmul(w.view(B, KV, G * C, T), vt).view(B, KV, G, C, -1)
        outs.append(o.permute(0, 3, 1, 2, 4))  # [B, C, KV, G, Dv]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, cache_pos) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, new, (0, cache_pos, ...))`` in place:
    the start clamps so that the update fits."""
    S = new.shape[1]
    start = min(max(int(cache_pos), 0), buf.shape[1] - S)
    buf[:, start:start + S] = new.to(buf.dtype)
    return buf


# --------------------------------------------------------------------- GQA


def init_gqa(key, cfg: GQAConfig, dtype=torch.bfloat16, device=None):
    p = Params(
        wq=dense_init(key, cfg.d_model, cfg.n_heads * cfg.head_dim, dtype, device=device),
        wk=dense_init(key, cfg.d_model, cfg.n_kv_heads * cfg.head_dim, dtype, device=device),
        wv=dense_init(key, cfg.d_model, cfg.n_kv_heads * cfg.head_dim, dtype, device=device),
        wo=dense_init(key, cfg.n_heads * cfg.head_dim, cfg.d_model, dtype, device=device),
    )
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * cfg.head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * cfg.head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * cfg.head_dim,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(cfg.head_dim, dtype, device)
        p["k_norm"] = rms_norm_init(cfg.head_dim, dtype, device)
    return p


def gqa(
    params,
    x: torch.Tensor,  # [B, S, d]
    rope_table: torch.Tensor,
    cfg: GQAConfig,
    *,
    positions,  # [S] absolute positions of x's rows
    cache: dict | None = None,  # {"k": [B, Smax, KV, D], "v": ...}, updated in place
    cache_pos=None,  # tokens already cached
    chunk: int = 512,
):
    """Returns (out [B, S, d], cache)."""
    B, S, _ = x.shape
    positions = torch.as_tensor(positions, device=x.device)
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, rope_table, positions)
    k = apply_rope(k, rope_table, positions)
    q5 = q.reshape(B, S, cfg.n_kv_heads, cfg.group, cfg.head_dim)

    if cache is not None:
        k_all = _write_cache(cache["k"], k, cache_pos)
        v_all = _write_cache(cache["v"], v, cache_pos)
        valid = int(cache_pos) + S
    else:
        k_all, v_all = k, v
        valid = S

    out = _grouped_attention(
        q5, k_all, v_all, q_positions=positions, kv_valid_len=valid, chunk=chunk
    )
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], cache


# --------------------------------------------------------------------- MLA


def init_mla(key, cfg: MLAConfig, dtype=torch.bfloat16, device=None):
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return Params(
        w_dq=dense_init(key, cfg.d_model, cfg.q_lora_rank, dtype, device=device),
        q_norm=rms_norm_init(cfg.q_lora_rank, dtype, device),
        w_uq=dense_init(key, cfg.q_lora_rank, cfg.n_heads * qk_head, dtype, device=device),
        w_dkv=dense_init(
            key, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype, device=device
        ),
        kv_norm=rms_norm_init(cfg.kv_lora_rank, dtype, device),
        w_uk=dense_init(
            key, cfg.kv_lora_rank, cfg.n_heads * cfg.qk_nope_head_dim, dtype, device=device
        ),
        w_uv=dense_init(
            key, cfg.kv_lora_rank, cfg.n_heads * cfg.v_head_dim, dtype, device=device
        ),
        wo=dense_init(key, cfg.n_heads * cfg.v_head_dim, cfg.d_model, dtype, device=device),
    )


def mla(
    params,
    x: torch.Tensor,
    rope_table: torch.Tensor,
    cfg: MLAConfig,
    *,
    positions,
    cache: dict | None = None,  # {"c_kv": [B, Smax, R], "k_rope": [B, Smax, rd]}
    cache_pos=None,
    chunk: int = 512,
):
    """MLA attention. The cache stores the compressed (c_kv, k_rope) only,
    and this baseline path expands it to per-head K/V on every call."""
    B, S, _ = x.shape
    H = cfg.n_heads
    positions = torch.as_tensor(positions, device=x.device)
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    cq = rms_norm(x @ params["w_dq"], params["q_norm"])
    q = (cq @ params["w_uq"]).reshape(B, S, H, qk_head)
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], rope_table, positions)

    dkv = x @ params["w_dkv"]
    c_kv = rms_norm(dkv[..., : cfg.kv_lora_rank], params["kv_norm"])
    k_rope = apply_rope(
        dkv[..., cfg.kv_lora_rank:][:, :, None, :], rope_table, positions
    )[:, :, 0, :]  # shared single rope head [B, S, rope_dim]

    if cache is not None:
        c_kv_all = _write_cache(cache["c_kv"], c_kv, cache_pos)
        k_rope_all = _write_cache(cache["k_rope"], k_rope, cache_pos)
        valid = int(cache_pos) + S
    else:
        c_kv_all, k_rope_all = c_kv, k_rope
        valid = S
    T = c_kv_all.shape[1]

    # Effective per-head keys: concat(up-projected nope, shared rope head).
    k_nope = (c_kv_all @ params["w_uk"]).reshape(B, T, H, cfg.qk_nope_head_dim)
    k_eff = torch.cat(
        [k_nope, k_rope_all[:, :, None, :].expand(B, T, H, cfg.qk_rope_head_dim)], dim=-1
    )
    del k_nope
    v = (c_kv_all @ params["w_uv"]).reshape(B, T, H, cfg.v_head_dim)
    q_eff = torch.cat([q_nope, q_rope], dim=-1)

    out = _grouped_attention(
        q_eff.reshape(B, S, H, 1, qk_head),
        k_eff,
        v,
        q_positions=positions,
        kv_valid_len=valid,
        chunk=chunk,
    )
    out = out.reshape(B, S, H * cfg.v_head_dim)
    return out @ params["wo"], cache


# ------------------------------------------------ tensor parallel (mesh)


def _kv_sharded(cfg: GQAConfig) -> bool:
    """Whether ``param_specs`` shards wk/wv over model (``_attn_specs``)."""
    return cfg.n_kv_heads * cfg.head_dim % 16 == 0 and cfg.n_kv_heads >= 16


def _head_groups(k, v, q, h_lo: int, group: int):
    """The KV heads this rank's query heads [h_lo, h_lo + H_loc) read, and
    the queries grouped over them: (q5 [B, S, KV', G', D], k, v)."""
    B, S, H_loc, D = q.shape
    if H_loc % group == 0 and h_lo % group == 0:
        kv_lo = h_lo // group
        n = H_loc // group
        return q.reshape(B, S, n, group, D), k[:, :, kv_lo:kv_lo + n], v[:, :, kv_lo:kv_lo + n]
    sel = (h_lo + torch.arange(H_loc, device=q.device)) // group
    return q.reshape(B, S, H_loc, 1, D), k[:, :, sel], v[:, :, sel]


def rows_psum(a: torch.Tensor, w: torch.Tensor, ax: str, dtype,
              partial: bool = False) -> torch.Tensor:
    """``a @ w`` summed over ``ax``, each rank holding its rows of the
    contraction: the partial product and the sum in float32, the result in
    ``dtype``. With ``partial`` the float32 partial product, for the caller
    to reduce (a sequence-parallel layer's reduce-scatter)."""
    y = dot_f32(a, w)
    return y if partial else psum(y, ax).to(dtype)


def gqa_tp(params, x, rope_table, cfg: GQAConfig, shard_ctx, *, positions, cache=None,
           cache_pos=None, chunk: int = 512, partial: bool = False):
    """``gqa`` on a mesh under ``param_specs``: this rank's query heads
    (its columns of wq), all KV heads unless the spec shards wk/wv, its
    rows of wo and one ``psum`` over model (``partial``: none, the float32
    partial output). ``cache`` (batch layout, replicated over model) is
    written in place with every KV head."""
    from repro_torch.distributed.sharding import all_gather_tiled

    ax = shard_ctx.model_axis
    with bound(shard_ctx.mesh):
        M, m = axis_size(ax), axis_index(ax)
        B, S, _ = x.shape
        positions = torch.as_tensor(positions, device=x.device)
        H_loc = cfg.n_heads // M
        xf = sum_grads(x, ax)
        q = xf @ params["wq"]
        if cfg.qkv_bias:
            q = q + params["bq"]
        q = q.reshape(B, S, H_loc, cfg.head_dim)
        kv_sh = _kv_sharded(cfg)
        src = xf if kv_sh else x
        k = src @ params["wk"]
        v = src @ params["wv"]
        if cfg.qkv_bias:
            k, v = k + params["bk"], v + params["bv"]
        k = k.reshape(B, S, -1, cfg.head_dim)
        v = v.reshape(B, S, -1, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, sum_grads(params["q_norm"], ax))
            k = rms_norm(k, sum_grads(params["k_norm"], ax) if kv_sh else params["k_norm"])
        q = apply_rope(q, rope_table, positions)
        k = apply_rope(k, rope_table, positions)
        kv_lo = m * (cfg.n_kv_heads // M) if kv_sh else 0
        if cache is not None:
            k_new = all_gather_tiled(k, ax, 2) if kv_sh else k
            v_new = all_gather_tiled(v, ax, 2) if kv_sh else v
            k_all = _write_cache(cache["k"], k_new, cache_pos)
            v_all = _write_cache(cache["v"], v_new, cache_pos)
            valid = int(cache_pos) + S
        else:
            k_all, v_all, valid = k, v, S
        if kv_sh:
            if cache is not None:
                n = cfg.n_kv_heads // M
                k_all, v_all = k_all[:, :, kv_lo:kv_lo + n], v_all[:, :, kv_lo:kv_lo + n]
            q5 = q.reshape(B, S, -1, cfg.group, cfg.head_dim)
        else:
            q5, k_all, v_all = _head_groups(sum_grads(k_all, ax), sum_grads(v_all, ax), q,
                                            m * H_loc, cfg.group)
        out = _grouped_attention(q5, k_all, v_all, q_positions=positions,
                                 kv_valid_len=valid, chunk=chunk)
        out = out.reshape(B, S, H_loc * cfg.head_dim)
        return rows_psum(out, params["wo"], ax, x.dtype, partial), cache


def mla_tp(params, x, rope_table, cfg: MLAConfig, shard_ctx, *, positions, cache=None,
           cache_pos=None, chunk: int = 512, partial: bool = False):
    """``mla`` on a mesh under ``param_specs``: the compressed (c_kv,
    k_rope) and the query's low-rank path replicated, this rank's heads of
    w_uq/w_uk/w_uv, its rows of wo and one ``psum`` over model
    (``partial``: none, the float32 partial output)."""
    ax = shard_ctx.model_axis
    with bound(shard_ctx.mesh):
        M = axis_size(ax)
        B, S, _ = x.shape
        H_loc = cfg.n_heads // M
        positions = torch.as_tensor(positions, device=x.device)
        qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        cq = sum_grads(rms_norm(x @ params["w_dq"], params["q_norm"]), ax)
        q = (cq @ params["w_uq"]).reshape(B, S, H_loc, qk_head)
        q_nope = q[..., : cfg.qk_nope_head_dim]
        q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], rope_table, positions)
        dkv = x @ params["w_dkv"]
        c_kv = rms_norm(dkv[..., : cfg.kv_lora_rank], params["kv_norm"])
        k_rope = apply_rope(
            dkv[..., cfg.kv_lora_rank:][:, :, None, :], rope_table, positions)[:, :, 0, :]
        if cache is not None:
            c_kv = _write_cache(cache["c_kv"], c_kv, cache_pos)
            k_rope = _write_cache(cache["k_rope"], k_rope, cache_pos)
            valid = int(cache_pos) + S
        else:
            valid = S
        c_kv, k_rope = sum_grads(c_kv, ax), sum_grads(k_rope, ax)
        T = c_kv.shape[1]
        k_nope = (c_kv @ params["w_uk"]).reshape(B, T, H_loc, cfg.qk_nope_head_dim)
        k_eff = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, T, H_loc, cfg.qk_rope_head_dim)],
            dim=-1)
        del k_nope
        v = (c_kv @ params["w_uv"]).reshape(B, T, H_loc, cfg.v_head_dim)
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        out = _grouped_attention(q_eff.reshape(B, S, H_loc, 1, qk_head), k_eff, v,
                                 q_positions=positions, kv_valid_len=valid, chunk=chunk)
        out = out.reshape(B, S, H_loc * cfg.v_head_dim)
        return rows_psum(out, params["wo"], ax, x.dtype, partial), cache


# ----------------------------------------------------- split-KV decode (mesh)
#
# The KV cache sharded along the SEQUENCE axis over the mesh's model axis
# (flash-decoding): every rank attends over its 1/M of the context and the
# partial softmaxes merge with the (max, sumexp, weighted-sum) reduction.


def _splitkv_merge(mi, li, oi, axis_name):
    """Merge per-chunk partial softmax results across ``axis_name``.

    mi/li [..., 1] chunk max / sumexp; oi [..., D] chunk weighted sum. The
    two sums ride one ``psum``.
    """
    M = pmax(mi, axis_name)
    scale = torch.exp(mi - M)
    D = oi.shape[-1]
    both = psum(torch.cat([oi * scale, li * scale], dim=-1), axis_name)
    num, den = both[..., :D], both[..., D:]
    return num / torch.clamp(den, min=1e-30)


def _feature_block(x, m: int, M: int):
    """This rank's slice of x's last (feature) dim, the reference's
    ``P(..., model)`` in_spec."""
    d = x.shape[-1] // M
    return x[..., m * d:(m + 1) * d]


def _rows_psum(out, w, ax: str, m: int):
    """``out @ w_full`` with ``w`` this rank's contiguous rows of it: the
    partial product of the matching slice of ``out``, summed over ``ax``
    (``rows_psum``)."""
    n = w.shape[0]
    return rows_psum(out[..., m * n:(m + 1) * n], w, ax, out.dtype)


def _write_owned(buf, new, pos: int, m: int):
    """Write the new rows (positions [pos, pos + S)) that fall in this
    rank's slice [m * S_loc, (m + 1) * S_loc) of the sequence, in place."""
    S_loc, S = buf.shape[1], new.shape[1]
    lo, hi = max(pos, m * S_loc), min(pos + S, (m + 1) * S_loc)
    if lo < hi:
        buf[:, lo - m * S_loc:hi - m * S_loc] = new[:, lo - pos:hi - pos].to(buf.dtype)


def _local_softmax(logits, valid):
    """Masked partial softmax over the local slice: (max, sumexp, p)."""
    logits = torch.where(valid, logits, torch.full_like(logits, _NEG))
    mi = torch.amax(logits, dim=-1, keepdim=True)
    pexp = torch.where(valid, torch.exp(logits - mi), torch.zeros_like(logits))
    return mi, torch.sum(pexp, dim=-1, keepdim=True), pexp


def _gqa_split(params, x, rope_table, cfg: GQAConfig, cache, pos: int, shard_ctx,
               q_sub: int):
    ax = shard_ctx.model_axis
    M, m = axis_size(ax), axis_index(ax)
    B, S, _ = x.shape
    dev = x.device
    positions = pos + torch.arange(S, device=dev)
    xm = _feature_block(x, m, M)
    nq = cfg.n_heads * cfg.head_dim
    nk = cfg.n_kv_heads * cfg.head_dim
    qkv = rows_psum(xm, torch.cat([params["wq"], params["wk"], params["wv"]], -1), ax,
                    x.dtype)
    q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, rope_table, positions)
    k = apply_rope(k, rope_table, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    _write_owned(k_cache, k, pos, m)
    _write_owned(v_cache, v, pos, m)

    S_loc = k_cache.shape[1]
    scale = 1.0 / np.sqrt(cfg.head_dim)
    kt = k_cache.permute(0, 2, 3, 1).float()  # [B, KV, D, S_loc]
    vt = v_cache.permute(0, 2, 1, 3).float()  # [B, KV, S_loc, D]
    kpos = m * S_loc + torch.arange(S_loc, device=dev)
    q5 = q.reshape(B, S, cfg.n_kv_heads, cfg.group, cfg.head_dim)
    nsub = max(S // q_sub, 1)
    sub = S // nsub
    outs = []
    for s0 in range(0, S, sub):
        qc = q5[:, s0:s0 + sub].permute(0, 2, 3, 1, 4).float()  # [B, KV, G, sub, D]
        C = qc.shape[3]
        logits = torch.matmul(qc.reshape(B, cfg.n_kv_heads, cfg.group * C, cfg.head_dim),
                              kt).view(B, cfg.n_kv_heads, cfg.group, C, S_loc) * scale
        valid = (kpos[None, :] <= positions[s0:s0 + sub, None])[None, None, None]
        mi, li, pexp = _local_softmax(logits, valid)
        oi = torch.matmul(pexp.view(B, cfg.n_kv_heads, cfg.group * C, S_loc), vt).view(
            B, cfg.n_kv_heads, cfg.group, C, cfg.head_dim)
        outs.append(_splitkv_merge(mi, li, oi, ax))  # [B, KV, G, sub, D]
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, nq).to(x.dtype)
    return _rows_psum(out, params["wo"], ax, m), cache


def gqa_decode_splitkv(params, x, rope_table, cfg: GQAConfig, cache, cache_pos, shard_ctx):
    """GQA decode step with the seq-sharded cache. x [B_loc, 1, d] (this
    rank's batch rows); ``params`` this rank's blocks under
    ``param_specs_splitkv``; ``cache`` {"k", "v"} [B_loc, S/M, KV, D],
    written in place on the rank that owns position ``cache_pos``."""
    with bound(shard_ctx.mesh):
        return _gqa_split(params, x, rope_table, cfg, cache, int(cache_pos), shard_ctx, 1)


def gqa_prefill_splitkv(params, x, rope_table, cfg: GQAConfig, cache, chunk_idx, shard_ctx,
                        q_sub: int = 512):
    """One prefill chunk with the seq-sharded cache. x [B_loc, C, d] with C
    == S_max / n_model: rank ``chunk_idx`` owns the whole write, and every
    rank scores the chunk's queries (``q_sub`` at a time) against its slice,
    merged as in decode. The cache layout is ``gqa_decode_splitkv``'s."""
    with bound(shard_ctx.mesh):
        C = x.shape[1]
        return _gqa_split(params, x, rope_table, cfg, cache, int(chunk_idx) * C, shard_ctx,
                          q_sub)


def mla_decode_splitkv(params, x, rope_table, cfg: MLAConfig, cache, cache_pos, shard_ctx):
    """MLA decode over the seq-sharded compressed cache with ABSORBED
    matmuls: q_nope @ w_uk folds into the query, so attention runs in the
    kv_lora_rank space; w_uk/w_uv are replicated, every other projection
    row-sharded (a partial product of the rank's slice and a ``psum``).
    x [B_loc, S, d] for S >= 1 new tokens at ``cache_pos``; ``cache``
    {"c_kv", "k_rope"} [B_loc, S_max/M, ·], written in place by the ranks
    that own the new positions."""
    ax = shard_ctx.model_axis
    H, R = cfg.n_heads, cfg.kv_lora_rank
    with bound(shard_ctx.mesh):
        M, m = axis_size(ax), axis_index(ax)
        B, S, _ = x.shape
        dev = x.device
        pos = int(cache_pos)
        positions = pos + torch.arange(S, device=dev)
        xm = _feature_block(x, m, M)
        nq = params["w_dq"].shape[1]
        both = rows_psum(xm, torch.cat([params["w_dq"], params["w_dkv"]], -1), ax, x.dtype)
        cq = rms_norm(both[..., :nq], params["q_norm"])  # [B, S, q_lora] replicated
        qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        q = _rows_psum(cq, params["w_uq"], ax, m).reshape(B, S, H, qk_head)
        q_nope = q[..., : cfg.qk_nope_head_dim]
        q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], rope_table, positions)
        dkv = both[..., nq:]
        c_new = rms_norm(dkv[..., :R], params["kv_norm"])
        kr_new = apply_rope(dkv[..., R:][:, :, None, :], rope_table, positions)[:, :, 0, :]
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        _write_owned(c_kv, c_new, pos, m)
        _write_owned(k_rope, kr_new, pos, m)

        S_loc = c_kv.shape[1]
        w_uk = params["w_uk"].reshape(R, H, cfg.qk_nope_head_dim)
        q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)  # [B, S, H, R]
        scale = 1.0 / np.sqrt(qk_head)
        # One batched product a batch row: the H heads' S queries as rows.
        ckv = c_kv.float()  # [B, S_loc, R]
        logits = (
            torch.bmm(q_abs.float().permute(0, 2, 1, 3).reshape(B, H * S, R),
                      ckv.transpose(1, 2))
            + torch.bmm(q_rope.float().permute(0, 2, 1, 3).reshape(B, H * S, -1),
                        k_rope.float().transpose(1, 2))
        ).view(B, H, S, S_loc) * scale
        kpos = m * S_loc + torch.arange(S_loc, device=dev)
        valid = (kpos[None, :] <= positions[:, None])[None, None]
        mi, li, pexp = _local_softmax(logits, valid)
        o_c = torch.bmm(pexp.view(B, H * S, S_loc), ckv).view(B, H, S, R)
        o_c = _splitkv_merge(mi, li, o_c, ax)
        w_uv = params["w_uv"].reshape(R, H, cfg.v_head_dim)
        out = torch.einsum("bhqr,rhd->bqhd", o_c.to(x.dtype), w_uv)
        out = out.reshape(B, S, H * cfg.v_head_dim)
        return _rows_psum(out, params["wo"], ax, m), cache
