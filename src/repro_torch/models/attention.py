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

The split-KV functions run only under ``shard_map`` over a mesh in the
reference; they raise here until the mesh paths are ported (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.layers import (
    Params,
    apply_rope,
    dense_init,
    rms_norm,
    rms_norm_init,
)

__all__ = ["GQAConfig", "MLAConfig", "init_gqa", "gqa", "init_mla", "mla"]

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


# ----------------------------------------------------- split-KV decode (mesh)


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} runs the KV cache sharded over a device mesh (shard_map in the "
        "reference); the mesh paths are ROADMAP A7. With no sharding context the "
        "LM steps use gqa/mla with a batch cache"
    )


def _splitkv_merge(mi, li, oi, axis_name):
    _needs_mesh("_splitkv_merge")


def gqa_decode_splitkv(params, x, rope_table, cfg: GQAConfig, cache, cache_pos, shard_ctx):
    _needs_mesh("gqa_decode_splitkv")


def mla_decode_splitkv(params, x, rope_table, cfg: MLAConfig, cache, cache_pos, shard_ctx):
    _needs_mesh("mla_decode_splitkv")


def gqa_prefill_splitkv(params, x, rope_table, cfg: GQAConfig, cache, chunk_idx, shard_ctx,
                        q_sub: int = 512):
    _needs_mesh("gqa_prefill_splitkv")

