"""Decoder-only transformer for the five LM architectures, on one device.

The counterpart of the JAX package's ``models/transformer.py``:
  * GQA (qwen3 qk-norm, qwen2.5 QKV-bias, deepseek-67b llama-style) or MLA
    (deepseek-v3) attention;
  * dense SwiGLU FFN, switching to MoE after ``n_dense_layers``;
  * the MTP (multi-token prediction) auxiliary head (deepseek-v3), read by
    ``lm_loss`` and carried, unread, by serving;
  * chunked cross-entropy (``_chunked_xent``): logits never exceed
    [chunk, vocab] float32, and a token count that is not a multiple of
    ``loss_chunk`` runs as one chunk of all T tokens, as the reference does
    (at ``train_4k``, T = 4,095);
  * per-layer KV caches (GQA) or compressed caches (MLA) for decode.

The reference stacks every layer's leaves ``[L, ...]`` for ``lax.scan``;
here a segment is an ``nn.ModuleList`` of layers and the scan a Python
loop. ``cfg.remat`` is the reference's ``jax.checkpoint`` of the scan body:
when the pass is differentiated, each layer runs under
``torch.utils.checkpoint`` (``use_reentrant=False``), so only its input is
kept and its activations are recomputed in the backward pass; serving runs
the layers as they are. A cache keeps the reference's stacked layout
(``[L, B, Smax, ...]`` per leaf) and is updated in place: ``lm_decode_step``
returns the cache it was given. ``rope`` (keyword-only, the port's own)
passes a prebuilt ``rope_freqs`` table, so that a step built once does not
rebuild it per call.

``param_specs``, ``cache_specs`` and ``param_specs_splitkv`` wait for the
mesh paths (ROADMAP A7), as does a sharding context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.range_daat import resolve_device
from repro_torch.models.attention import MLAConfig, gqa, init_gqa, init_mla, mla
from repro_torch.models.layers import (
    Params,
    dense_init,
    dot_f32,
    gather_rows,
    make_generator,
    rms_norm,
    rms_norm_init,
    rope_freqs,
    swiglu,
    swiglu_init,
)
from repro_torch.models.moe import MoEConfig, init_moe, moe_ffn

__all__ = ["LMConfig", "init_lm", "lm_forward", "lm_loss", "init_cache", "lm_decode_step",
           "param_specs", "count_params"]

STACKED = ("dense", "moe")  # the segments the reference stacks [L, ...] for lax.scan


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    attn: Any  # GQAConfig | MLAConfig
    d_ff: int  # dense-FFN hidden width
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0  # leading dense layers when moe is set
    max_seq: int = 4096
    dtype: Any = torch.bfloat16
    mtp: bool = False
    mtp_weight: float = 0.3
    attn_chunk: int = 512
    remat: bool = True
    loss_chunk: int = 1024

    @property
    def n_moe_layers(self) -> int:
        return (self.n_layers - self.n_dense_layers) if self.moe else 0

    @property
    def n_dense_total(self) -> int:
        return self.n_layers - self.n_moe_layers


def _is_mla(cfg: LMConfig) -> bool:
    return isinstance(cfg.attn, MLAConfig)


def _init_attn(key, cfg: LMConfig, device):
    init = init_mla if _is_mla(cfg) else init_gqa
    return init(key, cfg.attn, cfg.dtype, device)


def _attn(params, x, rope, cfg: LMConfig, **kw):
    fn = mla if _is_mla(cfg) else gqa
    return fn(params, x, rope, cfg.attn, chunk=cfg.attn_chunk, **kw)


def _init_layer(key, cfg: LMConfig, use_moe: bool, device):
    layer = Params(
        ln1=rms_norm_init(cfg.d_model, cfg.dtype, device),
        attn=_init_attn(key, cfg, device),
        ln2=rms_norm_init(cfg.d_model, cfg.dtype, device),
    )
    if use_moe:
        layer["moe"] = init_moe(key, cfg.d_model, cfg.moe, cfg.dtype, device)
    else:
        layer["ffn"] = swiglu_init(key, cfg.d_model, cfg.d_ff, cfg.dtype, device)
    return layer


def init_lm(key, cfg: LMConfig, device=None):
    """Random parameters on ``device`` (None: the card; ``"meta"`` allocates
    nothing). ``key`` is an int seed or a ``torch.Generator`` there."""
    dev = resolve_device(device)
    gen = make_generator(key, dev)
    params = Params(
        embed=dense_init(gen, cfg.vocab, cfg.d_model, cfg.dtype, scale=1.0, device=dev),
        final_norm=rms_norm_init(cfg.d_model, cfg.dtype, dev),
        lm_head=dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype, device=dev),
    )
    params.stacked = STACKED
    nd, nm = cfg.n_dense_total, cfg.n_moe_layers
    if nd:
        params["dense"] = nn.ModuleList([_init_layer(gen, cfg, False, dev) for _ in range(nd)])
    if nm:
        params["moe"] = nn.ModuleList([_init_layer(gen, cfg, True, dev) for _ in range(nm)])
    if cfg.mtp:
        params["mtp"] = Params(
            proj=dense_init(gen, 2 * cfg.d_model, cfg.d_model, cfg.dtype, device=dev),
            ln_h=rms_norm_init(cfg.d_model, cfg.dtype, dev),
            ln_e=rms_norm_init(cfg.d_model, cfg.dtype, dev),
            block=_init_layer(gen, cfg, False, dev),
            final_norm=rms_norm_init(cfg.d_model, cfg.dtype, dev),
        )
    return params


def rope_table(cfg: LMConfig, max_len: int, device) -> torch.Tensor:
    """``rope_freqs`` at the config's rotary width and theta."""
    head_dim = cfg.attn.qk_rope_head_dim if _is_mla(cfg) else cfg.attn.head_dim
    return rope_freqs(head_dim, max_len, cfg.attn.rope_theta, device)


# ------------------------------------------------------------------ forward


def _layer_apply(layer, x, rope, cfg: LMConfig, positions, use_moe, shard_ctx):
    h, _ = _attn(layer["attn"], rms_norm(x, layer["ln1"]), rope, cfg, positions=positions)
    x = x + h
    z = rms_norm(x, layer["ln2"])
    if use_moe:
        B, S, d = z.shape
        y, aux = moe_ffn(layer["moe"], z.reshape(B * S, d), cfg.moe, shard_ctx)
        return x + y.reshape(B, S, d), aux
    return x + swiglu(layer["ffn"], z), torch.zeros((), dtype=torch.float32, device=x.device)


def _scan_segment(params_seg, x, rope, cfg, positions, use_moe, shard_ctx):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and x.requires_grad
    for layer in params_seg:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_apply, layer, x, rope, cfg, positions, use_moe, shard_ctx,
                use_reentrant=False)
        else:
            x, a = _layer_apply(layer, x, rope, cfg, positions, use_moe, shard_ctx)
        aux = aux + a
    return x, aux


def _no_ctx(shard_ctx, what: str) -> None:
    if shard_ctx is not None:
        raise NotImplementedError(
            f"{what} with a sharding context (the mesh's tensor and expert "
            "parallelism) is ROADMAP A7; pass shard_ctx=None")


def lm_forward(params, tokens, cfg: LMConfig, shard_ctx=None, *, rope=None):
    """tokens [B, S] -> (hidden [B, S, d], aux_loss). Logits are computed by
    the loss (chunked) or by the caller via lm_head."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    x = gather_rows(params["embed"], tokens)
    if rope is None:
        rope = rope_table(cfg, max(S, cfg.max_seq), dev)
    positions = torch.arange(S, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if "dense" in params:
        x, a = _scan_segment(params["dense"], x, rope, cfg, positions, False, shard_ctx)
        aux = aux + a
    if "moe" in params:
        x, a = _scan_segment(params["moe"], x, rope, cfg, positions, True, shard_ctx)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


def _chunked_xent(h2d, head, labels, chunk: int):
    """Mean CE over T tokens without materializing [T, V] logits."""
    T, _ = h2d.shape
    if T % chunk != 0:
        chunk = T
    tot = torch.zeros((), dtype=torch.float32, device=h2d.device)
    for c0 in range(0, T, chunk):
        logits = dot_f32(h2d[c0:c0 + chunk], head)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[c0:c0 + chunk, None].long())[:, 0]
        tot = tot + torch.sum(lse - gold)
    return tot / T


def lm_loss(params, tokens, cfg: LMConfig, shard_ctx=None):
    """Next-token CE (+ MoE aux + MTP aux). tokens [B, S] int32."""
    _no_ctx(shard_ctx, "lm_loss")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    rope = rope_table(cfg, max(S, cfg.max_seq), dev)
    h, aux = lm_forward(params, tokens, cfg, shard_ctx, rope=rope)
    h_pred = h[:, :-1].reshape(B * (S - 1), cfg.d_model)
    labels = tokens[:, 1:].reshape(B * (S - 1))
    loss = _chunked_xent(h_pred, params["lm_head"], labels, cfg.loss_chunk)

    if cfg.mtp and "mtp" in params:
        # Predict token t+2 from (h_t, embed(token_{t+1})) through one block.
        m = params["mtp"]
        h_in = rms_norm(h[:, :-1], m["ln_h"])
        e_in = rms_norm(gather_rows(params["embed"], tokens[:, 1:]), m["ln_e"])
        z = torch.cat([h_in, e_in], -1) @ m["proj"]
        z, _ = _layer_apply(
            m["block"], z, rope, cfg, torch.arange(S - 1, device=dev), False, shard_ctx
        )
        z = rms_norm(z, m["final_norm"])
        z_pred = z[:, :-1].reshape(B * (S - 2), cfg.d_model)
        mtp_labels = tokens[:, 2:].reshape(B * (S - 2))
        loss = loss + cfg.mtp_weight * _chunked_xent(
            z_pred, params["lm_head"], mtp_labels, cfg.loss_chunk
        )

    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


# ------------------------------------------------------------------- decode


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None):
    """Stacked per-segment KV caches, zeros: {"dense"/"moe": {"k", "v"}
    [L, B, max_len, KV, D]} (GQA) or {"c_kv", "k_rope"} [L, B, max_len, ·]
    (MLA). ``device`` None is the card; ``"meta"`` allocates nothing."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    a = cfg.attn

    def one(n_layers):
        if _is_mla(cfg):
            return {
                "c_kv": torch.zeros((n_layers, batch, max_len, a.kv_lora_rank), dtype=dtype,
                                    device=dev),
                "k_rope": torch.zeros((n_layers, batch, max_len, a.qk_rope_head_dim),
                                      dtype=dtype, device=dev),
            }
        shape = (n_layers, batch, max_len, a.n_kv_heads, a.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    out = {}
    if cfg.n_dense_total:
        out["dense"] = one(cfg.n_dense_total)
    if cfg.n_moe_layers:
        out["moe"] = one(cfg.n_moe_layers)
    return out


def _decode_segment(params_seg, cache_seg, x, rope, cfg, pos, use_moe, shard_ctx,
                    decode_impl: str = "batch"):
    if decode_impl == "split_kv" and shard_ctx is not None:
        raise NotImplementedError(
            "decode_impl='split_kv' with a sharding context (the KV cache sharded over "
            "the mesh, shard_map in the reference) is ROADMAP A7; with no context the "
            "step runs the batch cache, as the reference does")
    positions = int(pos) + torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(params_seg):
        cache_layer = {name: buf[i] for name, buf in cache_seg.items()}
        z1 = rms_norm(x, layer["ln1"])
        h, _ = _attn(layer["attn"], z1, rope, cfg, positions=positions,
                     cache=cache_layer, cache_pos=pos)
        x = x + h
        z = rms_norm(x, layer["ln2"])
        if use_moe:
            B, S, d = z.shape
            y, _ = moe_ffn(layer["moe"], z.reshape(B * S, d), cfg.moe, shard_ctx)
            x = x + y.reshape(B, S, d)
        else:
            x = x + swiglu(layer["ffn"], z)
    return x, cache_seg


def lm_decode_step(
    params, tokens, cache, pos, cfg: LMConfig, shard_ctx=None,
    logits_last_only: bool = False, decode_impl: str = "batch", *, rope=None,
):
    """One decode (or prefill) step. tokens [B, S_new]; pos = cache fill.

    Returns (logits [B, S_new, V] float32, or [B, 1, V] with
    ``logits_last_only``, the prefill contract, and the cache, updated in
    place). ``decode_impl="split_kv"`` needs a mesh (A7); without one it is
    the batch path, as in the reference.
    """
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    x = gather_rows(params["embed"], tokens)
    if rope is None:
        rope = rope_table(cfg, cfg.max_seq, dev)
    new_cache = {}
    if "dense" in params:
        x, new_cache["dense"] = _decode_segment(
            params["dense"], cache["dense"], x, rope, cfg, pos, False, shard_ctx,
            decode_impl,
        )
    if "moe" in params:
        x, new_cache["moe"] = _decode_segment(
            params["moe"], cache["moe"], x, rope, cfg, pos, True, shard_ctx,
            decode_impl,
        )
    h = rms_norm(x, params["final_norm"])
    if logits_last_only:
        h = h[:, -1:]
    return dot_f32(h, params["lm_head"]), new_cache


# ------------------------------------------------------------------- specs


def _needs_mesh(name: str):
    raise NotImplementedError(
        f"{name} gives PartitionSpecs for the device mesh; the mesh paths are "
        "ROADMAP A7")


def param_specs(cfg: LMConfig, model_axis: str = "model"):
    _needs_mesh("param_specs")


def cache_specs(cfg: LMConfig, data_axes, layout: str = "batch") -> dict:
    _needs_mesh("cache_specs")


def param_specs_splitkv(cfg: LMConfig, model_axis: str = "model", ep_grid_ok: bool = True):
    _needs_mesh("param_specs_splitkv")


def count_params(cfg: LMConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts, for MODEL_FLOPS."""
    a = cfg.attn
    if _is_mla(cfg):
        qk_head = a.qk_nope_head_dim + a.qk_rope_head_dim
        attn = (
            cfg.d_model * a.q_lora_rank
            + a.q_lora_rank * a.n_heads * qk_head
            + cfg.d_model * (a.kv_lora_rank + a.qk_rope_head_dim)
            + a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
            + a.n_heads * a.v_head_dim * cfg.d_model
        )
    else:
        attn = cfg.d_model * a.head_dim * (a.n_heads * 2 + a.n_kv_heads * 2)
    dense_ffn = 3 * cfg.d_model * cfg.d_ff
    embed = 2 * cfg.vocab * cfg.d_model
    total = embed + cfg.n_dense_total * (attn + dense_ffn)
    active = embed + cfg.n_dense_total * (attn + dense_ffn)
    if cfg.moe:
        moe_ffn_p = 3 * cfg.d_model * cfg.moe.d_ff
        shared = cfg.moe.n_shared * moe_ffn_p
        router = cfg.d_model * cfg.moe.n_experts
        total += cfg.n_moe_layers * (
            attn + moe_ffn_p * cfg.moe.n_experts + shared + router
        )
        active += cfg.n_moe_layers * (
            attn + moe_ffn_p * cfg.moe.top_k + shared + router
        )
    return int(total), int(active)
