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

With a sharding context (``distributed.sharding.ShardCtx``) every entry
point takes placed trees (``param_specs`` or ``param_specs_splitkv``, a
cache by ``cache_specs``, tokens by their batch rows over the data axes)
and keeps every activation as this rank's batch rows, replicated over
``model``. Attention is ``attention.gqa_tp``/``mla_tp`` (the split-KV
functions for ``decode_impl="split_kv"``), the dense FFN a column-sharded
``w_gate``/``w_up`` and a row-sharded ``w_down`` with one ``psum``, MoE
``moe.moe_ffn`` (``moe_ffn_decode_ep_all`` under split-KV). The output
head is vocab-sharded: ``lm_decode_step`` returns this rank's columns of
the logits (``logits_spec``), and the loss is the vocab-parallel
cross-entropy (a ``pmax``, and ``psum``s of the exponentials and of the
gold logit), averaged over the data axes. Under a context with
``fsdp_specs`` (FSDP, ``trainer.fsdp_param_specs``) the leaves they split
over the data axes are gathered where they are used
(``sharding.fsdp_gather``, by each node's path): a layer's inside the
layer, so inside its remat, the embedding, head and final norm at the
entry point. A differentiated pass on a mesh keeps the residual stream
between the layers sequence parallel: each model rank holds its block of
the B * S tokens (``sharding.split_seq``), each region (attention, FFN or
MoE) takes them whole (``gather_seq``, an all-gather) and ends in a
reduce-scatter of its float32 partial output (``psum_scatter``) where the
replicated stream ends in an all-reduce, so a remat'd layer saves
1 / n_model of its input and the forward pass moves the replicated
stream's bytes. The values are the replicated stream's up to the order of
the float32 sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.range_daat import resolve_device
from repro_torch.distributed.sharding import (
    P,
    axis_index,
    bound,
    fsdp_gather,
    gather_seq,
    pmax,
    psum,
    psum_scatter,
    split_seq,
    sum_grads,
)
from repro_torch.models.attention import (
    MLAConfig,
    gqa,
    gqa_decode_splitkv,
    gqa_prefill_splitkv,
    gqa_tp,
    init_gqa,
    init_mla,
    mla,
    mla_decode_splitkv,
    mla_tp,
    rows_psum,
)
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
from repro_torch.models.moe import (
    MoEConfig,
    init_moe,
    moe_ffn,
    moe_ffn_decode_ep_all,
    moe_ffn_partial,
)

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


def _attn(params, x, rope, cfg: LMConfig, shard_ctx=None, partial: bool = False, **kw):
    """Attention; on a mesh ``gqa_tp``/``mla_tp`` (``partial``: the float32
    partial output, unreduced)."""
    if shard_ctx is not None:
        fn = mla_tp if _is_mla(cfg) else gqa_tp
        return fn(params, x, rope, cfg.attn, shard_ctx, chunk=cfg.attn_chunk,
                  partial=partial, **kw)
    fn = mla if _is_mla(cfg) else gqa
    return fn(params, x, rope, cfg.attn, chunk=cfg.attn_chunk, **kw)


def _ffn(params, z, shard_ctx, partial: bool = False):
    """SwiGLU; on a mesh its hidden dim is sharded over model (w_gate/w_up
    columns, w_down rows) and one psum sums the partial outputs
    (``partial``: the float32 partial output, unreduced)."""
    if shard_ctx is None:
        return swiglu(params, z)
    ax = shard_ctx.model_axis
    zf = sum_grads(z, ax)
    h = F.silu(zf @ params["w_gate"]) * (zf @ params["w_up"])
    return rows_psum(h, params["w_down"], ax, z.dtype, partial)


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


def _layer_apply(layer, x, rope, cfg: LMConfig, positions, use_moe, shard_ctx,
                 sp: bool = False, path: str = ""):
    with _bound(shard_ctx):  # a remat recomputes this in the backward pass
        return _layer_body(layer, x, rope, cfg, positions, use_moe, shard_ctx, sp, path)


def _layer_body(layer, x, rope, cfg: LMConfig, positions, use_moe, shard_ctx,
                sp: bool = False, path: str = ""):
    """One layer, the node at ``path`` of the parameters (``dense.3``).
    With ``sp`` (sequence parallel) ``x`` [B * S / n_model, d] is this
    rank's block of the flat tokens: each region takes them whole and ends
    in a reduce-scatter of its partial output to this rank's block."""
    layer = fsdp_gather(layer, shard_ctx, path)  # FSDP: whole weights for this layer only
    S = positions.shape[0]
    if sp:
        ax = shard_ctx.model_axis

        def whole(t):  # [B, S, d]
            return gather_seq(t, ax, 0).view(-1, S, t.shape[-1])

        def mine(y):  # this rank's block of the sum of the ranks' partial outputs
            return psum_scatter(y.reshape(-1, y.shape[-1]), ax, 0, x.dtype)
    else:
        def whole(t):
            return t

        def mine(y):
            return y

    # The attention's whole output (under ``sp`` a float32 partial sum) is
    # not kept past its reduction: the FFN's peak would hold it.
    x = x + mine(_attn(layer["attn"], rms_norm(whole(x), layer["ln1"]), rope, cfg,
                       shard_ctx, positions=positions, partial=sp)[0])
    z = rms_norm(whole(x), layer["ln2"])
    if use_moe:
        B, _, d = z.shape
        z2 = z.reshape(B * S, d)
        if sp:
            y, aux = moe_ffn_partial(layer["moe"], z2, cfg.moe, shard_ctx)
        else:
            y, aux = moe_ffn(layer["moe"], z2, cfg.moe, shard_ctx)
        return x + mine(y.reshape(B, S, d)), aux
    return (x + mine(_ffn(layer["ffn"], z, shard_ctx, sp)),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _scan_segment(params_seg, seg: str, x, rope, cfg, positions, use_moe, shard_ctx,
                  sp=False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and x.requires_grad
    for i, layer in enumerate(params_seg):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_apply, layer, x, rope, cfg, positions, use_moe, shard_ctx, sp,
                f"{seg}.{i}", use_reentrant=False)
        else:
            x, a = _layer_apply(layer, x, rope, cfg, positions, use_moe, shard_ctx, sp,
                                f"{seg}.{i}")
        aux = aux + a
    return x, aux


def _bound(shard_ctx):
    return bound(shard_ctx.mesh) if shard_ctx is not None else contextlib.nullcontext()


def lm_forward(params, tokens, cfg: LMConfig, shard_ctx=None, *, rope=None):
    """tokens [B, S] -> (hidden [B, S, d], aux_loss). Logits are computed by
    the loss (chunked) or by the caller via lm_head. With a context: this
    rank's batch rows of both, from placed parameters."""
    with _bound(shard_ctx):
        return _lm_forward(params, tokens, cfg, shard_ctx, rope)


def _lm_forward(params, tokens, cfg, shard_ctx, rope):
    params = fsdp_gather(params, shard_ctx, deep=False)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    x = gather_rows(params["embed"], tokens)
    if rope is None:
        rope = rope_table(cfg, max(S, cfg.max_seq), dev)
    positions = torch.arange(S, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    # Differentiated on a mesh, the residual stream between the layers is
    # sequence parallel: each model rank keeps (and remat saves) its block
    # of the flat tokens, not the whole.
    d = x.shape[-1]
    sp = (shard_ctx is not None and torch.is_grad_enabled() and x.requires_grad
          and shard_ctx.n_model > 1 and (B * S) % shard_ctx.n_model == 0)
    if sp:
        x = split_seq(x.reshape(B * S, d), shard_ctx.model_axis, 0)
    if "dense" in params:
        x, a = _scan_segment(params["dense"], "dense", x, rope, cfg, positions, False,
                             shard_ctx, sp)
        aux = aux + a
    if "moe" in params:
        x, a = _scan_segment(params["moe"], "moe", x, rope, cfg, positions, True,
                             shard_ctx, sp)
        aux = aux + a
    if sp:
        x = gather_seq(x, shard_ctx.model_axis, 0).view(B, S, d)
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


def _chunked_xent_vocab(h2d, head, labels, chunk: int, ax: str):
    """``_chunked_xent`` with ``head`` this rank's vocab columns: the
    log-sum-exp over the columns of every rank (a ``pmax`` and a ``psum``)
    and the gold logit from the rank that holds it (a ``psum``)."""
    T, _ = h2d.shape
    if T % chunk != 0:
        chunk = T
    V_loc = head.shape[1]
    v_lo = axis_index(ax) * V_loc
    h2d = sum_grads(h2d, ax)
    tot = torch.zeros((), dtype=torch.float32, device=h2d.device)
    for c0 in range(0, T, chunk):
        logits = dot_f32(h2d[c0:c0 + chunk], head)  # [c, V_loc]
        mx = pmax(torch.amax(logits.detach(), dim=-1, keepdim=True), ax)
        se = psum(torch.sum(torch.exp(logits - mx), dim=-1), ax)
        lse = mx[:, 0] + torch.log(se)
        lab = labels[c0:c0 + chunk].long() - v_lo
        own = (lab >= 0) & (lab < V_loc)
        gold = torch.gather(logits, -1, lab.clamp(0, V_loc - 1)[:, None])[:, 0]
        gold = psum(torch.where(own, gold, torch.zeros_like(gold)), ax)
        tot = tot + torch.sum(lse - gold)
    return tot / T


def lm_loss(params, tokens, cfg: LMConfig, shard_ctx=None):
    """Next-token CE (+ MoE aux + MTP aux). tokens [B, S] int32. With a
    context: the global batch's loss on every rank, from this rank's rows;
    its backward pass gives this rank's share of the gradient (the shares
    sum to the gradient over the data axes)."""
    with _bound(shard_ctx):
        return _lm_loss(params, tokens, cfg, shard_ctx)


def _xent(h2d, head, labels, cfg, shard_ctx):
    if shard_ctx is None:
        return _chunked_xent(h2d, head, labels, cfg.loss_chunk)
    return _chunked_xent_vocab(h2d, head, labels, cfg.loss_chunk, shard_ctx.model_axis)


def _lm_loss(params, tokens, cfg, shard_ctx):
    params = fsdp_gather(params, shard_ctx, deep=False)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    rope = rope_table(cfg, max(S, cfg.max_seq), dev)
    h, aux = _lm_forward(params, tokens, cfg, shard_ctx, rope)
    h_pred = h[:, :-1].reshape(B * (S - 1), cfg.d_model)
    labels = tokens[:, 1:].reshape(B * (S - 1))
    loss = _xent(h_pred, params["lm_head"], labels, cfg, shard_ctx)

    if cfg.mtp and "mtp" in params:
        # Predict token t+2 from (h_t, embed(token_{t+1})) through one block.
        m = fsdp_gather(params["mtp"], shard_ctx, "mtp", deep=False)

        def mtp_head(h):
            h_in = rms_norm(h[:, :-1], m["ln_h"])
            e_in = rms_norm(gather_rows(params["embed"], tokens[:, 1:]), m["ln_e"])
            z = torch.cat([h_in, e_in], -1) @ m["proj"]
            z, _ = _layer_apply(
                m["block"], z, rope, cfg, torch.arange(S - 1, device=dev), False, shard_ctx,
                path="mtp.block")
            return rms_norm(z, m["final_norm"])

        # Under remat the head is one more remat'd block: only h is kept.
        if cfg.remat and torch.is_grad_enabled() and h.requires_grad:
            z = torch.utils.checkpoint.checkpoint(mtp_head, h, use_reentrant=False)
        else:
            z = mtp_head(h)
        z_pred = z[:, :-1].reshape(B * (S - 2), cfg.d_model)
        mtp_labels = tokens[:, 2:].reshape(B * (S - 2))
        loss = loss + cfg.mtp_weight * _xent(
            z_pred, params["lm_head"], mtp_labels, cfg, shard_ctx)

    if shard_ctx is not None:  # each data block's mean; the batch's is their mean
        loss = psum(loss, shard_ctx.data_axes) / shard_ctx.n_data
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


def _decode_segment(params_seg, seg: str, cache_seg, x, rope, cfg, pos, use_moe, shard_ctx,
                    decode_impl: str = "batch"):
    split = decode_impl == "split_kv" and shard_ctx is not None
    positions = int(pos) + torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(params_seg):
        layer = fsdp_gather(layer, shard_ctx, f"{seg}.{i}")
        cache_layer = {name: buf[i] for name, buf in cache_seg.items()}
        z1 = rms_norm(x, layer["ln1"])
        S_new = x.shape[1]
        if split and (S_new == 1 or _is_mla(cfg)):
            # MLA takes a prefill chunk of any length on the split cache.
            fn = mla_decode_splitkv if _is_mla(cfg) else gqa_decode_splitkv
            h, _ = fn(layer["attn"], z1, rope, cfg.attn, cache_layer, pos, shard_ctx)
        elif split:
            # Seq-parallel prefill chunk (chunk size == per-rank slice).
            h, _ = gqa_prefill_splitkv(layer["attn"], z1, rope, cfg.attn, cache_layer,
                                       int(pos) // S_new, shard_ctx)
        else:
            h, _ = _attn(layer["attn"], z1, rope, cfg, shard_ctx, positions=positions,
                         cache=cache_layer, cache_pos=pos)
        x = x + h
        z = rms_norm(x, layer["ln2"])
        if use_moe:
            B, S, d = z.shape
            if split:
                y, _ = moe_ffn_decode_ep_all(layer["moe"], z.reshape(B * S, d), cfg.moe,
                                             shard_ctx)
            else:
                y, _ = moe_ffn(layer["moe"], z.reshape(B * S, d), cfg.moe, shard_ctx)
            x = x + y.reshape(B, S, d)
        else:
            x = x + _ffn(layer["ffn"], z, shard_ctx)
    return x, cache_seg


def lm_decode_step(
    params, tokens, cache, pos, cfg: LMConfig, shard_ctx=None,
    logits_last_only: bool = False, decode_impl: str = "batch", *, rope=None,
):
    """One decode (or prefill) step. tokens [B, S_new]; pos = cache fill.

    decode_impl: "batch" (cache sharded over batch, the baseline) or
    "split_kv" (cache sharded batch x seq with the partial-softmax merge,
    absorbed MLA and full-grid MoE EP; without a mesh, the batch path).
    Returns (logits [B, S_new, V] float32, or [B, 1, V] with
    ``logits_last_only``, the prefill contract, and the cache, updated in
    place). With a context: this rank's placed tokens, cache and
    parameters; the logits are this rank's rows and vocab columns
    (``logits_spec``).
    """
    with _bound(shard_ctx):
        params = fsdp_gather(params, shard_ctx, deep=False)
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens, device=dev)
        x = gather_rows(params["embed"], tokens)
        if rope is None:
            rope = rope_table(cfg, cfg.max_seq, dev)
        new_cache = {}
        if "dense" in params:
            x, new_cache["dense"] = _decode_segment(
                params["dense"], "dense", cache["dense"], x, rope, cfg, pos, False, shard_ctx,
                decode_impl,
            )
        if "moe" in params:
            x, new_cache["moe"] = _decode_segment(
                params["moe"], "moe", cache["moe"], x, rope, cfg, pos, True, shard_ctx,
                decode_impl,
            )
        h = rms_norm(x, params["final_norm"])
        if logits_last_only:
            h = h[:, -1:]
        return dot_f32(h, params["lm_head"]), new_cache


def logits_spec(shard_ctx) -> P:
    """The layout of ``lm_decode_step``'s logits on a mesh: rows over the
    data axes, the vocab over model."""
    return P(shard_ctx.data_axes, None, shard_ctx.model_axis)


# ------------------------------------------------------------------- specs


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def _kv_shardable(a) -> bool:
    return a.n_kv_heads * a.head_dim % 16 == 0 and a.n_kv_heads >= 16


def _attn_specs(cfg: LMConfig, m: str):
    if _is_mla(cfg):
        return {
            "w_dq": P(),
            "q_norm": P(),
            "w_uq": P(None, m),
            "w_dkv": P(),
            "kv_norm": P(),
            "w_uk": P(None, m),
            "w_uv": P(None, m),
            "wo": P(m, None),
        }
    a = cfg.attn
    kv_shardable = _kv_shardable(a)
    kv = P(None, m) if kv_shardable else P()
    s = {
        "wq": P(None, m),
        "wk": kv,
        "wv": kv,
        "wo": P(m, None),
    }
    if a.qkv_bias:
        s["bq"] = P(m)
        s["bk"] = P(m) if kv_shardable else P()
        s["bv"] = P(m) if kv_shardable else P()
    if a.qk_norm:
        s["q_norm"] = P()
        s["k_norm"] = P()
    return s


def _layer_specs(cfg: LMConfig, use_moe: bool, m: str):
    def stack(spec: P) -> P:
        return P(None, *spec)  # leading layer-stack dim

    attn = _map_specs(stack, _attn_specs(cfg, m))
    layer = {"ln1": P(None), "attn": attn, "ln2": P(None)}
    if use_moe:
        moe = {
            "router": P(None),
            "w_gate": P(None, m, None, None),
            "w_up": P(None, m, None, None),
            "w_down": P(None, m, None, None),
        }
        if cfg.moe.n_shared:
            moe["shared"] = {
                "w_gate": P(None, None, m),
                "w_up": P(None, None, m),
                "w_down": P(None, m, None),
            }
        layer["moe"] = moe
    else:
        layer["ffn"] = {
            "w_gate": P(None, None, m),
            "w_up": P(None, None, m),
            "w_down": P(None, m, None),
        }
    return layer


def param_specs(cfg: LMConfig, model_axis: str = "model"):
    """PartitionSpec tree matching init_lm's structure (TP over model), in
    the reference's stacked layout: a segment's leaves lead with the layer
    dim (``distributed.sharding.place_tree`` drops it per layer)."""
    m = model_axis
    specs = {
        "embed": P(None, None),
        "final_norm": P(None),
        "lm_head": P(None, m),  # vocab-sharded output projection
    }
    if cfg.n_dense_total:
        specs["dense"] = _layer_specs(cfg, False, m)
    if cfg.n_moe_layers:
        specs["moe"] = _layer_specs(cfg, True, m)
    if cfg.mtp:
        block = _map_specs(lambda s: P(*s[1:]), _layer_specs(cfg, False, m))  # un-stack
        specs["mtp"] = {
            "proj": P(),
            "ln_h": P(None),
            "ln_e": P(None),
            "block": block,
            "final_norm": P(None),
        }
    return specs


def cache_specs(cfg: LMConfig, data_axes, layout: str = "batch") -> dict:
    """KV cache shardings. layout="batch": batch-only (baseline);
    layout="split": batch over data x sequence over model (split-KV)."""
    seq = "model" if layout == "split" else None
    if _is_mla(cfg):
        seg = {
            "c_kv": P(None, data_axes, seq, None),
            "k_rope": P(None, data_axes, seq, None),
        }
    else:
        seg = {
            "k": P(None, data_axes, seq, None, None),
            "v": P(None, data_axes, seq, None, None),
        }
    out = {}
    if cfg.n_dense_total:
        out["dense"] = seg
    if cfg.n_moe_layers:
        out["moe"] = seg
    return out


def param_specs_splitkv(cfg: LMConfig, model_axis: str = "model", ep_grid_ok: bool = True):
    """Param shardings for the split-KV decode variant.

    Attention projections are row-sharded on their input dim; MLA
    w_uk/w_uv replicated (absorbed-path operands); MoE experts sharded over
    the full (data, model) grid when ``ep_grid_ok``; everything else as in
    training.
    """
    m = model_axis
    specs = param_specs(cfg, m)

    def attn_split():
        if _is_mla(cfg):
            return {
                "w_dq": P(None, m, None), "q_norm": P(None),
                "w_uq": P(None, m, None), "w_dkv": P(None, m, None),
                "kv_norm": P(None), "w_uk": P(None), "w_uv": P(None),
                "wo": P(None, m, None),
            }
        a = cfg.attn
        s = {
            "wq": P(None, m, None), "wk": P(None, m, None),
            "wv": P(None, m, None), "wo": P(None, m, None),
        }
        if a.qkv_bias:
            s.update({"bq": P(None), "bk": P(None), "bv": P(None)})
        if a.qk_norm:
            s.update({"q_norm": P(None), "k_norm": P(None)})
        return s

    for seg in ("dense", "moe"):
        if seg in specs:
            specs[seg]["attn"] = attn_split()
    if "moe" in specs and cfg.moe is not None and ep_grid_ok:
        # Full-grid EP when experts cover data x model (deepseek-v3: 256/256).
        for w in ("w_gate", "w_up", "w_down"):
            specs["moe"]["moe"][w] = P(None, ("data", m), None, None)
    return specs


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
