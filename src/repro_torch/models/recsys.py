"""RecSys architectures: BST, MIND, AutoInt, BERT4Rec, serving half.

The counterpart of the JAX package's ``models/recsys.py`` on one device:
embedding tables feeding a small interaction network, in three regimes —
transformer over a sequence (BST, BERT4Rec), multi-interest capsule routing
(MIND), and self-attention over field embeddings (AutoInt).

Shapes contract (``configs``): ``serve`` scores (user, item) pairs;
``retrieval`` scores one user against n_candidates items. The towers gather
table rows directly, and field rows through
``models.embedding.sharded_field_lookup``, which is a plain gather without a
mesh: the reference imports ``embedding_bag`` but never calls it, and
neither does this module. Gathers clamp to the table, as JAX's do;
``jax.nn.gelu`` is the tanh approximation.

Both steps work in pieces, since every example's and every candidate's
score is independent: ``rec_serve_scores`` ``SERVE_CHUNK`` examples at a
time (BERT4Rec's 262,144 x 2 heads x 200 x 200 float32 scores would be 84
GB in one piece), ``rec_retrieval_scores`` ``CAND_CHUNK`` candidates at a
time for the ranking towers (BST, AutoInt: one piece of AutoInt's
1,000,000 candidates would need ~70 GB of activations).

``rec_train_loss`` is the reference's in one piece (its gradient needs
the whole batch): BCE for BST and AutoInt (``_bce``, whose ``max(z, 0)``
keeps the reference's split gradient at z = 0), MIND's label-aware
attention and in-batch softmax over the [B, B] logits, BERT4Rec's sampled
softmax over 4,096 strided shared negatives and the gold column.

With a ``ShardCtx`` the towers run on placed parameters
(``rec_param_specs``: the item and field tables row-sharded over
``model``, the small nets replicated) and placed features (their batch
rows over the data axes): every table read is the row-sharded lookup (the
rank's rows of its block, a ``psum`` over ``model``), the scores are this
rank's rows, and the loss is the global batch's (the data blocks' means
averaged; MIND's in-batch softmax gathers the targets over the data axes,
so every row still meets the whole batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.range_daat import resolve_device
from repro_torch.distributed.sharding import P, all_gather_tiled, bound, mesh_coord, psum
from repro_torch.models.embedding import sharded_field_lookup
from repro_torch.models.layers import (
    Params,
    dense_init,
    dot_f32,
    gather_rows,
    make_generator,
    maximum,
    rms_norm,
    rms_norm_init,
)

__all__ = ["RecConfig", "init_rec", "rec_train_loss", "rec_serve_scores",
           "rec_retrieval_scores", "rec_param_specs", "rec_user_embedding"]

CAND_CHUNK = 131_072  # candidates per piece of a ranking tower's retrieval
SERVE_CHUNK = 16_384  # examples per piece of a serve batch


@dataclasses.dataclass(frozen=True)
class RecConfig:
    name: str
    arch: str  # "bst" | "mind" | "autoint" | "bert4rec"
    n_items: int
    embed_dim: int
    seq_len: int = 0
    n_fields: int = 0
    field_vocab: int = 100_000
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple = (1024, 512, 256)
    n_interests: int = 4
    capsule_iters: int = 3
    n_attn_layers: int = 3
    d_attn: int = 32
    dtype: Any = torch.float32
    loss_chunk: int = 2048


# ------------------------------------------------------------ small blocks


def _init_block(key, d: int, n_heads: int, dtype, device):
    return Params(
        ln1=rms_norm_init(d, dtype, device),
        wq=dense_init(key, d, d, dtype, device=device),
        wk=dense_init(key, d, d, dtype, device=device),
        wv=dense_init(key, d, d, dtype, device=device),
        wo=dense_init(key, d, d, dtype, device=device),
        ln2=rms_norm_init(d, dtype, device),
        w1=dense_init(key, d, 4 * d, dtype, device=device),
        w2=dense_init(key, 4 * d, d, dtype, device=device),
    )


def _block(p, x, n_heads: int, causal: bool = False):
    """Small pre-LN transformer block; x [B, S, d]; full attention."""
    B, S, d = x.shape
    hd = d // n_heads
    z = rms_norm(x, p["ln1"])
    q = (z @ p["wq"]).reshape(B, S, n_heads, hd).transpose(1, 2)
    k = (z @ p["wk"]).reshape(B, S, n_heads, hd).transpose(1, 2)
    v = (z @ p["wv"]).reshape(B, S, n_heads, hd).transpose(1, 2)
    s = dot_f32(q, k.transpose(-1, -2))  # [B, H, S, S]
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    o = (w @ v).transpose(1, 2).reshape(B, S, d)
    x = x + o @ p["wo"]
    z = rms_norm(x, p["ln2"])
    return x + F.gelu(z @ p["w1"], approximate="tanh") @ p["w2"]


def _init_mlp(key, dims, dtype, device):
    return nn.ModuleList([
        Params(w=dense_init(key, dims[i], dims[i + 1], dtype, device=device),
               b=torch.zeros((dims[i + 1],), dtype=dtype, device=device))
        for i in range(len(dims) - 1)
    ])


def _mlp(layers, x, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


# -------------------------------------------------------------------- init


def init_rec(key, cfg: RecConfig, device=None):
    """Random parameters on ``device`` (None: the card; ``"meta"`` allocates
    nothing). ``key`` is an int seed or a ``torch.Generator`` there."""
    dev = resolve_device(device)
    gen = make_generator(key, dev)
    dt = cfg.dtype
    D = cfg.embed_dim
    p = Params(item_emb=dense_init(gen, cfg.n_items, D, dt, scale=1.0, device=dev))
    if cfg.seq_len:
        p["pos_emb"] = dense_init(gen, cfg.seq_len + 1, D, dt, scale=0.2, device=dev)
    if cfg.n_fields:
        p["field_emb"] = dense_init(gen, cfg.n_fields * cfg.field_vocab, D, dt, scale=1.0,
                                    device=dev)

    if cfg.arch == "bst":
        p["blocks"] = nn.ModuleList(
            [_init_block(gen, D, cfg.n_heads, dt, dev) for _ in range(cfg.n_blocks)])
        d_cat = D * 2 + cfg.n_fields * D  # pooled seq + target + fields
        p["mlp"] = _init_mlp(gen, (d_cat, *cfg.mlp, 1), dt, dev)
    elif cfg.arch == "mind":
        p["caps_bilinear"] = dense_init(gen, D, D, dt, device=dev)
    elif cfg.arch == "autoint":
        layers = []
        for _ in range(cfg.n_attn_layers):
            layers.append(Params(**{
                w: dense_init(gen, D, cfg.d_attn * 2, dt, device=dev)
                for w in ("wq", "wk", "wv", "wr")}))
            D = cfg.d_attn * 2  # output width after first layer
        p["attn"] = nn.ModuleList(layers)
        p["out"] = _init_mlp(gen, (cfg.n_fields * D, 1), dt, dev)
    elif cfg.arch == "bert4rec":
        p["blocks"] = nn.ModuleList(
            [_init_block(gen, D, cfg.n_heads, dt, dev) for _ in range(cfg.n_blocks)])
        p["final_norm"] = rms_norm_init(D, dt, dev)
        p["mask_emb"] = dense_init(gen, 1, D, dt, scale=0.2, device=dev)
    else:
        raise ValueError(cfg.arch)
    return p


# ------------------------------------------------------------ user encoders


_CTX: list = []  # the sharding context of the tower call running on this rank


def _items(p, ids):
    """``item_emb[clip(ids, 0)]``, the reference's item lookup; on a mesh
    the row-sharded lookup of the rank's block."""
    if _CTX and _CTX[-1] is not None:
        ctx = _CTX[-1]
        n = p["item_emb"].shape[0] * ctx.n_model
        return sharded_field_lookup(p["item_emb"], ids.clamp(0, n - 1), ctx, placed=True)
    return gather_rows(p["item_emb"], ids.clamp(min=0))


class _on_mesh:
    """The tower call's context for ``_items``, bound to its mesh."""

    def __init__(self, shard_ctx):
        self.ctx = shard_ctx

    def __enter__(self):
        _CTX.append(self.ctx)
        self.bound = bound(self.ctx.mesh) if self.ctx is not None else None
        if self.bound is not None:
            self.bound.__enter__()

    def __exit__(self, *exc):
        if self.bound is not None:
            self.bound.__exit__(*exc)
        _CTX.pop()


def _lookup_fields(p, fields, cfg: RecConfig, shard_ctx):
    """fields [B, F] per-field ids -> [B, F, D]; rows offset per field."""
    offs = torch.arange(cfg.n_fields, dtype=fields.dtype, device=fields.device)
    gids = fields + offs[None, :] * cfg.field_vocab
    return sharded_field_lookup(p["field_emb"], gids, shard_ctx,
                                placed=shard_ctx is not None)


def _bst_seq(p, history, target, cfg: RecConfig):
    """history [B, S] (-1 pad), target [B] -> (pooled_seq [B, D], tgt [B, D])."""
    B, S = history.shape
    mask = (history >= 0).to(p["item_emb"].dtype)
    seq = _items(p, history) * mask[..., None]
    tgt = _items(p, target)
    x = torch.cat([seq, tgt[:, None, :]], dim=1)  # target joins the seq
    x = x + p["pos_emb"][None, : S + 1]
    for blk in p["blocks"]:
        x = _block(blk, x, cfg.n_heads)
    mask = torch.cat(
        [history >= 0, torch.ones((B, 1), dtype=torch.bool, device=history.device)], dim=1
    ).to(x.dtype)
    pooled = (x * mask[..., None]).sum(1) / torch.clamp(mask.sum(1), min=1.0)[:, None]
    return pooled, tgt


def _squash(v, axis=-1):
    n2 = torch.sum(v * v, dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def _mind_interests(p, history, cfg: RecConfig):
    """Capsule (B2I dynamic routing) multi-interest extraction [B, J, D]."""
    B, S = history.shape
    mask = (history >= 0).to(cfg.dtype)
    e = _items(p, history) * mask[..., None]  # [B, S, D]
    eh = e @ p["caps_bilinear"]  # [B, S, D]
    # Fixed (non-trainable, deterministic) logit init as in MIND.
    b = torch.zeros((B, S, cfg.n_interests), dtype=cfg.dtype, device=history.device)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * mask[..., None]
        s = w.transpose(1, 2) @ eh  # [B, J, D]
        u = _squash(s)
        b = b + eh @ u.transpose(1, 2)  # [B, S, J]
    return u  # [B, J, D]


def _autoint_fields(p, emb, cfg: RecConfig):
    """emb [B, F, D] -> [B, F * d_out] via stacked interacting layers."""
    x = emb
    for layer in p["attn"]:
        q = x @ layer["wq"]
        k = x @ layer["wk"]
        v = x @ layer["wv"]
        H = 2  # two heads, d_attn each
        B, Fn, DD = q.shape
        hd = DD // H
        qh = q.reshape(B, Fn, H, hd).transpose(1, 2)
        kh = k.reshape(B, Fn, H, hd).transpose(1, 2)
        vh = v.reshape(B, Fn, H, hd).transpose(1, 2)
        s = dot_f32(qh, kh.transpose(-1, -2))  # [B, H, F, F]
        w = torch.softmax(s / torch.sqrt(torch.tensor(hd, dtype=torch.float32)),
                          dim=-1).to(x.dtype)
        o = (w @ vh).transpose(1, 2).reshape(B, Fn, DD)
        x = torch.relu(o + x @ layer["wr"])
    return x.reshape(x.shape[0], -1)


def _bert4rec_hidden(p, history, cfg: RecConfig, mask_positions=None):
    """history [B, S]; optional masked positions replaced by [MASK] emb."""
    B, S = history.shape
    x = _items(p, history)
    if mask_positions is not None:
        m = F.one_hot(mask_positions.to(torch.int64), S).to(x.dtype)  # [B, M, S]
        is_masked = m.sum(1) > 0  # [B, S]
        x = torch.where(is_masked[..., None], p["mask_emb"][0][None, None], x)
    x = x + p["pos_emb"][None, :S]
    for blk in p["blocks"]:
        x = _block(blk, x, cfg.n_heads)
    return rms_norm(x, p["final_norm"])


def _feats(p, feats: dict) -> dict:
    dev = p["item_emb"].device
    return {k: torch.as_tensor(v, device=dev) for k, v in feats.items()}


def rec_user_embedding(p, feats: dict, cfg: RecConfig):
    """User-side representation for retrieval (arch-dependent)."""
    feats = _feats(p, feats)
    if cfg.arch == "mind":
        return _mind_interests(p, feats["history"], cfg)  # [B, J, D]
    if cfg.arch == "bert4rec":
        h = _bert4rec_hidden(p, feats["history"], cfg)
        return h[:, -1:, :]  # [B, 1, D] last position
    raise ValueError(f"{cfg.arch} has no dot-product user embedding")


# ------------------------------------------------------------------- score


def rec_serve_scores(p, feats: dict, cfg: RecConfig, shard_ctx=None):
    """Pointwise scores for a batch of (user, item) examples -> [B],
    ``SERVE_CHUNK`` examples at a time (with a context: this rank's rows)."""
    feats = _feats(p, feats)
    B = next(iter(feats.values())).shape[0]
    with _on_mesh(shard_ctx):
        return torch.cat([
            _serve_scores(p, {k: v[b0:b0 + SERVE_CHUNK] for k, v in feats.items()}, cfg,
                          shard_ctx)
            for b0 in range(0, B, SERVE_CHUNK)])


def _serve_scores(p, feats: dict, cfg: RecConfig, shard_ctx):
    if cfg.arch == "bst":
        pooled, tgt = _bst_seq(p, feats["history"], feats["target"], cfg)
        fe = _lookup_fields(p, feats["fields"], cfg, shard_ctx)
        z = torch.cat([pooled, tgt, fe.reshape(fe.shape[0], -1)], dim=-1)
        return _mlp(p["mlp"], z)[:, 0]
    if cfg.arch == "mind":
        u = _mind_interests(p, feats["history"], cfg)  # [B, J, D]
        t = _items(p, feats["target"])  # [B, D]
        return torch.amax((u @ t[:, :, None])[..., 0], dim=-1)
    if cfg.arch == "autoint":
        emb = _lookup_fields(p, feats["fields"], cfg, shard_ctx)
        return _mlp(p["out"], _autoint_fields(p, emb, cfg))[:, 0]
    if cfg.arch == "bert4rec":
        h = _bert4rec_hidden(p, feats["history"], cfg)[:, -1]  # [B, D]
        t = _items(p, feats["target"])
        return torch.sum(h * t, dim=-1)
    raise ValueError(cfg.arch)


def _bce(logits, labels):
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(maximum(z, 0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def rec_train_loss(p, batch: dict, cfg: RecConfig, shard_ctx=None):
    """The batch's training loss. With a context: from this rank's rows,
    the global batch's loss on every rank; its backward pass gives this
    rank's share of the gradient (the shares sum to it over the data axes)."""
    batch = _feats(p, batch)
    with _on_mesh(shard_ctx):
        loss = _train_loss(p, batch, cfg, shard_ctx)
        if shard_ctx is not None:
            loss = psum(loss, shard_ctx.data_axes) / shard_ctx.n_data
        return loss


def _train_loss(p, batch: dict, cfg: RecConfig, shard_ctx):
    if cfg.arch in ("bst", "autoint"):
        return _bce(_serve_scores(p, batch, cfg, shard_ctx), batch["label"])
    if cfg.arch == "mind":
        u = _mind_interests(p, batch["history"], cfg)  # [B, J, D]
        t = _items(p, batch["target"])  # [B, D]
        # Label-aware attention -> in-batch sampled softmax.
        ui = (u @ t[:, :, None])[..., 0]  # [B, J]
        att = torch.softmax(ui * 2.0, dim=-1)
        user = (att[:, None, :] @ u)[:, 0]  # [B, D]
        labels = torch.arange(user.shape[0], device=user.device)
        if shard_ctx is not None:  # the in-batch negatives are the whole batch's
            labels = labels + mesh_coord(shard_ctx.mesh, shard_ctx.data_axes)[0] * user.shape[0]
            t = all_gather_tiled(t, tuple(shard_ctx.data_axes), 0)
        logits = (user @ t.T).to(torch.float32)  # [B, B] in-batch
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        return torch.mean(lse - gold)
    if cfg.arch == "bert4rec":
        pos = batch["mask_positions"].long()
        h = _bert4rec_hidden(p, batch["history"], cfg, pos)
        B, M = pos.shape
        hm = torch.gather(h, 1, pos[..., None].expand(B, M, h.shape[-1]))  # [B, M, D]
        flat = hm.reshape(B * M, cfg.embed_dim)
        labels = batch["mask_labels"].reshape(B * M)
        # Sampled softmax over a shared negative set (BERT4Rec-style): 4096
        # deterministic strided negatives and the gold column.
        n_neg = min(4096, cfg.n_items)
        neg_ids = torch.arange(n_neg, device=flat.device) * (cfg.n_items // n_neg)
        neg_emb = _items(p, neg_ids)  # [n_neg, D]
        gold_emb = _items(p, labels)  # [BM, D]
        neg_logits = dot_f32(flat, neg_emb.T)  # [BM, n_neg]
        gold_logit = torch.sum(flat.to(torch.float32) * gold_emb.to(torch.float32), dim=-1)
        lse = torch.logsumexp(torch.cat([neg_logits, gold_logit[:, None]], dim=1), dim=-1)
        return torch.mean(lse - gold_logit)
    raise ValueError(cfg.arch)


def _ranking_scores(p, feats: dict, candidates, cfg: RecConfig, shard_ctx):
    """BST/AutoInt: the full ranking tower over one piece of candidates."""
    C = candidates.shape[0]
    if cfg.arch == "bst":
        pooled, _ = _bst_seq(
            p, feats["history"], torch.zeros((1,), dtype=torch.int32,
                                              device=candidates.device), cfg
        )  # [1, D] user side, target slot zeroed
        fe = _lookup_fields(p, feats["fields"], cfg, shard_ctx).reshape(1, -1)
        t = _items(p, candidates)  # [C, D]
        z = torch.cat(
            [pooled.expand(C, pooled.shape[-1]), t, fe.expand(C, fe.shape[-1])], dim=-1)
        return _mlp(p["mlp"], z)[:, 0]
    # AutoInt: the candidate item takes the last field slot; user fields broadcast.
    f = feats["fields"].expand(C, cfg.n_fields).clone()
    f[:, -1] = candidates % cfg.field_vocab
    emb = _lookup_fields(p, f, cfg, shard_ctx)
    return _mlp(p["out"], _autoint_fields(p, emb, cfg))[:, 0]


def rec_retrieval_scores(p, feats: dict, candidates, cfg: RecConfig, shard_ctx=None):
    """Score ONE user against [C] candidate items -> [C].

    MIND/BERT4Rec: dot-product retrieval (user embedding vs item
    embeddings), the shape the anytime clustered scorer serves
    (``serve/retrieval.py``). BST/AutoInt: the full ranking tower over the
    candidates, ``CAND_CHUNK`` at a time.
    """
    feats = _feats(p, feats)
    candidates = torch.as_tensor(candidates, device=p["item_emb"].device)
    with _on_mesh(shard_ctx):
        return _retrieval_scores(p, feats, candidates, cfg, shard_ctx)


def _retrieval_scores(p, feats, candidates, cfg, shard_ctx):
    if cfg.arch in ("mind", "bert4rec"):
        u = rec_user_embedding(p, feats, cfg)[0]  # [J, D]
        t = _items(p, candidates)  # [C, D]
        return torch.amax(t @ u.T, dim=-1)
    if cfg.arch in ("bst", "autoint"):
        return torch.cat([
            _ranking_scores(p, feats, candidates[c0:c0 + CAND_CHUNK], cfg, shard_ctx)
            for c0 in range(0, candidates.shape[0], CAND_CHUNK)])
    raise ValueError(cfg.arch)


def _spec_tree(node):
    if isinstance(node, Params):
        return {k: _spec_tree(node[k]) for k in node.keys()}
    if isinstance(node, nn.ModuleList):
        return [_spec_tree(v) for v in node]
    if isinstance(node, dict):
        return {k: _spec_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_spec_tree(v) for v in node]
    return P()


def rec_param_specs(p_example, cfg: RecConfig, model_axis: str = "model"):
    """Embedding tables row-sharded over model; small nets replicated.
    ``p_example`` is a ``Params`` or the reference's tree."""
    del cfg
    specs = _spec_tree(p_example)
    specs["item_emb"] = P(model_axis, None)
    if "field_emb" in specs:
        specs["field_emb"] = P(model_axis, None)
    return specs


