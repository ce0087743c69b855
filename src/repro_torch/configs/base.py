"""Uniform architecture interface: configs -> params/steps, on one device.

The counterpart of the JAX package's ``configs/base.py``. Every
architecture is an ``Arch`` with:
  * ``model_config(reduced)`` — the exact published config, or a reduced
    same-family config for CPU tests;
  * ``shapes()`` — its input-shape cells (kind = train | prefill | decode |
    serve | retrieval; ``skip`` marks cells the reference excludes);
  * ``input_specs(cfg, shape)`` — meta-device tensors of the inputs'
    shapes and types (no allocation);
  * ``make_batch(cfg, shape, seed)`` — the reference's numpy arrays from the
    same seed (the reference draws with numpy too);
  * ``build_step(cfg, shape)`` — the train or serve step and its kind; a
    train step is ``trainer.make_train_step``'s ``(params, opt_state,
    batch) -> (params, opt_state, metrics)`` over the reference's loss,
    with the reference's ``AdamWConfig`` (the LM's moment dtype);
  * ``init_params(key, cfg, device)`` — random parameters (a generator's
    draws, not JAX's); ``param_shapes`` builds them on the meta device;
  * ``params_from_numpy(tree, cfg, device)`` — the reference's parameters
    (``jax.tree.map(np.asarray, params)``) carried across bit for bit;
    ``opt_state_from_numpy`` the same for an optimizer state, and
    ``params_to_numpy``/``opt_state_to_numpy`` the way back, as the
    reference's stacked numpy trees (bfloat16 as ``V2`` bits).

Every entry point runs on the card unless the caller passes
``device="cpu"``. Steps take numpy or tensors and run on the parameters'
device. The ``*_pspecs`` functions and a sharding context wait for the mesh
paths (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.range_daat import resolve_device
from repro_torch.data import graphs as G
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import params_from_tree, params_to_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (
    make_train_step,
    opt_state_from_tree,
    opt_state_to_tree,
)

__all__ = ["ShapeInfo", "Arch", "LMArch", "GNNArch", "RecArch"]


def needs_mesh(what: str):
    raise NotImplementedError(
        f"{what} lays the arrays out over a device mesh; the mesh paths are ROADMAP A7")


def _no_ctx(shard_ctx, what: str) -> None:
    if shard_ctx is not None:
        needs_mesh(f"{what} with a sharding context")


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeInfo:
    name: str
    kind: str  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    desc: str
    skip: Optional[str] = None  # reason, if this cell is excluded


class Arch:
    name: str = ""
    family: str = ""
    stacked: tuple[str, ...] = ()  # parameter segments the reference stacks [L, ...]

    def shapes(self) -> dict[str, ShapeInfo]:
        raise NotImplementedError

    def model_config(self, reduced: bool = False):
        raise NotImplementedError

    def init_params(self, key, cfg, device=None):
        raise NotImplementedError

    def param_shapes(self, cfg):
        """The parameters on the meta device (no allocation)."""
        return self.init_params(0, cfg, device="meta")

    def params_from_numpy(self, tree, cfg, device=None):
        raise NotImplementedError

    def params_to_numpy(self, params, cfg=None):
        """The parameters as the reference's stacked numpy tree."""
        return params_to_tree(params)

    def opt_state_from_numpy(self, tree, cfg=None, device=None):
        """The reference's optimizer state (``init_opt_state``'s tree of
        numpy arrays) as the port's, on ``device`` (None: the card)."""
        return opt_state_from_tree(tree, self.stacked, resolve_device(device))

    def opt_state_to_numpy(self, state, cfg=None):
        """The optimizer state as the reference's stacked numpy tree."""
        return opt_state_to_tree(state, self.stacked)

    def input_specs(self, cfg, shape: str):
        raise NotImplementedError

    def make_batch(self, cfg, shape: str, seed: int = 0):
        raise NotImplementedError

    def build_step(self, cfg, shape: str, shard_ctx=None):
        raise NotImplementedError

    def param_pspecs(self, cfg, params):
        needs_mesh(f"{self.name} param_pspecs")

    def batch_pspecs(self, cfg, shape: str, ctx):
        needs_mesh(f"{self.name} batch_pspecs")

    def moment_dtype(self, cfg) -> str:
        return "fp32"

    def model_flops_per_token(self, cfg) -> float:
        """6*N (dense) / 6*N_active (MoE), the MODEL_FLOPS basis."""
        return 0.0


# ---------------------------------------------------------------------- LM


_LM_SHAPES = {
    "train_4k": ShapeInfo("train_4k", "train", "seq 4096, global batch 256"),
    "prefill_32k": ShapeInfo("prefill_32k", "prefill", "seq 32768, batch 32"),
    "decode_32k": ShapeInfo(
        "decode_32k", "decode", "1 new token, KV len 32768, batch 128"
    ),
    "long_500k": ShapeInfo(
        "long_500k",
        "decode",
        "seq 524288, batch 1",
        skip="pure full-attention arch: O(n^2) softmax attention; sub-quadratic "
        "attention required for 500k decode (DESIGN.md §5)",
    ),
}

_LM_DIMS = {
    "train_4k": dict(batch=256, seq=4096),
    "prefill_32k": dict(batch=32, seq=32768),
    "decode_32k": dict(batch=128, seq=32768),
    "long_500k": dict(batch=1, seq=524288),
}
_LM_REDUCED_DIMS = {
    "train_4k": dict(batch=2, seq=64),
    "prefill_32k": dict(batch=2, seq=64),
    "decode_32k": dict(batch=2, seq=64),
    "long_500k": dict(batch=1, seq=64),
}


class LMArch(Arch):
    family = "lm"
    stacked = tfm.STACKED

    def __init__(self, name: str, full_cfg: Callable[[], tfm.LMConfig],
                 reduced_cfg: Callable[[], tfm.LMConfig], moments: str = "fp32",
                 fsdp: bool = False):
        self.name = name
        self._full = full_cfg
        self._reduced = reduced_cfg
        self._moments = moments
        # FSDP-style parameter sharding over the data axis on the reference's
        # mesh; read by the mesh paths (A7), not on one device.
        self.fsdp = fsdp

    def shapes(self):
        return dict(_LM_SHAPES)

    def model_config(self, reduced: bool = False):
        return self._reduced() if reduced else self._full()

    def init_params(self, key, cfg, device=None):
        return tfm.init_lm(key, cfg, device)

    def params_from_numpy(self, tree, cfg, device=None):
        """``init_lm``'s tree: the stacked ``dense``/``moe`` segments become
        per-layer modules, the MTP head crosses too."""
        return params_from_tree(tree, device, stacked=self.stacked)

    def moment_dtype(self, cfg):
        return self._moments

    def model_flops_per_token(self, cfg):
        total, active = tfm.count_params(cfg)
        del total
        return 6.0 * active

    def _dims(self, cfg, shape):
        table = _LM_DIMS if cfg.max_seq > 1024 else _LM_REDUCED_DIMS
        return table[shape]

    def input_specs(self, cfg, shape):
        d = self._dims(cfg, shape)
        B, S = d["batch"], d["seq"]
        if shape in ("train_4k", "prefill_32k"):
            return {"tokens": _meta((B, S))}
        if shape in ("decode_32k", "long_500k"):
            return {
                "tokens": _meta((B, 1)),
                "cache": tfm.init_cache(cfg, B, S, device="meta"),
                "pos": _meta(()),
            }
        raise KeyError(shape)

    def make_batch(self, cfg, shape, seed: int = 0, device=None):
        """The reference's arrays from ``seed``; a decode batch's cache is
        zeros on ``device`` (None: the card)."""
        d = self._dims(cfg, shape)
        B, S = d["batch"], d["seq"]
        rng = np.random.default_rng(seed)
        if shape in ("train_4k", "prefill_32k"):
            return {
                "tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
            }
        return {
            "tokens": rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32),
            "cache": tfm.init_cache(cfg, B, S, device=device),
            "pos": np.int32(S // 2),
        }

    variants = ("baseline", "split_kv")

    def build_step(self, cfg, shape, shard_ctx=None, variant: str = "baseline"):
        """``train_4k``: the train step over ``lm_loss``, with this arch's
        moment dtype. ``prefill_32k``: ``prefill(params, batch) -> (logits
        [B, 1, V], cache)``, chunks of ``min(4096, S)`` tokens through one cache (the
        reference's scan over chunks; ``variant="split_kv"`` without a mesh
        runs GQA as one chunk of S, as the reference does). ``decode_32k``
        (and ``long_500k``): ``decode(params, batch) -> (logits [B, 1, V],
        cache)``, the batch's cache updated in place."""
        _no_ctx(shard_ctx, f"{self.name} {shape}")
        if shape == "train_4k":
            def loss(p, b):
                return tfm.lm_loss(p, b["tokens"], cfg)
            return make_train_step(loss, AdamWConfig(moment_dtype=self._moments)), "train"
        impl = "split_kv" if variant == "split_kv" else "batch"
        ropes: dict = {}

        def rope_on(dev):
            if dev not in ropes:
                ropes[dev] = tfm.rope_table(cfg, cfg.max_seq, dev)
            return ropes[dev]

        if shape == "prefill_32k":
            def prefill(params, batch):
                dev = params["embed"].device
                tokens = torch.as_tensor(batch["tokens"], device=dev)
                B, S = tokens.shape
                cache = tfm.init_cache(cfg, B, S, device=dev)
                if impl == "split_kv" and not isinstance(cfg.attn, tfm.MLAConfig):
                    ch = S  # one model rank: the chunk is the whole sequence
                else:
                    ch = min(4096, S)
                if S % ch:
                    raise ValueError(f"prefill of {S} tokens in chunks of {ch}")
                logits = None
                for c0 in range(0, S, ch):
                    logits, cache = tfm.lm_decode_step(
                        params, tokens[:, c0:c0 + ch], cache, c0, cfg, None,
                        logits_last_only=True, decode_impl=impl, rope=rope_on(dev),
                    )
                return logits, cache
            return prefill, "serve"

        def decode(params, batch):
            return tfm.lm_decode_step(
                params, batch["tokens"], batch["cache"], int(batch["pos"]), cfg, None,
                logits_last_only=True, decode_impl=impl,
                rope=rope_on(params["embed"].device),
            )
        return decode, "serve"

    def param_pspecs(self, cfg, params, variant: str = "baseline", ctx=None):
        needs_mesh(f"{self.name} param_pspecs")

    def batch_pspecs(self, cfg, shape, ctx, variant: str = "baseline"):
        needs_mesh(f"{self.name} batch_pspecs")


# --------------------------------------------------------------------- GNN


class GNNArch(Arch):
    family = "gnn"

    _SHAPES = {
        "full_graph_sm": ShapeInfo(
            "full_graph_sm", "train", "full-batch, 2708 nodes / 10556 edges"
        ),
        "minibatch_lg": ShapeInfo(
            "minibatch_lg", "train", "sampled 1024-node batch, fanout 15-10"
        ),
        "ogb_products": ShapeInfo(
            "ogb_products", "train", "full-batch 2.45M nodes / 61.9M edges"
        ),
        "molecule": ShapeInfo(
            "molecule", "train", "128 graphs x 30 nodes, graph classification"
        ),
    }

    # Edge counts are padded up to multiples of 512 so edge arrays shard
    # evenly on the reference's mesh; padding edges use src=-1.
    _DIMS = {
        "full_graph_sm": dict(nodes=2708, edges=10752, d=1433, classes=7),
        "minibatch_lg": dict(
            nodes=180224, edges1=15360, edges2=163840, d=602, classes=41,
            batch=1024,
        ),
        "ogb_products": dict(nodes=2449029, edges=61860352, d=100, classes=47),
        "molecule": dict(batch=128, n_nodes=30, n_edges=64, d=64, classes=32),
    }
    _DIMS_REDUCED = {
        "full_graph_sm": dict(nodes=200, edges=800, d=32, classes=7),
        "minibatch_lg": dict(
            nodes=500, edges1=64, edges2=320, d=32, classes=8, batch=16
        ),
        "ogb_products": dict(nodes=400, edges=1600, d=16, classes=8),
        "molecule": dict(batch=8, n_nodes=10, n_edges=20, d=16, classes=4),
    }

    variants = ("baseline", "sharded")

    def __init__(self, name: str):
        self.name = name

    def shapes(self):
        return dict(self._SHAPES)

    def model_config(self, reduced: bool = False):
        return gnn_mod.SAGEConfig(
            n_layers=2,
            d_in=-1,  # resolved per shape
            d_hidden=32 if reduced else 128,
            n_classes=-1,
            sample_sizes=(25, 10),
        )

    @staticmethod
    def _pad512(n: int) -> int:
        return (n + 511) // 512 * 512

    def _dims(self, cfg, shape):
        return (self._DIMS_REDUCED if cfg.d_hidden < 128 else self._DIMS)[shape]

    def _resolved(self, cfg, shape):
        d = self._dims(cfg, shape)
        return dataclasses.replace(cfg, d_in=d["d"], n_classes=d["classes"])

    def init_params(self, key, cfg_shape, device=None):
        return gnn_mod.init_sage(key, cfg_shape, device)

    def params_from_numpy(self, tree, cfg, device=None):
        """``init_sage``'s tree; its list of layers becomes a ModuleList."""
        return params_from_tree(tree, device)

    def input_specs(self, cfg, shape, variant: str = "baseline"):
        d = self._dims(cfg, shape)

        def f32(*s):
            return _meta(s, torch.float32)

        def i32(*s):
            return _meta(s)

        if shape in ("full_graph_sm", "ogb_products"):
            if variant == "sharded":
                # Nodes padded to a 512 multiple (even shards); edges binned
                # by dst-owner with 1.3x per-bin headroom (-1 padding);
                # agg0 = precomputed first-hop mean aggregate (SIGN trick).
                n_pad = self._pad512(d["nodes"])
                e_pad = self._pad512(int(d["edges"] * 1.3))
                return {
                    "feats": f32(n_pad, d["d"]),
                    "agg0": f32(n_pad, d["d"]),
                    "edges": i32(e_pad, 2),
                    "labels": i32(n_pad),
                }
            return {
                "feats": f32(d["nodes"], d["d"]),
                "edges": i32(d["edges"], 2),
                "labels": i32(d["nodes"]),
            }
        if shape == "minibatch_lg":
            return {
                "feats": f32(d["nodes"], d["d"]),
                "hop0_src": i32(d["edges1"]), "hop0_dst": i32(d["edges1"]),
                "hop1_src": i32(d["edges2"]), "hop1_dst": i32(d["edges2"]),
                "labels": i32(d["batch"]),
            }
        return {
            "feats": f32(d["batch"] * d["n_nodes"], d["d"]),
            "edges": i32(d["batch"] * d["n_edges"], 2),
            "graph_ids": i32(d["batch"] * d["n_nodes"]),
            "labels": i32(d["batch"]),
        }

    def make_batch(self, cfg, shape, seed: int = 0):
        d = self._dims(cfg, shape)
        if shape in ("full_graph_sm", "ogb_products"):
            g = G.make_graph(d["nodes"], d["edges"] - 8, d["d"], d["classes"], seed)
            edges = np.full((d["edges"], 2), -1, np.int32)
            edges[: g.edges.shape[0]] = g.edges  # tail = -1 padding
            return {"feats": g.feats, "edges": edges, "labels": g.labels}
        if shape == "minibatch_lg":
            g = G.make_graph(d["nodes"], max(d["edges2"], 4 * d["nodes"]), d["d"],
                             d["classes"], seed)
            ptr, nbrs = G.to_csr(g.n_nodes, g.edges)
            rng = np.random.default_rng(seed)
            batch = rng.choice(g.n_nodes, size=d["batch"], replace=False)
            sub = G.sample_subgraph(ptr, nbrs, g.feats, g.labels, batch, (15, 10), seed)
            feats = np.zeros((d["nodes"], d["d"]), np.float32)
            feats[: sub["feats"].shape[0]] = sub["feats"][: d["nodes"]]

            def pad(a, n):
                out = np.full(n, -1, np.int32)
                out[: min(len(a), n)] = a[:n]
                return out
            return {
                "feats": feats,
                "hop0_src": pad(sub["hops"][0][0], d["edges1"]),
                "hop0_dst": pad(sub["hops"][0][1], d["edges1"]),
                "hop1_src": pad(sub["hops"][1][0], d["edges2"]),
                "hop1_dst": pad(sub["hops"][1][1], d["edges2"]),
                "labels": sub["labels"],
            }
        feats, edges, gids, labels = G.make_molecule_batch(
            d["batch"], d["n_nodes"], d["n_edges"], d["d"], d["classes"], seed
        )
        return {"feats": feats, "edges": edges, "graph_ids": gids, "labels": labels}

    def build_step(self, cfg, shape, shard_ctx=None, variant: str = "baseline"):
        """The train step of a shape; ``variant="sharded"`` with a context
        partitions the graph over a mesh (ROADMAP A7)."""
        _no_ctx(shard_ctx, f"{self.name} {shape}")
        rcfg = self._resolved(cfg, shape)

        if shape in ("full_graph_sm", "ogb_products"):
            def loss(p, b):
                logits = gnn_mod.sage_forward(p, b["feats"], b["edges"], rcfg)
                return gnn_mod.sage_loss(logits, b["labels"])
        elif shape == "minibatch_lg":
            def loss(p, b):
                hops = [(b["hop0_src"], b["hop0_dst"]), (b["hop1_src"], b["hop1_dst"])]
                logits = gnn_mod.sage_forward_sampled(
                    p, b["feats"], hops, rcfg, b["labels"].shape[0]
                )
                return gnn_mod.sage_loss(logits, b["labels"])
        else:
            def loss(p, b):
                logits = gnn_mod.sage_forward_graphs(
                    p, b["feats"], b["edges"], b["graph_ids"],
                    b["labels"].shape[0], rcfg,
                )
                return gnn_mod.sage_loss(logits, b["labels"])

        return make_train_step(loss, AdamWConfig()), "train"

    def param_pspecs(self, cfg, params, variant: str = "baseline", ctx=None):
        needs_mesh(f"{self.name} param_pspecs")

    def batch_pspecs(self, cfg, shape, ctx, variant: str = "baseline"):
        needs_mesh(f"{self.name} batch_pspecs")


# ------------------------------------------------------------------ RecSys


_REC_SHAPES = {
    "train_batch": ShapeInfo("train_batch", "train", "global batch 65536"),
    "serve_p99": ShapeInfo("serve_p99", "serve", "online batch 512"),
    "serve_bulk": ShapeInfo("serve_bulk", "serve", "offline batch 262144"),
    "retrieval_cand": ShapeInfo(
        "retrieval_cand", "retrieval", "1 query vs 1M candidates"
    ),
}
_REC_BATCH = {
    "train_batch": 65536,
    "serve_p99": 512,
    "serve_bulk": 262144,
    "retrieval_cand": 1,
}
_REC_BATCH_REDUCED = {
    "train_batch": 64,
    "serve_p99": 16,
    "serve_bulk": 64,
    "retrieval_cand": 1,
}
_REC_CANDIDATES = 1_000_000
_REC_CANDIDATES_REDUCED = 2048


class RecArch(Arch):
    family = "recsys"

    def __init__(self, name, full_cfg, reduced_cfg):
        self.name = name
        self._full = full_cfg
        self._reduced = reduced_cfg

    def shapes(self):
        return dict(_REC_SHAPES)

    def model_config(self, reduced: bool = False):
        return self._reduced() if reduced else self._full()

    def init_params(self, key, cfg, device=None):
        return rec_mod.init_rec(key, cfg, device)

    def params_from_numpy(self, tree, cfg, device=None):
        """``init_rec``'s tree; its lists (blocks, MLP layers, AutoInt's
        attention layers) become ``nn.ModuleList``s."""
        return params_from_tree(tree, device)

    def _is_reduced(self, cfg):
        return cfg.name.endswith("-smoke")

    def _feature_specs(self, cfg, B: int, train: bool):
        out: dict[str, Any] = {}
        if cfg.arch in ("bst", "mind", "bert4rec"):
            out["history"] = _meta((B, cfg.seq_len))
        if cfg.arch in ("bst", "mind", "bert4rec"):
            out["target"] = _meta((B,))
        if cfg.arch in ("bst", "autoint"):
            out["fields"] = _meta((B, cfg.n_fields))
        if train:
            if cfg.arch in ("bst", "autoint"):
                out["label"] = _meta((B,), torch.float32)
            if cfg.arch == "bert4rec":
                m = max(1, cfg.seq_len // 10)
                out["mask_positions"] = _meta((B, m))
                out["mask_labels"] = _meta((B, m))
                out.pop("target")
        return out

    def input_specs(self, cfg, shape):
        B = (_REC_BATCH_REDUCED if self._is_reduced(cfg) else _REC_BATCH)[shape]
        specs = self._feature_specs(cfg, B, train=shape == "train_batch")
        if shape == "retrieval_cand":
            C = _REC_CANDIDATES_REDUCED if self._is_reduced(cfg) else _REC_CANDIDATES
            specs["candidates"] = _meta((C,))
        return specs

    def make_batch(self, cfg, shape, seed: int = 0):
        rng = np.random.default_rng(seed)
        specs = self.input_specs(cfg, shape)
        out = {}
        for k, s in specs.items():
            if k == "label":
                out[k] = rng.integers(0, 2, size=s.shape).astype(np.float32)
            elif k == "history":
                out[k] = rng.integers(-1, cfg.n_items, size=s.shape).astype(np.int32)
            elif k in ("target", "candidates", "mask_labels"):
                out[k] = rng.integers(0, cfg.n_items, size=s.shape).astype(np.int32)
            elif k == "mask_positions":
                out[k] = rng.integers(0, cfg.seq_len, size=s.shape).astype(np.int32)
            elif k == "fields":
                out[k] = rng.integers(0, cfg.field_vocab, size=s.shape).astype(
                    np.int32
                )
            else:
                raise KeyError(k)
        return out

    def build_step(self, cfg, shape, shard_ctx=None):
        """``train_batch``: the train step over ``rec_train_loss``;
        ``serve_*``: ``serve(params, batch) -> [B]`` scores;
        ``retrieval_cand``: ``retrieve(params, batch) -> [C]``."""
        _no_ctx(shard_ctx, f"{self.name} {shape}")
        if shape == "train_batch":
            def loss(p, b):
                return rec_mod.rec_train_loss(p, b, cfg)
            return make_train_step(loss, AdamWConfig()), "train"
        if shape in ("serve_p99", "serve_bulk"):
            def serve(params, batch):
                return rec_mod.rec_serve_scores(params, batch, cfg)
            return serve, "serve"

        def retrieve(params, batch):
            feats = {k: v for k, v in batch.items() if k != "candidates"}
            return rec_mod.rec_retrieval_scores(params, feats, batch["candidates"], cfg)
        return retrieve, "serve"
