"""The port's architecture registry against the reference's.

The same 11 names in the same order, each arch's ``shapes()`` (kind,
description, skip string) and variants; ``input_specs`` shapes and dtypes
at every full config, as meta tensors (no allocation); the parameters'
shapes and dtypes at every full LM and recsys config (``param_shapes`` on
the meta device against the reference's ``eval_shape``, a stacked ``[L,
...]`` leaf against its L layers); ``count_params``,
``model_flops_per_token`` and the moment dtype; ``make_batch``'s arrays;
the ``anytime-ir`` step against the reference's on a small built index
(bitwise); every ``train`` shape building and taking a step, and every mesh
function raising, naming its ROADMAP item.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.data.synth import make_corpus, make_query_log
from repro.models.transformer import count_params as ref_count_params
from repro.serve import distributed_ir as ref_ir
from repro_torch.configs import registry
from repro_torch.configs.registry import ARCHS
from repro_torch.data.synth import make_corpus as port_make_corpus
from repro_torch.models.transformer import count_params
from repro_torch.serve import distributed_ir

NAMES = list(REF_ARCHS)
SERVING = [n for n in NAMES if REF_ARCHS[n].family in ("lm", "recsys")]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else \
        np.dtype(dtype).name


def _spec_tree(tree):
    """Shapes and dtype names of a spec tree (either package's)."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_spec_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return (tuple(tree.shape), _dtype_name(tree.dtype))
    if hasattr(tree, "__dataclass_fields__"):  # ShardedIndexArrays
        return {f: _spec_tree(getattr(tree, f)) for f in tree.__dataclass_fields__}
    if isinstance(tree, int):
        return tree
    return (tuple(tree.shape), _dtype_name(tree.dtype))


def test_registry_is_the_references():
    assert list(ARCHS) == NAMES and len(NAMES) == 11
    for name in NAMES:
        ref, port = REF_ARCHS[name], ARCHS[name]
        assert (port.name, port.family) == (ref.name, ref.family)
        assert getattr(port, "variants", None) == getattr(ref, "variants", None)
        assert list(port.shapes()) == list(ref.shapes())
        for shape, info in ref.shapes().items():
            got = port.shapes()[shape]
            assert (got.name, got.kind, got.desc, got.skip) == (
                info.name, info.kind, info.desc, info.skip), (name, shape)
    for include in (False, True):
        got = [(a, s, i.kind, i.skip) for a, s, i in registry.all_cells(include)]
        want = [(a, s, i.kind, i.skip) for a, s, i in ref_registry.all_cells(include)]
        assert got == want
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def _config_fields(cfg):
    """A config's fields, dtypes by name (either package's)."""
    if hasattr(cfg, "__dataclass_fields__"):
        return {f: _config_fields(getattr(cfg, f)) for f in cfg.__dataclass_fields__}
    if isinstance(cfg, dict):
        return {k: _config_fields(v) for k, v in cfg.items()}
    if isinstance(cfg, torch.dtype) or type(cfg).__name__ in ("_ScalarMeta",):
        return _dtype_name(cfg)
    return cfg


@pytest.mark.parametrize("name", NAMES)
def test_model_configs_are_the_references(name):
    for reduced in (False, True):
        assert _config_fields(ARCHS[name].model_config(reduced)) == _config_fields(
            REF_ARCHS[name].model_config(reduced))


@pytest.mark.parametrize("name", NAMES)
def test_input_specs_at_full_configs(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    rcfg, cfg = ref.model_config(False), port.model_config(False)
    variants = ("baseline", "sharded") if ref.family == "gnn" else ("baseline",)
    for shape in ref.shapes():
        for variant in variants:
            kw = {} if variant == "baseline" else {"variant": variant}
            want = _spec_tree(ref.input_specs(rcfg, shape, **kw))
            got = _spec_tree(port.input_specs(cfg, shape, **kw))
            assert got == want, (name, shape, variant)


def _stacked_shapes(params, stacked=("dense", "moe")):
    """The port's parameter tree as the reference's: L layers of a stacked
    segment as one [L, ...] leaf."""
    out = {}
    for k in params.keys():
        child = params[k]
        if k in stacked:
            layer = _stacked_shapes(child[0], ())
            out[k] = jax.tree.map(lambda s: ((len(child), *s[0]), s[1]), layer,
                                  is_leaf=lambda x: isinstance(x, tuple))
            for other in child:
                assert _stacked_shapes(other, ()) == layer
        elif isinstance(child, torch.nn.ModuleList):
            out[k] = [_stacked_shapes(c, ()) for c in child]
        elif isinstance(child, torch.nn.Module):
            out[k] = _stacked_shapes(child, ())
        else:
            assert child.device.type == "meta" and not child.requires_grad
            out[k] = (tuple(child.shape), _dtype_name(child.dtype))
    return out


@pytest.mark.parametrize("name", SERVING)
def test_param_shapes_at_full_configs(name):
    """Published widths on the meta device: every leaf's shape and dtype."""
    ref, port = REF_ARCHS[name], ARCHS[name]
    want = jax.tree.map(lambda s: (tuple(s.shape), _dtype_name(s.dtype)),
                        ref.param_shapes(ref.model_config(False)))
    got = _stacked_shapes(port.param_shapes(port.model_config(False)))
    assert got == want


@pytest.mark.parametrize("name", [n for n in NAMES if REF_ARCHS[n].family == "lm"])
def test_counts_flops_and_moments(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    for reduced in (False, True):
        rcfg, cfg = ref.model_config(reduced), port.model_config(reduced)
        assert count_params(cfg) == ref_count_params(rcfg)
        assert port.model_flops_per_token(cfg) == ref.model_flops_per_token(rcfg)
        assert port.moment_dtype(cfg) == ref.moment_dtype(rcfg)
    assert port.fsdp == ref.fsdp
    total, active = count_params(port.model_config(False))
    assert total >= active > 0 and (total > active) == (port.model_config(False).moe
                                                         is not None)


@pytest.mark.parametrize("name", SERVING)
def test_make_batch_is_the_references(name):
    ref, port = REF_ARCHS[name], ARCHS[name]
    cases = [(True, s) for s in ref.shapes() if not ref.shapes()[s].skip]
    if ref.family == "recsys":
        cases += [(False, "serve_p99"), (False, "retrieval_cand")]
    else:
        cases += [(False, "prefill_32k")]
    for reduced, shape in cases:
        rcfg, cfg = ref.model_config(reduced), port.model_config(reduced)
        for seed in (0, 7):
            want = ref.make_batch(rcfg, shape, seed=seed)
            kw = {"device": "cpu"} if ref.family == "lm" else {}
            got = port.make_batch(cfg, shape, seed=seed, **kw)
            assert list(got) == list(want)
            for k, w in want.items():
                if k == "cache":
                    assert _spec_tree({k: jax.tree.map(np.asarray, w)}) == {
                        k: jax.tree.map(lambda t: (tuple(t.shape), _dtype_name(t.dtype)),
                                        got[k])}
                    assert all(int(t.count_nonzero()) == 0 for t in jax.tree.leaves(got[k]))
                    continue
                w = np.asarray(w)
                assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (shape, k)


# ------------------------------------------------------------------ anytime-ir


@pytest.fixture(scope="module")
def ir_index():
    kw = dict(n_docs=1600, n_terms=1200, n_topics=6, mean_doc_len=40, seed=3)
    corpus = make_corpus(**kw)
    terms = make_query_log(corpus, n_queries=8, seed=4).terms
    out = {}
    for m in (1, 4):
        ref = ref_ir.build_sharded_index(corpus, n_shards=m, n_ranges_per_shard=4)
        port = distributed_ir.build_sharded_index(port_make_corpus(**kw), n_shards=m,
                                                  n_ranges_per_shard=4, device="cpu")
        out[m] = (ref, port)
    return out, terms


def _ir_cfg(arrays, n_queries):
    cfg = ARCHS["anytime-ir"].model_config(True)
    M, nnz = arrays.docs.shape
    return dict(cfg, n_queries=n_queries, n_shards=M, nnz_loc=nnz,
                nb_loc=arrays.blk_start.shape[1], r_loc=arrays.range_starts.shape[1],
                s_pad=arrays.s_pad, k=arrays.k)


@pytest.mark.parametrize("shape", ["serve_anytime", "serve_exhaustive"])
def test_anytime_ir_step_is_the_references(ir_index, shape):
    """One shard: the registry's step equals the reference's bitwise (the
    reference's one-device mesh runs one shard a device)."""
    built, terms = ir_index
    (ref_arrays, ref_engines), (arrays, engines) = built[1]
    cfg = _ir_cfg(arrays, len(terms))
    ref_step, kind = REF_ARCHS["anytime-ir"].build_step(cfg, shape)
    step, pkind = ARCHS["anytime-ir"].build_step(cfg, shape)
    assert pkind == kind == "serve"
    tables = distributed_ir.plan_queries(engines, terms)
    want = ref_step(ref_arrays, {"tables": ref_ir.plan_queries(ref_engines, terms)})
    carried = ARCHS["anytime-ir"].params_from_numpy(
        {f: np.asarray(getattr(ref_arrays, f)) for f in
         ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
          "doc_base")}, cfg, device="cpu")
    for params in (arrays, carried):
        got = step(params, {"tables": tables})
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 or g.dtype == torch.int64
            assert np.asarray(g).tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("shape", ["serve_anytime", "serve_exhaustive"])
def test_anytime_ir_step_over_four_shards(ir_index, shape):
    """Four shards on one device: the step is ``sharded_anytime_query`` at
    the shape's budget (``nnz_loc // 64`` postings a lane, or none)."""
    built, terms = ir_index
    _, (arrays, engines) = built[4]
    tables = distributed_ir.plan_queries(engines, terms)
    cfg = dict(_ir_cfg(arrays, len(terms)), b_width=tables[0].shape[3])
    step, _ = ARCHS["anytime-ir"].build_step(cfg, shape)
    budget = cfg["nnz_loc"] // 64 if shape == "serve_anytime" else 2**31 - 1
    want = distributed_ir.sharded_anytime_query(arrays, tables, None, budget)
    got = step(arrays, {"tables": tables})
    for g, w in zip(got, want):
        assert g.tolist() == w.tolist()
    for t, spec in zip(tables, ARCHS["anytime-ir"].input_specs(cfg, shape)["tables"]):
        assert t.shape == tuple(spec.shape)


def test_anytime_ir_params_are_meta_specs():
    arch = ARCHS["anytime-ir"]
    cfg = arch.model_config(False)
    arrays = arch.param_shapes(cfg)
    assert arrays.docs.device.type == "meta" and tuple(arrays.docs.shape) == (16, 256_000_000)
    i8 = arch._with_variant(cfg, "i8")
    assert distributed_ir.sharded_query_specs(**i8)[0].impacts.dtype == torch.int8
    with pytest.raises(NotImplementedError):
        arch.make_batch(cfg, "serve_anytime")
    with pytest.raises(NotImplementedError, match="A7"):
        arch.build_step(cfg, "serve_anytime", shard_ctx=type("Ctx", (), {"n_model": 4})())


# --------------------------------------------------------------- what raises


@pytest.mark.parametrize("name", NAMES)
def test_train_shapes_and_mesh_functions_raise(name):
    """Every ``train`` shape builds and takes a step on the CPU (its
    parameters move, its state's step counts 1, its metrics are finite);
    every mesh function raises naming A7."""
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    arch = ARCHS[name]
    cfg = arch.model_config(True)
    for shape, info in arch.shapes().items():
        if info.kind == "train":
            step, kind = arch.build_step(cfg, shape)
            assert kind == "train"
            rcfg = arch._resolved(cfg, shape) if arch.family == "gnn" else cfg
            params = arch.init_params(0, rcfg, device="cpu")
            before = [p.clone() for p in params.parameters()]
            state = init_opt_state(params, AdamWConfig(moment_dtype=arch.moment_dtype(cfg)))
            params, state, metrics = step(params, state, arch.make_batch(cfg, shape, seed=1))
            assert int(state["step"]) == 1
            assert all(torch.isfinite(metrics[k]) for k in ("loss", "lr", "grad_norm"))
            assert any(not torch.equal(a, b) for a, b in zip(before, params.parameters()))
        if arch.family != "ir":
            with pytest.raises(NotImplementedError, match="A7"):
                arch.build_step(cfg, shape, shard_ctx=object())
    with pytest.raises(NotImplementedError, match="A7"):
        arch.param_pspecs(cfg, None)
    with pytest.raises(NotImplementedError, match="A7"):
        arch.batch_pspecs(cfg, next(iter(arch.shapes())), None)
