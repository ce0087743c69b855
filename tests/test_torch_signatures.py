"""The port's constructors take the reference's arguments in its order.

A positional call written against the JAX package must mean the same
thing to the port: ``Engine(index, k, ordering, bounds, impl, interpret,
impact_dtype, docs_format, obs)``, ``ShardedEngine(engine, n_shards,
use_mesh, mesh_axis, shards, obs)``, ``BatchEngine``,
``ShardedBatchEngine``, ``MicroBatchServer`` and ``InflightServer`` with
their ``obs``, the dataclass fields of ``SlaBudgeter``,
``ShardedSlaBudgeter`` and ``ReshardPlanner``, the three ``from_artifact``
class methods; the control plane's ``ControlPlane`` (and its
``from_artifact``), ``ReplicaGroupEngine``, ``ReshardTask`` and
``HealthLedger``; and the functions ``restack_shards``,
``build_sharded_index``, ``sharded_anytime_query``,
``build_clustered_candidates`` and ``anytime_mips``, pinned with
``inspect.signature``; the model and registry surfaces too (``init_lm``,
``lm_forward``, ``init_cache``, ``lm_decode_step``, ``gqa``, ``mla``,
``moe_ffn``, ``init_rec``, ``rec_serve_scores``, ``rec_retrieval_scores``,
``make_sharded_query_fn``, ``sharded_query_specs`` and the ``Arch``
classes' methods), and the mesh surface (``make_mesh_dispatch``,
``distributed.sharding``'s meshes, ``shard_map`` and ``ShardCtx``). Every
module the reference has is ported but ``analysis/*`` and
``launch/{mesh,dryrun,roofline}.py``, and every ported module exports the
reference's names (``__all__``) but the three ``*_pallas`` launchers,
whose CUDA counterparts have their own names. The port may append its own arguments after the
reference's (``device``, ``impl``, ``rope``), and a dtype default is the
same type in the port's framework. ``interpret`` (Pallas's interpret
mode) is accepted and ignored; ``obs`` is a ``repro_torch.obs`` handle.
"""

from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path

import pytest
import torch

import jax.numpy as jnp

from repro import control as jax_control
from repro.configs import anytime_ir as jax_anytime_ir
from repro.configs import base as jax_base
from repro.core import clustered_index as jax_ci
from repro.core import range_daat as jax_daat
from repro.distributed import sharding as jax_sharding
from repro.models import attention as jax_attention
from repro.models import moe as jax_moe
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro.serve import distributed_ir as jax_ir
from repro.serve import retrieval as jax_mips
from repro.serving import batch_engine as jax_batch
from repro.serving import inflight as jax_inflight
from repro.serving import microbatch as jax_microbatch
from repro.serving import sharded as jax_sharded
from repro_torch import control
from repro_torch.configs import anytime_ir, base
from repro_torch.core import clustered_index, range_daat
from repro_torch.core.clustered_index import build_index
from repro_torch.data.synth import make_corpus
from repro_torch.distributed import sharding
from repro_torch.models import attention, moe, recsys, transformer
from repro_torch.obs import NOOP, Instrumentation
from repro_torch.serve import distributed_ir, retrieval
from repro_torch.serving import batch_engine, inflight, microbatch, sharded

PAIRS = {
    "Engine": (jax_daat.Engine, range_daat.Engine, ("device",)),
    "ShardedEngine": (jax_sharded.ShardedEngine, sharded.ShardedEngine, ()),
    "BatchEngine": (jax_batch.BatchEngine, batch_engine.BatchEngine, ()),
    "ShardedBatchEngine": (jax_sharded.ShardedBatchEngine, sharded.ShardedBatchEngine,
                           ()),
    "MicroBatchServer": (jax_microbatch.MicroBatchServer, microbatch.MicroBatchServer,
                         ()),
    "InflightServer": (jax_inflight.InflightServer, inflight.InflightServer, ()),
    "ControlPlane": (jax_control.ControlPlane, control.ControlPlane, ()),
    "ReplicaGroupEngine": (jax_control.ReplicaGroupEngine, control.ReplicaGroupEngine,
                           ()),
    "ReshardTask": (jax_control.ReshardTask, control.ReshardTask, ()),
    "HealthLedger": (jax_control.HealthLedger, control.HealthLedger, ()),
}
BUDGETERS = {
    "SlaBudgeter": (jax_microbatch.SlaBudgeter, microbatch.SlaBudgeter),
    "ShardedSlaBudgeter": (jax_microbatch.ShardedSlaBudgeter,
                           microbatch.ShardedSlaBudgeter),
    "ReshardPlanner": (jax_control.ReshardPlanner, control.ReshardPlanner),
}
LOADERS = {
    "Engine": (jax_daat.Engine, range_daat.Engine),
    "BatchEngine": (jax_batch.BatchEngine, batch_engine.BatchEngine),
    "ShardedEngine": (jax_sharded.ShardedEngine, sharded.ShardedEngine),
    "ControlPlane": (jax_control.ControlPlane, control.ControlPlane),
}
FUNCTIONS = {
    "restack_shards": (jax_ci.restack_shards, clustered_index.restack_shards, ()),
    "restack_prep": (jax_ci.restack_prep, clustered_index.restack_prep, ()),
    "build_sharded_index": (jax_ir.build_sharded_index, distributed_ir.build_sharded_index,
                            ("device",)),
    "plan_queries": (jax_ir.plan_queries, distributed_ir.plan_queries, ()),
    "sharded_anytime_query": (jax_ir.sharded_anytime_query,
                              distributed_ir.sharded_anytime_query, ("impl",)),
    "build_clustered_candidates": (jax_mips.build_clustered_candidates,
                                   retrieval.build_clustered_candidates, ("device",)),
    "anytime_mips": (jax_mips.anytime_mips, retrieval.anytime_mips, ()),
    "make_sharded_query_fn": (jax_ir.make_sharded_query_fn,
                              distributed_ir.make_sharded_query_fn, ("impl",)),
    "sharded_query_specs": (jax_ir.sharded_query_specs, distributed_ir.sharded_query_specs,
                            ()),
    "init_lm": (jax_transformer.init_lm, transformer.init_lm, ("device",)),
    "lm_forward": (jax_transformer.lm_forward, transformer.lm_forward, ("rope",)),
    "init_cache": (jax_transformer.init_cache, transformer.init_cache, ("device",)),
    "lm_decode_step": (jax_transformer.lm_decode_step, transformer.lm_decode_step,
                       ("rope",)),
    "gqa": (jax_attention.gqa, attention.gqa, ()),
    "mla": (jax_attention.mla, attention.mla, ()),
    "moe_ffn": (jax_moe.moe_ffn, moe.moe_ffn, ()),
    "init_rec": (jax_recsys.init_rec, recsys.init_rec, ("device",)),
    "rec_serve_scores": (jax_recsys.rec_serve_scores, recsys.rec_serve_scores, ()),
    "rec_retrieval_scores": (jax_recsys.rec_retrieval_scores,
                             recsys.rec_retrieval_scores, ()),
    "make_mesh_dispatch": (jax_sharded.make_mesh_dispatch, sharded.make_mesh_dispatch,
                           ()),
    "retrieval_mesh": (jax_sharding.retrieval_mesh, sharding.retrieval_mesh, ()),
    "replica_mesh": (jax_sharding.replica_mesh, sharding.replica_mesh, ()),
    "shard_map": (jax_sharding.shard_map, sharding.shard_map, ()),
    "named": (jax_sharding.named, sharding.named, ()),
    "data_spec": (jax_sharding.data_spec, sharding.data_spec, ()),
}
ARCH_CLASSES = {
    "Arch": (jax_base.Arch, base.Arch),
    "LMArch": (jax_base.LMArch, base.LMArch),
    "GNNArch": (jax_base.GNNArch, base.GNNArch),
    "RecArch": (jax_base.RecArch, base.RecArch),
    "AnytimeIRArch": (jax_anytime_ir.AnytimeIRArch, anytime_ir.AnytimeIRArch),
}
ARCH_METHODS = ("__init__", "shapes", "model_config", "init_params", "param_shapes",
                "input_specs", "make_batch", "build_step", "param_pspecs", "batch_pspecs",
                "moment_dtype", "model_flops_per_token")
ARCH_EXTRA = {"init_params": ("device",), "make_batch": ("device",)}


def _default(d):
    """A default, with a dtype as its name (``jnp.int32`` == ``torch.int32``)."""
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    if type(d).__name__ == "_ScalarMeta":
        return jnp.dtype(d).name
    return d


def _params(fn) -> list[tuple]:
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()]


def _positional(cls) -> list[tuple[str, object]]:
    params = list(inspect.signature(cls.__init__).parameters.values())[1:]
    return [(p.name, p.default) for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.fixture(scope="module")
def tiny_index():
    corpus = make_corpus(n_docs=300, n_terms=400, n_topics=2, mean_doc_len=30, seed=0)
    return build_index(corpus, n_ranges=4, strategy="clustered", bits=8)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_constructor_order_is_the_references(name):
    ref_cls, port_cls, extra = PAIRS[name]
    want = [n for n, _ in _positional(ref_cls)]
    got = [n for n, _ in _positional(port_cls)]
    assert got == want + list(extra), f"{name}: port {got}, reference {want}"
    # Every default but impl's ("xla" there, the card's kernels or the
    # plain path here) is the reference's.
    ref_defaults = dict(_positional(ref_cls))
    for n, default in _positional(port_cls):
        if n in ref_defaults and n != "impl":
            if n == "obs" and default is not None:  # each package's NOOP
                assert default is NOOP and type(ref_defaults[n]).__name__ == (
                    "NoopInstrumentation"), f"{name}.obs"
                continue
            assert default == ref_defaults[n], f"{name}.{n}: {default!r}"


@pytest.mark.parametrize("name", sorted(BUDGETERS))
def test_budgeter_fields_are_the_references(name):
    ref_cls, port_cls = BUDGETERS[name]
    want = [(f.name, f.default) for f in dataclasses.fields(ref_cls)]
    got = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        if n == "obs":
            assert g is NOOP and type(w).__name__ == "NoopInstrumentation"
        elif n != "policy":  # a default_factory on both sides
            assert g == w, f"{name}.{n}: {g!r} != {w!r}"


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_from_artifact_signature_is_the_references(name):
    ref_cls, port_cls = LOADERS[name]
    want = inspect.signature(ref_cls.from_artifact)
    got = inspect.signature(port_cls.from_artifact)
    assert [(p.name, p.kind, p.default) for p in got.parameters.values()] == [
        (p.name, p.kind, p.default) for p in want.parameters.values()]


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_signature_is_the_references(name):
    """Every parameter of the reference's, by name, kind and default, in its
    order, then the port's own (``device``, ``impl``)."""
    ref_fn, port_fn, extra = FUNCTIONS[name]
    want, got = _params(ref_fn), _params(port_fn)
    assert got[:len(want)] == want, f"{name}: port {got}, reference {want}"
    assert [n for n, _, _ in got[len(want):]] == list(extra), name
    assert all(d is None for _, _, d in got[len(want):]), name


@pytest.mark.parametrize("cls", sorted(ARCH_CLASSES))
def test_arch_methods_are_the_references(cls):
    """Each ``Arch`` class's methods take the reference's parameters in its
    order (inherited ones included), then the port's own ``device``."""
    ref_cls, port_cls = ARCH_CLASSES[cls]
    for method in ARCH_METHODS:
        want, got = _params(getattr(ref_cls, method)), _params(getattr(port_cls, method))
        extra = [n for n, _, _ in got[len(want):]]
        assert got[:len(want)] == want, f"{cls}.{method}: port {got}, reference {want}"
        assert set(extra) <= set(ARCH_EXTRA.get(method, ())), f"{cls}.{method}: {extra}"


def test_positional_engine_call_means_the_same(tiny_index):
    """Positional arguments up to docs_format land where the reference's do."""
    eng = range_daat.Engine(tiny_index, 5, "docid", "global", "torch", False, "int8",
                            "packed", None, "cpu")
    assert (eng.k, eng.ordering, eng.bounds, eng.impl, eng.impact_dtype,
            eng.docs_format, eng.device) == (5, "docid", "global", "torch", "int8",
                                             "packed", torch.device("cpu"))
    seng = sharded.ShardedEngine(eng, 2, False, "shard", None, None)
    assert seng.n_shards == 2 and len(seng.shards) == 2
    again = sharded.ShardedEngine(eng, 2, None, "shard", seng.shards)
    assert again.shards is seng.shards


def test_obs_handle_is_not_ported_yet(tiny_index):
    """The telemetry is ported now: every constructor takes the handle in
    the reference's place, and None (the servers' default) is ``NOOP``."""
    obs = Instrumentation()
    eng = range_daat.Engine(tiny_index, 5, "boundsum", "range", None, True, "int32",
                            "int32", obs, "cpu")
    assert eng.obs is obs
    assert range_daat.Engine(tiny_index, k=5, device="cpu").obs is NOOP
    seng = sharded.ShardedEngine(eng, 2, None, "shard", None, obs)
    assert seng.obs is obs
    assert sharded.ShardedBatchEngine(seng).obs is obs
    beng = batch_engine.BatchEngine(eng, None, obs)
    assert beng.obs is obs
    bud = microbatch.SlaBudgeter(10.0)
    assert bud.obs is NOOP
    srv = microbatch.MicroBatchServer(beng, bud, 4, None, obs)
    assert (srv.obs, srv.clock) == (obs, obs.clock)
    isrv = inflight.InflightServer(beng, bud, 4, 1, None, obs)
    assert (isrv.obs, isrv.clock) == (obs, obs.clock)


def test_shard_ctx_fields_are_the_references():
    """The reference's fields, then the port's own ``fsdp_specs`` (the FSDP
    placement the steps read; GSPMD carries it in the reference's arrays)."""
    want = [(f.name, f.default) for f in dataclasses.fields(jax_sharding.ShardCtx)]
    got = [(f.name, f.default) for f in dataclasses.fields(sharding.ShardCtx)]
    assert got == want + [("fsdp_specs", None)]
    assert sorted([n for n in dir(jax_sharding.ShardCtx) if not n.startswith("_")]
                  + ["fsdp_specs"]) == [n for n in dir(sharding.ShardCtx) if not n.startswith("_")]


ROOT = Path(__file__).resolve().parents[1]
# The reference's modules with no counterpart in the port: none since the
# analyzer (A8) and the launch tools (A9) were ported.
UNPORTED_MODULES: set = set()
# Pallas launchers whose CUDA counterparts carry other names (queue B).
RENAMED = {"kernels.range_scorer.kernel": {"scatter_accumulate_pallas",
                                           "unpack_locals_pallas"},
           "kernels.embedding_bag.kernel": {"bag_reduce_pallas"}}


def _modules(root: Path) -> set[str]:
    out = set()
    for path in root.rglob("*.py"):
        parts = list(path.relative_to(root).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts:
            out.add(".".join(parts))
    return out


def test_every_reference_module_is_ported_but_the_named_ones():
    """Module lists of ``src/repro`` and ``src/repro_torch`` (package
    ``__init__`` files aside: the reference's packages are namespaces)."""
    ref = _modules(ROOT / "src" / "repro")
    port = _modules(ROOT / "src" / "repro_torch")
    assert ref - port == UNPORTED_MODULES
    assert UNPORTED_MODULES <= ref


def _exports(name: str):
    import importlib

    return (getattr(importlib.import_module(f"repro.{name}"), "__all__", None),
            getattr(importlib.import_module(f"repro_torch.{name}"), "__all__", None))


@pytest.mark.parametrize("name", sorted(
    _modules(ROOT / "src" / "repro") - UNPORTED_MODULES))
def test_ported_module_exports_the_references_names(name):
    """``__all__`` of every ported pair: the reference's names are all the
    port's (the port may export more), the renamed launchers aside."""
    ref, port = _exports(name)
    if ref is None:
        return
    missing = set(ref) - set(port or ())
    assert missing == RENAMED.get(name, set()), f"{name}: {sorted(missing)}"
