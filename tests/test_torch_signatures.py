"""The port's constructors take the reference's arguments in its order.

A positional call written against the JAX package must mean the same
thing to the port: ``Engine(index, k, ordering, bounds, impl, interpret,
impact_dtype, docs_format, obs)``, ``ShardedEngine(engine, n_shards,
use_mesh, mesh_axis, shards, obs)``, ``BatchEngine``,
``ShardedBatchEngine``, ``MicroBatchServer`` and ``InflightServer`` with
their ``obs``, the dataclass fields of ``SlaBudgeter`` and
``ShardedSlaBudgeter``, and the three ``from_artifact`` class methods,
pinned with ``inspect.signature``. The port may append its own arguments
after the reference's (``device``). ``interpret`` (Pallas's interpret
mode) is accepted and ignored; ``obs`` is a ``repro_torch.obs`` handle.
"""

from __future__ import annotations

import dataclasses
import inspect

import pytest
import torch

from repro.core import range_daat as jax_daat
from repro.serving import batch_engine as jax_batch
from repro.serving import inflight as jax_inflight
from repro.serving import microbatch as jax_microbatch
from repro.serving import sharded as jax_sharded
from repro_torch.core import range_daat
from repro_torch.core.clustered_index import build_index
from repro_torch.data.synth import make_corpus
from repro_torch.obs import NOOP, Instrumentation
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
}
BUDGETERS = {
    "SlaBudgeter": (jax_microbatch.SlaBudgeter, microbatch.SlaBudgeter),
    "ShardedSlaBudgeter": (jax_microbatch.ShardedSlaBudgeter,
                           microbatch.ShardedSlaBudgeter),
}
LOADERS = {
    "Engine": (jax_daat.Engine, range_daat.Engine),
    "BatchEngine": (jax_batch.BatchEngine, batch_engine.BatchEngine),
    "ShardedEngine": (jax_sharded.ShardedEngine, sharded.ShardedEngine),
}


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
