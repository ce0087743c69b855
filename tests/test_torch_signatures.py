"""The port's constructors take the reference's arguments in its order.

A positional call written against the JAX package must mean the same
thing to the port: ``Engine(index, k, ordering, bounds, impl, interpret,
impact_dtype, docs_format, obs)`` and ``ShardedEngine(engine, n_shards,
use_mesh, mesh_axis, shards, obs)``, pinned with ``inspect.signature``.
The port may append its own arguments after the reference's (``device``).
``interpret`` (Pallas's interpret mode) is accepted and ignored; ``obs``
takes only None until the telemetry is ported.
"""

from __future__ import annotations

import inspect

import pytest
import torch

from repro.core import range_daat as jax_daat
from repro.serving import sharded as jax_sharded
from repro_torch.core import range_daat
from repro_torch.core.clustered_index import build_index
from repro_torch.data.synth import make_corpus
from repro_torch.serving import sharded

PAIRS = {
    "Engine": (jax_daat.Engine, range_daat.Engine, ("device",)),
    "ShardedEngine": (jax_sharded.ShardedEngine, sharded.ShardedEngine, ()),
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
            assert default == ref_defaults[n], f"{name}.{n}: {default!r}"


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
    with pytest.raises(NotImplementedError, match="A2"):
        range_daat.Engine(tiny_index, k=5, obs=object(), device="cpu")
    eng = range_daat.Engine(tiny_index, k=5, device="cpu")
    with pytest.raises(NotImplementedError, match="A2"):
        sharded.ShardedEngine(eng, 2, obs=object())
