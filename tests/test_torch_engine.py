"""The port's whole-query engine vs the JAX reference, on the CPU.

``tests/differential.py::observe_query`` reads every host-observable of a
traversal (doc ids, scores, postings, blocks, ranges processed, both exit
flags) from the reference ``Engine`` (impl ``xla``) and from the port's
``Engine(device="cpu")`` over the same index, and the two must be equal:
over int32/int8 impacts × int32/packed docids, unbudgeted, under postings
budgets and under ``max_ranges``. Safe exits must equal the exhaustive
oracle, and the host-driven anytime loop must agree with the reference's.

``tests/test_torch_cuda.py`` runs the kernels' engine against the plain one
on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
from differential import assert_results_equal, observe_query

from repro.core import anytime as jax_anytime
from repro.core import range_daat as jax_daat
from repro.core.oracle import exhaustive_topk as jax_exhaustive_topk
from repro_torch.core import anytime, range_daat
from repro_torch.core.clustered_index import INDEX_ARRAYS, index_from_arrays
from repro_torch.core.oracle import exhaustive_scores, exhaustive_topk

INT32_MAX = 2**31 - 1
CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]


@pytest.fixture(scope="module")
def port_idx(index):
    arrays = {n: getattr(index, n) for n in INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale,
    )


def _caps(mode: str, n: int):
    rng = np.random.default_rng(17)
    if mode == "budget":
        return rng.choice([1, 150, 600, 2000, INT32_MAX], size=n), None
    if mode == "max_ranges":
        return None, rng.choice([0, 1, 2, 5, INT32_MAX], size=n)
    return None, None


def _assert_engines_agree(ref, port, queries, budgets=None, max_ranges=None):
    for i, q in enumerate(queries):
        b = None if budgets is None else budgets[i]
        m = None if max_ranges is None else max_ranges[i]
        assert_results_equal(
            observe_query(ref, ref.plan(q), b, m),
            observe_query(port, port.plan(q), b, m),
            context=f"query {i}: reference vs port",
        )


@pytest.mark.parametrize("mode", ["unbudgeted", "budget", "max_ranges"])
@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_observe_query_matches_reference(index, port_idx, queries, impact_dtype,
                                         docs_format, mode):
    ref = jax_daat.Engine(index, k=10, impl="xla", impact_dtype=impact_dtype,
                          docs_format=docs_format)
    port = range_daat.Engine(port_idx, k=10, device="cpu",
                             impact_dtype=impact_dtype, docs_format=docs_format)
    budgets, max_ranges = _caps(mode, len(queries))
    _assert_engines_agree(ref, port, queries, budgets, max_ranges)


@pytest.mark.parametrize("ordering,bounds", [("docid", "range"), ("boundsum", "global")])
def test_baseline_orderings_match_reference(index, port_idx, queries, ordering,
                                            bounds):
    ref = jax_daat.Engine(index, k=10, impl="xla", ordering=ordering, bounds=bounds)
    port = range_daat.Engine(port_idx, k=10, device="cpu", ordering=ordering,
                             bounds=bounds)
    _assert_engines_agree(ref, port, queries)


def _assert_rank_safe(index, q, ids, vals, ctx):
    """The oracle's top-k up to ties at the k-th score.

    Safe stop and block pruning drop what cannot *beat* θ, so a document
    that only ties the k-th score may lose its place to a larger docid —
    the reference's ``tests/test_traversal.py`` compares score multisets
    for the same reason. Scores match exactly, the documents above the
    k-th score match in order, and every tied document truly scores θ.
    """
    oids, ovals = exhaustive_topk(index, q, len(vals) or 1)
    assert vals.tolist() == ovals.tolist(), ctx
    kth = int(vals[-1]) if len(vals) else 0
    assert ids[vals > kth].tolist() == oids[ovals > kth].tolist(), ctx
    assert (exhaustive_scores(index, q)[ids[vals == kth]] == kth).all(), ctx


@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_safe_traversal_equals_exhaustive_oracle(port_idx, queries, impact_dtype,
                                                 docs_format):
    port = range_daat.Engine(port_idx, k=10, device="cpu",
                             impact_dtype=impact_dtype, docs_format=docs_format)
    for i, q in enumerate(queries):
        res = port.traverse(port.plan(q))
        assert range_daat.exit_reasons(res)[0] in ("safe", "exhausted")
        ids, vals = port.topk_docs(res.state)
        _assert_rank_safe(port_idx, q, ids, vals, f"query {i}")


def test_port_oracle_equals_reference_oracle(index, port_idx, queries):
    for q in queries:
        a, b = exhaustive_topk(port_idx, q, 10), jax_exhaustive_topk(index, q, 10)
        assert a[0].tolist() == b[0].tolist() and a[1].tolist() == b[1].tolist()


@pytest.mark.parametrize("policy", [None, 1, 3])
def test_run_query_anytime_matches_reference(index, port_idx, queries, policy):
    ref = jax_daat.Engine(index, k=10, impl="xla", docs_format="packed")
    port = range_daat.Engine(port_idx, k=10, device="cpu", docs_format="packed")
    for i, q in enumerate(queries):
        a = jax_anytime.run_query_anytime(
            ref, ref.plan(q), None if policy is None else jax_anytime.Fixed(policy))
        b = anytime.run_query_anytime(
            port, port.plan(q), None if policy is None else anytime.Fixed(policy))
        ctx = f"query {i}"
        assert b.doc_ids.tolist() == a.doc_ids.tolist(), ctx
        assert b.scores.tolist() == a.scores.tolist(), ctx
        assert (b.postings, b.blocks, b.ranges_processed, b.exit_reason) == (
            a.postings, a.blocks, a.ranges_processed, a.exit_reason), ctx
        assert len(b.range_times_ms) == b.ranges_processed


def test_policies_match_reference_decisions():
    """The copied policies take the reference's decisions on one trace."""
    pairs = [
        (anytime.Overshoot(), jax_anytime.Overshoot()),
        (anytime.Undershoot(2.0), jax_anytime.Undershoot(2.0)),
        (anytime.Predictive(1.5), jax_anytime.Predictive(1.5)),
        (anytime.Reactive(alpha=1.0), jax_anytime.Reactive(alpha=1.0)),
    ]
    rng = np.random.default_rng(3)
    for mine, theirs in pairs:
        for _ in range(50):
            t, i, b = float(rng.uniform(0, 20)), int(rng.integers(0, 8)), 10.0
            assert mine.decide(t, i, b) == theirs.decide(t, i, b)
            mine.on_query_end(t, b)
            theirs.on_query_end(t, b)
        assert mine.name == theirs.name
    assert pairs[-1][0].trace == pairs[-1][1].trace
