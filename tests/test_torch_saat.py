"""The port's SAAT baseline, Boolean conjunction and BoundSum against the reference's.

``core/saat.py`` (the JASS impact-ordered baseline) and ``core/boolean.py``
(the paper's §3 conjunctive mode) are numpy copies: built from the same
index (carried across with ``index_from_arrays``), every array of the
``ImpactIndex`` and every field of ``SaatResult`` / ``BooleanResult`` is
equal, at rho = None and at budgets, on the reference's own fixtures and
cases (``tests/test_saat.py``, ``tests/test_boolean.py``).
``core/bound_sum.py`` is torch on tensors: the sums and the order equal
the jitted reference's, ties (broken by range id) included.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boolean as ref_boolean
from repro.core import bound_sum as ref_bound_sum
from repro.core import saat as ref_saat
from repro.core.clustered_index import build_index as ref_build_index
from repro.data.synth import make_corpus as ref_make_corpus
from repro_torch.core import boolean, bound_sum, saat
from repro_torch.core.clustered_index import INDEX_ARRAYS, build_index, index_from_arrays
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.core.reorder import arrange
from repro_torch.data.synth import make_corpus

IMPACT_FIELDS = ("docs", "imps", "seg_term", "seg_impact", "seg_start", "seg_end",
                 "term_seg_ptr")
RHOS = (None, 1, 50, 500, 10**9)


def _port_index(index):
    arrays = {n: getattr(index, n) for n in INDEX_ARRAYS if n not in ("doc_order",
                                                                       "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale)


@pytest.fixture(scope="module")
def port_index(index):
    return _port_index(index)


@pytest.fixture(scope="module")
def impact_pair(index, port_index):
    return ref_saat.build_impact_index(index), saat.build_impact_index(port_index)


def _same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


def test_impact_index_is_the_references(impact_pair):
    ref, port = impact_pair
    for f in IMPACT_FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (port.n_docs, port.n_terms) == (ref.n_docs, ref.n_terms)
    for bits in (8, 16):
        assert port.space_gib(bits) == ref.space_gib(bits)


@pytest.mark.parametrize("rho", RHOS, ids=[f"rho={r}" for r in RHOS])
def test_saat_query_is_the_references(impact_pair, queries, rho):
    """Every SaatResult field, for every conftest query and an empty one."""
    ref, port = impact_pair
    for q in [*queries, np.asarray([-1, -1], np.int32)]:
        for k in (1, 10):
            _same_fields(ref_saat.saat_query(ref, q, k=k, rho=rho),
                         saat.saat_query(port, q, k=k, rho=rho))


def test_jass_exhaustive_matches_oracle(port_index, impact_pair, queries):
    """The reference's own case, on the port: JASS-E scores == the oracle's."""
    _, port = impact_pair
    for q in queries[:6]:
        res = saat.saat_query(port, q, k=10, rho=None)
        _, osc = exhaustive_topk(port_index, q, 10)
        assert sorted(res.scores.tolist(), reverse=True) == sorted(osc.tolist(),
                                                                   reverse=True)


def test_reordering_improves_accumulator_locality(queries):
    """The reference's locality case (paper §5.2), on the port's copy of the
    conftest corpus."""
    kw = dict(n_docs=2500, n_terms=3000, n_topics=8, mean_doc_len=120, seed=0)
    pc = make_corpus(**kw)
    rows = {}
    for strategy, extra in (("random", dict(seed=0)),
                            ("clustered_bp", dict(n_ranges=8, bp_rounds=4))):
        port_idx = build_index(pc, arrangement=arrange(pc, strategy=strategy, **extra))
        ii = saat.build_impact_index(port_idx)
        rho = pc.n_docs // 10
        rows[strategy] = sum(saat.saat_query(ii, q, rho=rho).rows_touched for q in queries)
    assert rows["clustered_bp"] <= rows["random"]


def test_conjunction_is_the_references(index, port_index, queries):
    """Every BooleanResult field, for 1-, 2-, 3- and all-term conjunctions."""
    cases = []
    for q in queries:
        terms = [int(t) for t in q if t >= 0]
        cases += [terms[:1], terms[:2], terms[:3], terms]
    cases += [[-1], []]
    for terms in cases:
        qa = np.asarray(terms, np.int32)
        _same_fields(ref_boolean.conjunctive_query(index, qa),
                     boolean.conjunctive_query(port_index, qa))


def test_range_skipping_engages(port_index, queries):
    skipped = 0
    for q in queries:
        terms = [int(t) for t in q if t >= 0]
        if len(terms) >= 3:
            skipped += boolean.conjunctive_query(port_index, np.asarray(terms)).ranges_skipped
    assert skipped > 0


def test_conjunction_small_index_edges():
    """The reference's empty and single-term case, on both packages."""
    ref_idx = ref_build_index(ref_make_corpus(n_docs=200, n_terms=200, n_topics=4, seed=9),
                              n_ranges=4, strategy="clustered")
    port_idx = _port_index(ref_idx)
    t = int(port_idx.blk_term[0])
    for q in ([-1], [t]):
        qa = np.asarray(q)
        _same_fields(ref_boolean.conjunctive_query(ref_idx, qa),
                     boolean.conjunctive_query(port_idx, qa))
    s, e = port_idx.ptr[t], port_idx.ptr[t + 1]
    np.testing.assert_array_equal(boolean.conjunctive_query(port_idx, np.asarray([t])).doc_ids,
                                  np.sort(port_idx.docs[s:e]).astype(np.int64))


def _bound_cases(index, queries):
    rng = np.random.default_rng(5)
    V, R = index.bounds_dense.shape
    tied = np.zeros((6, 9), np.int32)
    tied[0, [1, 4, 7]] = 5  # equal sums: ranges 1, 4, 7 in id order
    tied[1, [0, 2]] = 3
    tied[2, :] = 3
    cases = [(index.bounds_dense, q) for q in queries]
    cases += [(index.bounds_dense, np.asarray([-1, -1], np.int32)),
              (index.bounds_dense, np.asarray([V - 1, 0, -1, V - 1], np.int32))]
    cases += [(tied, np.asarray(q, np.int32)) for q in ([0], [0, 1], [0, 1, 2], [2], [-1],
                                                        [3, 4])]
    wide = rng.integers(0, 2**30, size=(4, R), dtype=np.int32)  # int32 sum wraps
    cases.append((wide, np.asarray([0, 1, 2, 3], np.int32)))
    return cases


def test_bound_sums_and_order_are_the_references(index, queries):
    for bounds, q in _bound_cases(index, queries):
        want = ref_bound_sum.bound_sums(jnp.asarray(bounds), jnp.asarray(q))
        got = bound_sum.bound_sums(torch.from_numpy(bounds), torch.from_numpy(q))
        assert got.dtype == torch.int32 and got.tolist() == np.asarray(want).tolist()
        for descending in (True, False):
            wo, wb = ref_bound_sum.range_order(want, descending=descending)
            go, gb = bound_sum.range_order(got, descending=descending)
            assert go.dtype == torch.int32
            assert go.tolist() == np.asarray(wo).tolist(), (q, descending)
            assert gb.tolist() == np.asarray(wb).tolist()


def test_bound_sum_order_matches_the_engine_plan(port_index, queries):
    """The tensor BoundSum is the host plan's: the same per-range sums and,
    over the ranges with a nonzero bound, the plan's order."""
    for q in queries:
        sums = bound_sum.bound_sums(torch.from_numpy(port_index.bounds_dense),
                                    torch.from_numpy(np.asarray(q, np.int32)))
        terms = [int(t) for t in q if t >= 0]
        want = port_index.bounds_dense[terms].sum(axis=0)
        assert sums.tolist() == want.tolist()
        order, _ = bound_sum.range_order(sums)
        assert order.tolist() == np.argsort(-want, kind="stable").tolist()
