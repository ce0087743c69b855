"""The port's partitioned IR and anytime MIPS against the reference's, on the CPU.

``serve/distributed_ir.py``: the ISN sub-indexes, their stacked arrays and
the per-shard plan tables equal the reference's array for array; M = 1
reproduces the reference's one-device query (its ``test_single_shard_
reduces_to_engine``) bitwise; M = 4, whose Q x M lanes run as one
traversal over stacked shards here, equals the reference's per-shard
traversal and broker merge bitwise and the merged per-shard exhaustive
oracles on the score lists; the broker merge keeps tied scores in their
gathered (shard-major) order, as the reference's stable ``argsort`` does.

``serve/retrieval.py`` (float32): the reference's five cases of
``tests/test_retrieval.py``, each also held against the reference's
result: ids, ``ranges_processed``, ``candidates_scored`` and ``exit_safe``
exactly, scores within rtol 1e-5 / atol 1e-5, ids differing only where
scores lie within that tolerance of each other; exact score ties keep
the lower index first, as ``lax.top_k`` does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synth import make_corpus, make_query_log
from repro.distributed.sharding import ShardCtx
from repro.serve import distributed_ir as ref_ir
from repro.serve import retrieval as ref_mips
from repro_torch.core.oracle import exhaustive_topk
from repro_torch.data.synth import make_corpus as port_make_corpus
from repro_torch.kernels.range_scorer import ref as scorer_ref
from repro_torch.serve import distributed_ir, retrieval

ARRAY_FIELDS = ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
                "doc_base")
RTOL = ATOL = 1e-5


# --------------------------------------------------------------------------
# partitioned IR
# --------------------------------------------------------------------------


def _one_card_ctx():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")


@pytest.fixture(scope="module")
def four_shards():
    """The reference's multi-device case at M = 4 (1,600 docs, 4 ranges a
    shard, 8 queries), built by both packages."""
    kw = dict(n_docs=1600, n_terms=1200, n_topics=6, mean_doc_len=40, seed=3)
    corpus = make_corpus(**kw)
    ql = make_query_log(corpus, n_queries=8, seed=4)
    ref = ref_ir.build_sharded_index(corpus, n_shards=4, n_ranges_per_shard=4)
    port = distributed_ir.build_sharded_index(port_make_corpus(**kw), n_shards=4,
                                              n_ranges_per_shard=4, device="cpu")
    return ref, port, ql.terms


def _same_build(ref, port):
    (ra, re), (pa, pe) = ref, port
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(ra, f)), getattr(pa, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pa.s_pad, pa.k) == (ra.s_pad, ra.k)
    assert [e.index.fingerprint() for e in pe] == [e.index.fingerprint() for e in re]


def test_build_and_plan_are_the_references(four_shards):
    ref, port, terms = four_shards
    _same_build(ref, port)
    for a, b in zip(ref_ir.plan_queries(ref[1], terms), distributed_ir.plan_queries(port[1],
                                                                                  terms)):
        assert b.dtype == np.int32 and np.array_equal(np.asarray(a), b)


def test_single_shard_reduces_to_engine(corpus, queries):
    """M=1 reproduces the reference's one-device query and the exhaustive
    oracle (the reference's test, on the conftest corpus)."""
    ref = ref_ir.build_sharded_index(corpus, n_shards=1, n_ranges_per_shard=8)
    port = distributed_ir.build_sharded_index(
        port_make_corpus(n_docs=2500, n_terms=3000, n_topics=8, mean_doc_len=120, seed=0),
        n_shards=1, n_ranges_per_shard=8, device="cpu")
    _same_build(ref, port)
    q = np.stack([queries[0], queries[1]])
    tables = distributed_ir.plan_queries(port[1], q)
    vals, ids, ranges = distributed_ir.sharded_anytime_query(port[0], tables, None)
    rv, ri, rr = ref_ir.sharded_anytime_query(ref[0], ref_ir.plan_queries(ref[1], q),
                                              _one_card_ctx())
    assert vals.dtype == torch.int32 and ids.dtype == torch.int32
    assert vals.tolist() == np.asarray(rv).tolist() and ids.tolist() == np.asarray(ri).tolist()
    assert int(ranges) == int(rr)
    for qi in range(2):
        _, osc = exhaustive_topk(port[1][0].index, q[qi], 10)
        got = sorted([v for v in vals[qi].tolist() if v > 0], reverse=True)
        assert got == sorted(osc.tolist(), reverse=True)
    # A one-device context of the reference's kind runs here too.
    again = distributed_ir.sharded_anytime_query(port[0], tables, _one_card_ctx())
    assert again[1].tolist() == ids.tolist()


def _ref_local(ref_arrays, tables, budget):
    """The reference's per-(query, shard) traversal (its shard_map body's
    ``_local_traverse``) and its broker merge, without a mesh."""
    blk, rest, order, bounds = (np.asarray(t) for t in tables)
    Q, M = blk.shape[:2]
    arr = tuple(np.asarray(getattr(ref_arrays, f)) for f in ARRAY_FIELDS[:-1])
    base = np.asarray(ref_arrays.doc_base)
    vals, gids, nr = [], [], 0
    for qi in range(Q):
        for m in range(M):
            v, i, r = ref_ir._local_traverse(
                tuple(jnp.asarray(a[m]) for a in arr), jnp.asarray(blk[qi, m]),
                jnp.asarray(rest[qi, m]), jnp.asarray(order[qi, m]),
                jnp.asarray(bounds[qi, m]), s_pad=ref_arrays.s_pad, k=ref_arrays.k,
                budget=budget)
            i = np.asarray(i)
            vals.append(np.asarray(v))
            gids.append(np.where(i >= 0, i + base[m], -1))
            nr += int(r)
    mv = jnp.asarray(np.stack(vals).reshape(Q, -1))
    mi = jnp.asarray(np.stack(gids).reshape(Q, -1))
    sel = jnp.argsort(-mv, axis=1)[:, :ref_arrays.k]
    return (np.asarray(jnp.take_along_axis(mv, sel, axis=1)),
            np.asarray(jnp.take_along_axis(mi, sel, axis=1)), nr)


@pytest.mark.parametrize("budget", [2**31 - 1, 300])
def test_four_shards_match_reference_and_merged_oracles(four_shards, budget):
    ref, port, terms = four_shards
    tables = distributed_ir.plan_queries(port[1], terms)
    vals, ids, ranges = distributed_ir.sharded_anytime_query(port[0], tables, None, budget)
    rv, ri, rr = _ref_local(ref[0], tables, budget)
    assert vals.tolist() == rv.tolist() and ids.tolist() == ri.tolist()
    assert int(ranges) == rr
    plain = distributed_ir.sharded_anytime_query(port[0], tables, None, budget, impl="torch")
    assert [t.tolist() for t in plain] == [vals.tolist(), ids.tolist(), ranges.tolist()]
    if budget < 2**31 - 1:
        return
    for qi in range(len(terms)):  # the reference's subprocess oracle, at M = 4
        merged = []
        for e in port[1]:
            merged.extend(exhaustive_topk(e.index, terms[qi], 10)[1].tolist())
        expect = [e for e in sorted(merged, reverse=True)[:10] if e > 0]
        assert sorted([v for v in vals[qi].tolist() if v > 0], reverse=True) == expect


def test_one_launch_over_every_query_and_shard(four_shards, monkeypatch):
    """The Q x M lanes are one traversal call over the stacked shards."""
    _, port, terms = four_shards
    calls = []
    real = scorer_ref.traverse_ref

    def spy(dix, blk, *a, **kw):
        calls.append((tuple(dix.range_starts.shape), tuple(blk.shape)))
        return real(dix, blk, *a, **kw)

    monkeypatch.setattr(scorer_ref, "traverse_ref", spy)
    distributed_ir.sharded_anytime_query(port[0], distributed_ir.plan_queries(
        port[1], terms), None)
    R = port[0].range_starts.shape[1]
    assert [c[:1] for c in calls] == [((4, R),)] and calls[0][1][0] == len(terms) * 4


def test_broker_merge_keeps_gathered_order_on_ties():
    """Ties keep their shard-major gathered position (the reference's stable
    argsort), not the docid-ascending order of serving.sharded's merge."""
    rng = np.random.default_rng(0)
    Q, M, k = 5, 4, 6
    vals = np.sort(rng.integers(0, 4, size=(Q, M, k)), axis=2)[:, :, ::-1].astype(np.int32)
    gids = rng.permutation(Q * M * k).reshape(Q, M, k).astype(np.int32)
    gids[vals == 0] = -1
    vals[0, :, 0] = 9  # four shards tie at the top, larger docids first
    gids[0, :, 0] = [400, 300, 200, 100]
    got_v, got_i = distributed_ir.merge_shard_topk(torch.from_numpy(vals.copy()),
                                                   torch.from_numpy(gids.copy()), k)
    mv, mi = jnp.asarray(vals.reshape(Q, -1)), jnp.asarray(gids.reshape(Q, -1))
    sel = jnp.argsort(-mv, axis=1)[:, :k]
    assert got_v.tolist() == np.asarray(jnp.take_along_axis(mv, sel, axis=1)).tolist()
    assert got_i.tolist() == np.asarray(jnp.take_along_axis(mi, sel, axis=1)).tolist()
    assert got_i[0, :4].tolist() == [400, 300, 200, 100]


def test_multi_device_context_raises_naming_a7(four_shards):
    class Ctx:
        n_model, n_data = 4, 2

    _, port, terms = four_shards
    with pytest.raises(NotImplementedError, match="A7"):
        distributed_ir.sharded_anytime_query(
            port[0], distributed_ir.plan_queries(port[1], terms), Ctx())


# --------------------------------------------------------------------------
# anytime MIPS
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def candidates():
    rng = np.random.default_rng(0)
    # Clusterable embeddings: 8 planted directions + noise.
    centers = rng.normal(0, 1, size=(8, 32)).astype(np.float32)
    assign = rng.integers(0, 8, size=5000)
    emb = centers[assign] + 0.3 * rng.normal(0, 1, size=(5000, 32)).astype(np.float32)
    return emb.astype(np.float32)


@pytest.fixture(scope="module")
def cc(candidates):
    port = retrieval.build_clustered_candidates(candidates, n_clusters=16, seed=1,
                                                device="cpu")
    ref = ref_mips.build_clustered_candidates(candidates, n_clusters=16, seed=1)
    for f in ("emb", "ids", "lo", "hi"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return port, ref


def _brute_topk(emb, q, k):
    scores = emb @ np.asarray(q).T if np.asarray(q).ndim == 2 else emb @ np.asarray(q)
    if scores.ndim == 2:
        scores = scores.max(1)
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return order, scores[order]


def _mips(cc, q, **kw):
    """(port result, reference result) for one query, held together."""
    port, ref = cc
    got = retrieval.anytime_mips(port, q, **kw)
    want = ref_mips.anytime_mips(ref, jnp.asarray(q), **kw)
    assert (got.ranges_processed, got.candidates_scored, got.exit_safe) == (
        int(want.ranges_processed), int(want.candidates_scored), bool(want.exit_safe))
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    assert gs.dtype == ws.dtype == np.float32 and gi.dtype == wi.dtype == np.int32
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    for j in np.nonzero(gi != wi)[0]:  # only within a tolerance tie
        near = np.abs(ws - ws[j]) <= ATOL + RTOL * np.abs(ws[j])
        near[j] = False
        assert near.any(), (j, gi, wi, ws)
    return got


def test_safe_mips_matches_brute_force(candidates, cc):
    rng = np.random.default_rng(2)
    for _ in range(8):
        q = rng.normal(0, 1, size=32).astype(np.float32)
        res = _mips(cc, q, k=10)
        oid, osc = _brute_topk(candidates, q, 10)
        np.testing.assert_allclose(np.sort(res.scores.numpy()), np.sort(osc), rtol=1e-5)
        assert set(res.ids.tolist()) == set(oid.tolist())


def test_safe_exit_prunes_clusters(candidates, cc):
    rng = np.random.default_rng(3)
    processed = []
    for _ in range(8):
        q = candidates[rng.integers(0, len(candidates))]  # in-distribution
        processed.append(_mips(cc, q, k=10).ranges_processed)
    assert np.mean(processed) < cc[0].n_ranges


def test_budget_limits_work(cc):
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, size=32).astype(np.float32)
    res = _mips(cc, q, k=10, budget_candidates=600, safe_stop=False)
    assert res.candidates_scored <= 600 + cc[0].capacity
    res = _mips(cc, q, k=10, max_ranges=3, safe_stop=False)
    assert res.ranges_processed == 3 and not res.exit_safe


def test_anytime_quality_monotone(candidates, cc):
    rng = np.random.default_rng(5)
    gains = []
    for _ in range(6):
        q = rng.normal(0, 1, size=32).astype(np.float32)
        oid, _ = _brute_topk(candidates, q, 10)
        lo = _mips(cc, q, k=10, max_ranges=1, safe_stop=False)
        hi = _mips(cc, q, k=10)
        rec_lo = len(set(lo.ids.tolist()) & set(oid)) / 10
        rec_hi = len(set(hi.ids.tolist()) & set(oid)) / 10
        gains.append(rec_hi - rec_lo)
    assert np.mean(gains) >= 0


def test_multi_interest_query(cc, candidates):
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, size=(4, 32)).astype(np.float32)  # MIND interests
    res = _mips(cc, q, k=5)
    _, osc = _brute_topk(candidates, q, 5)
    np.testing.assert_allclose(np.sort(res.scores.numpy()), np.sort(osc), rtol=1e-5)


def test_exact_score_ties_take_the_lower_index_first():
    """Small-integer embeddings and queries, every candidate duplicated:
    every product is exact in any summation order, so scores tie exactly,
    and the port keeps the lower position first at every top-k and merge,
    as lax.top_k and the stable argsort do: its ids equal the reference's."""
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(300, 16)).astype(np.float32)
    emb = np.concatenate([base, base])
    port = retrieval.build_clustered_candidates(emb, n_clusters=6, seed=2, device="cpu")
    ref = ref_mips.build_clustered_candidates(emb, n_clusters=6, seed=2)
    ties = 0
    for _ in range(4):
        q = rng.integers(-3, 4, size=16).astype(np.float32)
        for kw in ({}, {"safe_stop": False}, {"max_ranges": 2}):
            got = retrieval.anytime_mips(port, q, k=8, **kw)
            want = ref_mips.anytime_mips(ref, jnp.asarray(q), k=8, **kw)
            assert got.ids.tolist() == np.asarray(want.ids).tolist()
            assert got.scores.tolist() == np.asarray(want.scores).tolist()
            assert (got.ranges_processed, got.candidates_scored, got.exit_safe) == (
                int(want.ranges_processed), int(want.candidates_scored),
                bool(want.exit_safe))
            scores = got.scores.tolist()
            ties += sum(a == b for a, b in zip(scores, scores[1:]))
    assert ties > 0
