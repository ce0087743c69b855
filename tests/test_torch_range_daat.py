"""Port index and range step vs the JAX reference, state by state.

The reference builds the index (``tests/conftest.py``); ``index_from_arrays``
carries it into the port, the way weights cross between frameworks. The
port's host build is a copy of the reference's and is pinned array for
array. ``score_range_step`` is compared after every range against the
reference ``Engine.step``, and the two selection hazards — ``lax.top_k``'s
lowest-index tie order and ``merge_topk``'s lexsort — on constructed ties.
All comparisons are exact.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import range_daat as jax_daat
from repro.core.clustered_index import build_index as jax_build_index
from repro.data.synth import make_corpus as jax_make_corpus
from repro.data.synth import make_query_log as jax_make_query_log
from repro.data.synth import planted_qrels as jax_planted_qrels
from repro.index_io import load_index, read_manifest
from repro_torch.core import range_daat
from repro_torch.core.clustered_index import INDEX_ARRAYS, build_index, index_from_arrays
from repro_torch.data.synth import make_corpus, make_query_log, planted_qrels

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_v1")


def port_index(ref_index):
    """The port's ClusteredIndex over a reference index's arrays."""
    arrays = {n: getattr(ref_index, n) for n in INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = ref_index.arrangement.doc_order
    arrays["range_ends"] = ref_index.arrangement.range_ends
    return index_from_arrays(
        arrays,
        n_docs=ref_index.n_docs,
        n_terms=ref_index.n_terms,
        strategy=ref_index.arrangement.strategy,
        quant_bits=ref_index.quantizer.bits,
        quant_scale=ref_index.quantizer.scale,
    )


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_index_from_arrays_keeps_fingerprint_and_layout(index, queries):
    pidx = port_index(index)
    assert pidx.fingerprint() == index.fingerprint()
    assert pidx.n_ranges == index.n_ranges
    assert pidx.max_range_size == index.max_range_size
    for fmt in ("int32", "packed"):
        for dt in ("int32", "int8"):
            assert pidx.device_bytes(dt, fmt) == index.device_bytes(dt, fmt)
    for q in queries[:4]:
        for a, b in zip(pidx.query_block_table(q), index.query_block_table(q)):
            np.testing.assert_array_equal(a, b)


def test_index_from_golden_artifact():
    """The pinned v1 artifact, loaded by the reference, crosses bitwise."""
    ref_index = load_index(GOLDEN)
    pidx = port_index(ref_index)
    assert pidx.fingerprint() == read_manifest(GOLDEN)["fingerprint"]
    assert pidx.fingerprint() == ref_index.fingerprint()


def test_index_from_arrays_names_missing_arrays():
    with pytest.raises(ValueError, match="tr_bound"):
        index_from_arrays({n: np.zeros(1) for n in INDEX_ARRAYS if n != "tr_bound"},
                          n_docs=1, n_terms=1, strategy="random", quant_bits=8,
                          quant_scale=1.0)


@pytest.mark.parametrize(
    "strategy", ["random", "bp", "clustered", "clustered_bp", "clustered_random"]
)
def test_port_build_equals_reference_build(strategy):
    """The port's copy of the host build gives the reference's arrays."""
    kw = dict(n_docs=400, n_terms=500, n_topics=4, mean_doc_len=40, seed=7)
    corpus, jcorpus = make_corpus(**kw), jax_make_corpus(**kw)
    assert corpus.fingerprint() == jcorpus.fingerprint()
    np.testing.assert_array_equal(
        make_query_log(corpus, n_queries=6, seed=2).terms,
        jax_make_query_log(jcorpus, n_queries=6, seed=2).terms,
    )
    a = build_index(corpus, n_ranges=4, strategy=strategy, bits=8, seed=1)
    b = jax_build_index(jcorpus, n_ranges=4, strategy=strategy, bits=8, seed=1)
    assert a.fingerprint() == b.fingerprint()
    for n in INDEX_ARRAYS:
        if n in ("doc_order", "range_ends"):
            np.testing.assert_array_equal(getattr(a.arrangement, n),
                                          getattr(b.arrangement, n))
        else:
            np.testing.assert_array_equal(getattr(a, n), getattr(b, n), err_msg=n)
    assert (a.quantizer.bits, a.quantizer.scale) == (b.quantizer.bits, b.quantizer.scale)


def _engines(index, impact_dtype, docs_format, k=10):
    ref = jax_daat.Engine(index, k=k, impl="xla", impact_dtype=impact_dtype,
                          docs_format=docs_format)
    port = range_daat.Engine(port_index(index), k=k, device="cpu",
                             impact_dtype=impact_dtype, docs_format=docs_format)
    return ref, port


def _assert_state_equal(jstate, tstate, ctx):
    np.testing.assert_array_equal(_np(tstate.vals), np.asarray(jstate.vals), ctx)
    np.testing.assert_array_equal(_np(tstate.ids), np.asarray(jstate.ids), ctx)
    assert int(tstate.postings) == int(jstate.postings), ctx
    assert int(tstate.blocks) == int(jstate.blocks), ctx
    assert tstate.vals.dtype == tstate.ids.dtype == torch.int32
    assert tstate.postings.dtype == tstate.blocks.dtype == torch.int32


@pytest.mark.parametrize("docs_format", ["int32", "packed"])
@pytest.mark.parametrize("impact_dtype", ["int32", "int8"])
def test_score_range_step_matches_reference_step(index, queries, impact_dtype,
                                                 docs_format):
    """Every range of every query: the port's state == the reference's."""
    ref, port = _engines(index, impact_dtype, docs_format)
    for qi, q in enumerate(queries[:6]):
        jplan, tplan = ref.plan(q), port.plan(q)
        np.testing.assert_array_equal(_np(tplan.blk_tab), np.asarray(jplan.blk_tab))
        np.testing.assert_array_equal(_np(tplan.rest_tab), np.asarray(jplan.rest_tab))
        np.testing.assert_array_equal(tplan.order_host, jplan.order_host)
        np.testing.assert_array_equal(tplan.bounds_host, jplan.bounds_host)
        js, ts = ref.init_state(), port.init_state()
        for i in range(index.n_ranges):
            js, ts = ref.step(jplan, js, i), port.step(tplan, ts, i)
            _assert_state_equal(js, ts, f"query {qi} range {i}")


def test_score_range_step_without_pruning(index, queries):
    ref, port = _engines(index, "int32", "int32")
    jplan, tplan = ref.plan(queries[0]), port.plan(queries[0])
    js, ts = ref.init_state(), port.init_state()
    for i in range(index.n_ranges):
        r = int(jplan.order_host[i])
        js = jax_daat.score_range_step(
            ref.dix, js, jplan.blk_tab[r], jplan.rest_tab[r], ref.dix.range_starts[r],
            s_pad=ref.s_pad, k=ref.k, prune_blocks=False,
        )
        ts = range_daat.score_range_step(
            port.dix, ts, tplan.blk_tab[r], tplan.rest_tab[r],
            port.dix.range_starts[r], s_pad=port.s_pad, k=port.k, prune_blocks=False,
        )
        _assert_state_equal(js, ts, f"range {i}")


def test_range_step_tie_order_matches_lax_top_k():
    """Constructed ties in one range: the lowest local ids win, as in top_k."""
    # One range of 256 docs; four blocks whose impacts make many equal sums.
    docs = np.concatenate([np.arange(0, 256, 2), np.arange(1, 256, 2),
                           np.arange(0, 128), np.arange(128, 256)]).astype(np.int32)
    imps = np.full(docs.shape[0], 5, np.int32)
    starts = np.arange(0, 512, 128, dtype=np.int32)
    k = 7
    jdix = jax_daat.DeviceIndex(
        docs=jnp.asarray(docs), impacts=jnp.asarray(imps),
        blk_start=jnp.asarray(starts), blk_len=jnp.full(4, 128, jnp.int32),
        blk_maximp=jnp.full(4, 5, jnp.int32), bounds_dense=jnp.zeros((1, 1), jnp.int32),
        range_starts=jnp.zeros(1, jnp.int32), range_sizes=jnp.full(1, 256, jnp.int32),
    )
    tdix = range_daat.DeviceIndex(
        *[torch.from_numpy(np.array(a)) for a in jdix if a is not None]
    )
    blk = np.array([0, 1, 2, 3, -1, -1, -1, -1], np.int32)
    rest = np.zeros(8, np.int32)
    js = jax_daat.score_range_step(
        jdix, jax_daat.init_state(k), jnp.asarray(blk), jnp.asarray(rest),
        jnp.int32(40), s_pad=256, k=k,
    )
    ts = range_daat.score_range_step(
        tdix, range_daat.init_state(k), torch.from_numpy(blk),
        torch.from_numpy(rest), torch.tensor(40, dtype=torch.int32), s_pad=256, k=k,
    )
    _assert_state_equal(js, ts, "tie range")
    assert _np(ts.ids).tolist() == [40, 41, 42, 43, 44, 45, 46]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_topk_and_range_topk_ties(seed):
    """Tie-heavy candidates: merge_topk == lexsort, range top-k == lax.top_k."""
    rng = np.random.default_rng(seed)
    k = 10
    vals = rng.choice([0, 3, 5, 9], size=64).astype(np.int32)
    ids = rng.permutation(1000)[:64].astype(np.int32)
    ids[vals == 0] = -1  # empty slots are (0, -1), as in the engine
    jv, ji = jax_daat.merge_topk(jnp.asarray(vals), jnp.asarray(ids), k)
    tv, ti = range_daat.merge_topk(torch.from_numpy(vals), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))

    acc = rng.choice([0, 1, 2, 7], size=300).astype(np.int32)
    jv, jl = jax.lax.top_k(jnp.asarray(acc), k)
    tv, tl = range_daat._range_topk(torch.from_numpy(acc), k)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))


def test_device_index_bytes_match_accounting(index):
    """Every uploaded tensor's bytes == the index's device_bytes report."""
    pidx = port_index(index)
    for fmt in ("int32", "packed"):
        for dt in ("int32", "int8"):
            eng = range_daat.Engine(pidx, device="cpu", impact_dtype=dt,
                                    docs_format=fmt)
            rep = pidx.device_bytes(dt, fmt)
            d = eng.dix
            docs = (d.pack_words.nbytes + d.pack_dir.nbytes + d.pack_first.nbytes
                    if fmt == "packed" else d.docs.nbytes)
            assert docs == rep["docs"]
            assert d.impacts.nbytes == rep["impacts"]
            for name in ("blk_start", "blk_len", "blk_maximp", "bounds_dense",
                         "range_starts", "range_sizes"):
                assert getattr(d, name).nbytes == rep[name], name


def test_quantum_resume_equals_one_traversal(index, queries):
    """A query stepped one range per call ends where one call ends."""
    port = range_daat.Engine(port_index(index), device="cpu", docs_format="packed")
    for q in queries[:4]:
        plan = port.plan(q)
        whole = port.traverse(plan, budget_postings=900)
        carry = range_daat.batched_init_carry(1, port.k)
        n = 0
        while not range_daat.carry_done(carry, index.n_ranges).all():
            carry = range_daat.batched_traverse_resume(
                port.dix, plan.blk_tab[None], plan.rest_tab[None], plan.order[None],
                plan.ordered_bounds[None], [900], [2**31 - 1], carry,
                s_pad=port.s_pad, k=port.k, quantum=1, safe_stop=True,
                prune_blocks=True, impl="torch", docs_format="packed",
            )
            n += 1
        res = range_daat.carry_result(carry)
        assert n >= int(res.ranges_processed[0])
        assert (int(res.ranges_processed[0]), bool(res.exit_safe[0]),
                bool(res.exit_budget[0])) == (
            whole.ranges_processed, whole.exit_safe, whole.exit_budget)
        assert torch.equal(res.state.vals[0], whole.state.vals)
        assert torch.equal(res.state.ids[0], whole.state.ids)
        assert int(res.state.postings[0]) == int(whole.state.postings)


def test_engine_rejects_cuda_impl_on_cpu(index):
    pidx = port_index(index)
    with pytest.raises(ValueError, match="impl='cuda'"):
        range_daat.Engine(pidx, device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        range_daat.Engine(pidx, device="cpu", impl="xla")
    assert range_daat.Engine(pidx, device="cpu").impl == "torch"


def test_init_carry_is_the_references():
    """A fresh single-query carry, field for field: 0-d cursor and flags,
    an empty heap."""
    for k in (1, 5, 10):
        got, want = range_daat.init_carry(k), jax_daat.init_carry(k)
        assert got._fields == want._fields and got.state._fields == want.state._fields
        for g, w in [(got.i, want.i), (got.exit_safe, want.exit_safe),
                     (got.exit_budget, want.exit_budget)] + list(zip(got.state, want.state)):
            w = np.asarray(w)
            assert g.shape == w.shape and str(g.dtype).removeprefix("torch.") == (
                "bool" if w.dtype == bool else str(w.dtype))
            assert _np(g).tolist() == w.tolist()


@pytest.mark.parametrize("n_rel", [1, 5, 20])
def test_planted_qrels_is_the_references(n_rel):
    kw = dict(n_docs=500, n_terms=600, n_topics=5, mean_doc_len=40, seed=11)
    corpus, jcorpus = make_corpus(**kw), jax_make_corpus(**kw)
    got = planted_qrels(corpus, make_query_log(corpus, n_queries=9, seed=3), n_rel)
    want = jax_planted_qrels(jcorpus, jax_make_query_log(jcorpus, n_queries=9, seed=3),
                             n_rel)
    assert got == want and any(got)
    assert [list(g) for g in got] == [list(w) for w in want]  # the same order
