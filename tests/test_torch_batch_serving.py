"""The port's batched serving against the JAX package's, on the CPU.

One seeded synthetic index (the shared ``index`` fixture) is built once
with the JAX package and carried into the port with ``index_from_arrays``.
The port's bucketing copies, its ``BatchEngine`` (whose dispatch is the
``traverse`` kernel's plain version on the CPU), ``batched_traverse_resume``
and ``MicroBatchServer`` are then held against the reference's: the path
is integer, so every comparison is bitwise. ``tests/test_torch_cuda.py``
holds the ``traverse`` kernel against its plain version on the card.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from differential import assert_batch_matches_sequential

from repro.core import range_daat as jax_daat
from repro.core.anytime import Reactive as JaxReactive
from repro.serving import batch_engine as jax_batch_engine
from repro.serving import bucketing as jax_bucketing
from repro.serving import microbatch as jax_microbatch
from repro_torch.core import range_daat
from repro_torch.core.anytime import Reactive
from repro_torch.core.clustered_index import INDEX_ARRAYS, index_from_arrays
from repro_torch.kernels.range_scorer import kernel, ref
from repro_torch.launch import serve
from repro_torch.serving import batch_engine, bucketing, microbatch

CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]
INT32_MAX = 2**31 - 1
FIELDS = ("doc_ids", "scores", "ranges_processed", "postings", "blocks", "exit_safe",
          "exit_budget")


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


@pytest.fixture(scope="module")
def ragged(queries):
    """Plain queries, a 1-term stub and fat union queries: two width buckets."""
    stripped = [q[q >= 0] for q in queries]
    fat = np.unique(np.concatenate(stripped))
    return [stripped[0][:1]] + stripped[:8] + [fat, fat[::2]]


@pytest.fixture(scope="module")
def mixed(index, ragged):
    """Queries whose plans span four width buckets (32, 64, 128 and 256
    blocks): the ragged ones and long queries of 80 and 150 distinct terms.
    The first four hold one of each."""
    rng = np.random.default_rng(5)
    long = [np.unique(rng.choice(index.n_terms, nt, replace=False)).astype(np.int32)
            for nt in (80, 150, 150, 80)]
    return ([ragged[1], ragged[-2], long[0], long[1]] + ragged[2:6] + long[2:]
            + ragged[6:9] + [ragged[0], ragged[-1]])


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _engines(index, port_idx, impact_dtype, docs_format, impl="xla", k=10):
    jeng = jax_daat.Engine(index, k=k, impl=impl, interpret=True,
                           impact_dtype=impact_dtype, docs_format=docs_format)
    peng = range_daat.Engine(port_idx, k=k, device="cpu", impact_dtype=impact_dtype,
                             docs_format=docs_format)
    return jeng, peng


def _assert_results_equal(got, want, ctx):
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray) or hasattr(b, "shape"):
                a, b = _np(a), np.asarray(b)
                assert a.dtype == b.dtype and a.tolist() == b.tolist(), (
                    f"{ctx} query {i}: {name} {a} != {b}")
            else:
                assert type(a) is type(b) and a == b, f"{ctx} query {i}: {name} {a} != {b}"
        assert g.exit_reason == w.exit_reason, f"{ctx} query {i}"


# ------------------------------------------------------------------ bucketing


def test_bucket_ladders_match_reference():
    for n in range(0, 300, 7):
        for lo in (1, 2, 8, 32):
            for hi in (None, lo, 16, 64):
                if hi is not None and hi < lo:
                    for fn in (bucketing.bucket_pow2, jax_bucketing.bucket_pow2):
                        with pytest.raises(ValueError):
                            fn(n, lo=lo, hi=hi)
                    continue
                assert bucketing.bucket_pow2(n, lo=lo, hi=hi) == \
                    jax_bucketing.bucket_pow2(n, lo=lo, hi=hi), (n, lo, hi)
    with pytest.raises(ValueError):
        bucketing.bucket_pow2(10, lo=0)
    for kw in (dict(), dict(max_batch=16), dict(min_batch=2, max_batch=24),
               dict(min_width=64, max_batch=5), dict(min_batch=3, max_batch=3)):
        spec, jspec = bucketing.BucketSpec(**kw), jax_bucketing.BucketSpec(**kw)
        assert bucketing.batch_ladder(spec) == jax_bucketing.batch_ladder(jspec), kw
        for n in range(1, 70, 3):
            assert spec.width_bucket(n) == jspec.width_bucket(n)
            assert spec.batch_bucket(n) == jspec.batch_bucket(n)
    for kw in (dict(min_width=0), dict(min_batch=8, max_batch=4), dict(max_batch=0)):
        with pytest.raises(ValueError):
            bucketing.BucketSpec(**kw)


def test_saturate_bounds_warns_and_saturates_as_reference():
    b = np.array([0, 5, INT32_MAX, INT32_MAX + 1, 2**40], np.int64)
    with pytest.warns(RuntimeWarning, match="saturating"):
        got = bucketing.saturate_bounds(b)
    with pytest.warns(RuntimeWarning, match="saturating"):
        want = jax_bucketing.saturate_bounds(b)
    assert got.dtype == want.dtype == np.int32
    assert got.tolist() == want.tolist() == [0, 5, INT32_MAX, INT32_MAX, INT32_MAX]
    for fn in (bucketing.saturate_bounds, jax_bucketing.saturate_bounds):
        with pytest.raises(ValueError, match="negative"):
            fn(np.array([3, -1]))


@pytest.mark.parametrize("batch", [3, 8])
def test_stack_plans_matches_reference(index, port_idx, ragged, batch):
    jeng, peng = _engines(index, port_idx, "int8", "packed")
    jplans = [jeng.plan(q) for q in ragged[:3]]
    pplans = [peng.plan(q) for q in ragged[:3]]
    for jp, pp in zip(jplans, pplans):
        assert np.array_equal(pp.blk_tab_host, np.asarray(jp.blk_tab))
        assert np.array_equal(pp.rest_tab_host, np.asarray(jp.rest_tab))
        assert np.array_equal(_np(pp.blk_tab), pp.blk_tab_host)
    width = bucketing.bucket_pow2(max(p.blk_tab.shape[1] for p in pplans), lo=32)
    got = bucketing.stack_plans(pplans, width, batch)
    want = jax_bucketing.stack_plans(jplans, width, batch)
    for name in ("blk_tab", "rest_tab", "order", "ordered_bounds"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32 and g.device.type == "cpu", name
        assert np.array_equal(_np(g), w), name
    assert got.valid.tolist() == want.valid.tolist() == [True] * 3 + [False] * (batch - 3)
    # Dummy lanes are inert: no blocks, zero bounds, identity order.
    assert (_np(got.blk_tab)[3:] == -1).all() and (_np(got.ordered_bounds)[3:] == 0).all()
    # A BoundSum past 2^31 saturates in the stack, as in the reference.
    huge = pplans[0].bounds_host.copy()
    huge[0] = 2**31 + 12_345
    with pytest.warns(RuntimeWarning, match="saturating"):
        bp = bucketing.stack_plans([dataclasses.replace(pplans[0], bounds_host=huge)],
                                   width, 1)
    assert int(bp.ordered_bounds[0, 0]) == INT32_MAX
    with pytest.raises(ValueError):
        bucketing.stack_plans(pplans, width, 2)


@pytest.mark.parametrize("caps", ["uncapped", "list", "int32"])
def test_stack_table_stages_mixed_widths_in_place(port_idx, mixed, caps):
    """``stack_table`` stages plans of four width buckets at the widest
    plan's width and wider: each lane holds its plan's tables then -1 / 0
    columns, its order, its saturated bounds and its int32-clamped caps;
    the lanes past the plans stay inert. ``write_lane`` over a lane that
    held a wider plan leaves what a fresh lane gets. Bounds past 2^31
    saturate with a warning, a negative bound raises."""
    peng = range_daat.Engine(port_idx, k=10, device="cpu")
    plans = peng.plan_many(mixed[:6])
    n, R = len(plans), port_idx.n_ranges
    assert len({p.blk_tab_host.shape[1] for p in plans}) == 4
    budgets = max_ranges = None
    if caps != "uncapped":
        budgets = [5, INT32_MAX, 2**40, 0, 123, 7]
        max_ranges = [0, 3, INT32_MAX, 2**33, 1, 2]
        if caps == "int32":
            budgets = np.clip(budgets, 0, INT32_MAX).astype(np.int32)
            max_ranges = np.clip(max_ranges, 0, INT32_MAX).astype(np.int32)
    widest = max(p.blk_tab_host.shape[1] for p in plans)
    for width, batch in ((widest, n), (widest, 8), (2 * widest, 16)):
        got = bucketing.stack_table(plans, width, batch, budgets, max_ranges)
        assert (got.n_slots, got.n_ranges, got.width) == (batch, R, width)
        for i, p in enumerate(plans):
            w = p.blk_tab_host.shape[1]
            assert np.array_equal(got.blk[i, :, :w], p.blk_tab_host), (width, i)
            assert np.array_equal(got.rest[i, :, :w], p.rest_tab_host), (width, i)
            assert (got.blk[i, :, w:] == -1).all() and (got.rest[i, :, w:] == 0).all()
            assert np.array_equal(got.order[i], p.order_host)
            assert np.array_equal(got.bounds[i], p.bounds_host)
            for field, cap in ((got.budget, budgets), (got.maxr, max_ranges)):
                assert field[i] == (INT32_MAX if cap is None else min(int(cap[i]), INT32_MAX))
        assert (got.blk[n:] == -1).all() and (got.rest[n:] == 0).all()
        assert (got.bounds[n:] == 0).all() and (got.budget[n:] == 0).all()
        assert (got.maxr[n:] == 0).all()
        assert got.valid.tolist() == [True] * n + [False] * (batch - n)
        assert all(getattr(got, f).dtype == np.int32
                   for f in ("blk", "rest", "order", "bounds", "budget", "maxr"))

    # A narrow plan over the lane that held the widest one.
    wide = int(np.argmax([p.blk_tab_host.shape[1] for p in plans]))
    narrow = int(np.argmin([p.blk_tab_host.shape[1] for p in plans]))
    table = bucketing.stack_table(plans, widest, 8)
    table.write_lane(wide, plans[narrow], 9, 4)
    fresh = bucketing.SlotTable(8, R, widest)
    fresh.write_lane(wide, plans[narrow], 9, 4)
    for name in ("blk", "rest", "order", "bounds", "budget", "maxr", "valid"):
        assert np.array_equal(getattr(table, name)[wide], getattr(fresh, name)[wide]), name

    huge = [dataclasses.replace(p, bounds_host=p.bounds_host.copy()) for p in plans[:3]]
    huge[0].bounds_host[0] = 2**31 + 12_345
    huge[2].bounds_host[-1] = 2**40
    with pytest.warns(RuntimeWarning, match="saturating"):
        got = bucketing.stack_table(huge, widest, 4)
    assert got.bounds[0, 0] == got.bounds[2, -1] == INT32_MAX
    assert np.array_equal(got.bounds[1], plans[1].bounds_host)

    negative = [plans[0], dataclasses.replace(plans[1],
                                              bounds_host=plans[1].bounds_host - 2**40)]
    with pytest.raises(ValueError, match="negative"):
        bucketing.stack_table(negative, widest, 2)
    with pytest.raises(ValueError, match="table width"):
        bucketing.stack_table(plans, widest // 2, 8)
    with pytest.raises(ValueError, match="len\\(plans\\)"):
        bucketing.stack_table(plans, widest, n - 1)


def test_slot_table_and_double_buffer_match_reference(index, port_idx, ragged):
    jeng, peng = _engines(index, port_idx, "int32", "int32")
    R = index.n_ranges
    width = 64
    tables = (bucketing.SlotTable(4, R, width), jax_bucketing.SlotTable(4, R, width))
    bufs = (bucketing.DoubleBuffer(4, R, width), jax_bucketing.DoubleBuffer(4, R, width))
    for lane, (qi, bud, mr) in enumerate([(1, 900, INT32_MAX), (9, INT32_MAX, 3),
                                          (4, 2**40, 0)]):
        tables[0].write_lane(lane, peng.plan(ragged[qi]), bud, mr)
        tables[1].write_lane(lane, jeng.plan(ragged[qi]), bud, mr)
        bufs[0].back.write_lane(lane, peng.plan(ragged[qi]), bud, mr)
        bufs[1].back.write_lane(lane, jeng.plan(ragged[qi]), bud, mr)
    tables[0].clear_lane(1)
    tables[1].clear_lane(1)
    for b in bufs:
        b.swap()
        b.grow_width(128)
    names = ("blk", "rest", "order", "bounds", "budget", "maxr", "valid")
    grown = tuple(t.grow_width(128) for t in tables)
    for a, b in ((tables[0], tables[1]), (grown[0], grown[1]),
                 (bufs[0].front, bufs[1].front), (bufs[0].back, bufs[1].back)):
        for name in names:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    got = tables[0].device_arrays("cpu")
    want = tables[1].device_arrays()
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(_np(g), np.asarray(w))
    tables[0].blk[0] = 7  # the snapshot does not alias the staging table
    assert not (_np(got[0])[0] == 7).all()
    wide = dataclasses.replace(peng.plan(ragged[1]),
                               blk_tab_host=np.zeros((R, width + 1), np.int32))
    with pytest.raises(ValueError, match="table width"):
        tables[0].write_lane(0, wide)


# ------------------------------------------------------------ BatchEngine


def _budget_cases(n, seed):
    rng = np.random.default_rng(seed)
    budgets = rng.choice([1, 150, 600, 2_000, INT32_MAX], size=n)
    maxr = rng.choice([0, 1, 2, 3, INT32_MAX], size=n)
    maxr[0] = 0
    return {"unbudgeted": {}, "budgets": dict(budget_postings=budgets),
            "max_ranges": dict(max_ranges=maxr),
            "both": dict(budget_postings=budgets, max_ranges=maxr)}


@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_run_batch_matches_reference_xla(index, port_idx, ragged, impact_dtype,
                                         docs_format):
    """Every BatchResult field, bitwise, under each budget kind."""
    jeng, peng = _engines(index, port_idx, impact_dtype, docs_format)
    jbe = jax_batch_engine.BatchEngine(jeng, jax_bucketing.BucketSpec(max_batch=4))
    pbe = batch_engine.BatchEngine(peng, bucketing.BucketSpec(max_batch=4))
    jplans, pplans = jbe.plan_many(ragged), pbe.plan_many(ragged)
    assert len({pbe.spec.width_bucket(p.blk_tab.shape[1]) for p in pplans}) >= 2
    for label, kw in _budget_cases(len(ragged), seed=len(docs_format)).items():
        _assert_results_equal(pbe.run_batch(pplans, **kw), jbe.run_batch(jplans, **kw),
                              f"{impact_dtype}/{docs_format} {label}")
    # One launch per input-order chunk of max_batch, padded to the chunk's
    # widest bucket; the reference launches each width bucket apart.
    spec, cases = pbe.spec, len(_budget_cases(len(ragged), seed=0))
    chunks = [pplans[lo:lo + 4] for lo in range(0, len(pplans), 4)]
    assert pbe.batches_run == cases * len(chunks) < jbe.batches_run
    assert pbe.compiled_shapes == {
        (spec.batch_bucket(len(c)), max(spec.width_bucket(p.blk_tab_host.shape[1])
                                        for p in c)) for c in chunks}


@pytest.mark.parametrize("impact_dtype,docs_format", CONFIGS)
def test_run_batch_matches_reference_pallas(index, port_idx, ragged, impact_dtype,
                                            docs_format):
    """The reference's Pallas kernels (interpret mode) give the same results."""
    jeng, peng = _engines(index, port_idx, impact_dtype, docs_format, impl="pallas")
    jbe = jax_batch_engine.BatchEngine(jeng, jax_bucketing.BucketSpec(max_batch=4))
    pbe = batch_engine.BatchEngine(peng, bucketing.BucketSpec(max_batch=4))
    plans = ragged[:6] + ragged[-1:]
    for label, kw in _budget_cases(len(plans), seed=3).items():
        _assert_results_equal(pbe.run_batch(pbe.plan_many(plans), **kw),
                              jbe.run_batch(jbe.plan_many(plans), **kw),
                              f"pallas {impact_dtype}/{docs_format} {label}")


@pytest.mark.parametrize("n,max_batch", [(4, 4), (5, 32), (11, 16), (15, 4)])
def test_run_batch_is_one_launch_a_micro_batch(index, port_idx, mixed, n, max_batch,
                                               monkeypatch):
    """Plans spanning four width buckets run as one launch per input-order
    chunk of ``max_batch``, at (batch bucket, widest bucket of the chunk);
    dummy lanes pad a chunk to its batch bucket (5 -> 8, 11 -> 16). Every
    result equals looped ``Engine.traverse`` and the reference's
    ``BatchEngine``, bitwise, under each budget kind."""
    jeng, peng = _engines(index, port_idx, "int8", "packed")
    pbe = batch_engine.BatchEngine(peng, bucketing.BucketSpec(max_batch=max_batch))
    jbe = jax_batch_engine.BatchEngine(jeng, jax_bucketing.BucketSpec(max_batch=max_batch))
    spec = pbe.spec
    pplans, jplans = pbe.plan_many(mixed[:n]), jbe.plan_many(mixed[:n])
    chunks = [pplans[lo:lo + max_batch] for lo in range(0, n, max_batch)]
    assert len({spec.width_bucket(p.blk_tab_host.shape[1]) for p in chunks[0]}) == 4
    want_shapes = [(spec.batch_bucket(len(c)), port_idx.n_ranges,
                    max(spec.width_bucket(p.blk_tab_host.shape[1]) for p in c))
                   for c in chunks]
    shapes = []
    real = batch_engine.traverse_lanes

    def spy(dix, blk_tab, *args, **kw):
        shapes.append(tuple(blk_tab.shape))
        return real(dix, blk_tab, *args, **kw)

    monkeypatch.setattr(batch_engine, "traverse_lanes", spy)
    cases = _budget_cases(n, seed=n)
    for label, kw in cases.items():
        shapes.clear()
        got = pbe.run_batch(pplans, **kw)
        assert shapes == want_shapes, label
        _assert_results_equal(got, jbe.run_batch(jplans, **kw), f"n={n} {label}")
        assert_batch_matches_sequential(peng, pplans, got,
                                        budgets=kw.get("budget_postings"),
                                        max_ranges=kw.get("max_ranges"))
    assert pbe.batches_run == len(cases) * len(chunks)
    assert pbe.compiled_shapes == {(b, w) for b, _, w in want_shapes}


@pytest.mark.parametrize("docs_format", ["int32", "packed"])
def test_batch_matches_sequential_port_engine(port_idx, ragged, docs_format):
    """The port's batches equal its own looped Engine.traverse, bitwise."""
    peng = range_daat.Engine(port_idx, k=10, device="cpu", impact_dtype="int8",
                             docs_format=docs_format)
    pbe = batch_engine.BatchEngine(peng, bucketing.BucketSpec(max_batch=8))
    plans = pbe.plan_many(ragged)
    cases = _budget_cases(len(plans), seed=11)
    assert_batch_matches_sequential(peng, plans, pbe.run_batch(plans))
    kw = cases["both"]
    assert_batch_matches_sequential(peng, plans, pbe.run_batch(plans, **kw),
                                    budgets=kw["budget_postings"],
                                    max_ranges=kw["max_ranges"])


def test_batch_and_whole_query_paths_upload_once(port_idx, ragged, monkeypatch):
    """A chunk is one upload (tables, caps and carries), a whole query too;
    neither uploads the plan's own device tables, which only the anytime
    loop reads."""
    peng = range_daat.Engine(port_idx, k=10, device="cpu", docs_format="packed")
    pbe = batch_engine.BatchEngine(peng, bucketing.BucketSpec(max_batch=4))
    plans = pbe.plan_many(ragged)
    calls = []
    real = range_daat.upload_int32

    def spy(arrays, device):
        calls.append(sum(not isinstance(a, torch.Tensor) for a in arrays))
        return real(arrays, device)

    monkeypatch.setattr(batch_engine, "upload_int32", spy)
    monkeypatch.setattr(range_daat, "upload_int32", spy)
    pbe.run_batch(plans, budget_postings=600)
    assert calls == [7] * pbe.batches_run
    calls.clear()
    peng.traverse(plans[1], budget_postings=600, max_ranges=3)
    assert calls == [7]
    assert not any("_device_tables" in vars(p) for p in plans)
    calls.clear()
    run = range_daat.device_traverse(
        peng.dix, plans[1].blk_tab, plans[1].rest_tab, plans[1].order,
        plans[1].ordered_bounds, s_pad=peng.s_pad, k=peng.k, docs_format="packed")
    assert calls == [4, 3]  # the plan's tables once, then the caps and carry
    assert "_device_tables" in vars(plans[1])
    assert run.ranges_processed == peng.traverse(plans[1]).ranges_processed


def test_batched_traverse_and_helpers_match_reference(index, port_idx, ragged):
    """batched_traverse, exit_reasons and the 2-D topk_docs."""
    jeng, peng = _engines(index, port_idx, "int8", "packed")
    jplans, pplans = [jeng.plan(q) for q in ragged[:5]], [peng.plan(q) for q in ragged[:5]]
    width = 32
    jbp = jax_bucketing.stack_plans(jplans, width, 8)
    pbp = bucketing.stack_plans(pplans, width, 8)
    budgets = np.array([INT32_MAX, 300, INT32_MAX, 1, INT32_MAX, 0, 0, 0])
    maxr = np.array([INT32_MAX, INT32_MAX, 2, INT32_MAX, INT32_MAX, 0, 0, 0])
    kw = dict(s_pad=peng.s_pad, k=peng.k, docs_format="packed")
    want = jax_daat.batched_traverse(
        jeng.dix, jbp.blk_tab, jbp.rest_tab, jbp.order, jbp.ordered_bounds,
        jnp.asarray(budgets, jnp.int32), jnp.asarray(maxr, jnp.int32), **kw)
    got = range_daat.batched_traverse(
        peng.dix, pbp.blk_tab, pbp.rest_tab, pbp.order, pbp.ordered_bounds, budgets,
        maxr, impl="torch", **kw)
    assert range_daat.exit_reasons(got) == jax_daat.exit_reasons(want)
    for name in ("vals", "ids", "postings", "blocks"):
        assert _np(getattr(got.state, name)).tolist() == \
            np.asarray(getattr(want.state, name)).tolist(), name
    for name in ("ranges_processed", "exit_safe", "exit_budget"):
        g, w = _np(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.tolist() == w.tolist(), name
    per_query = peng.topk_docs(got.state)
    ref_per_query = jeng.topk_docs(want.state)
    assert len(per_query) == 8
    for (gi, gv), (wi, wv) in zip(per_query, ref_per_query):
        assert gi.tolist() == wi.tolist() and gv.tolist() == wv.tolist()
    assert range_daat.batched_topk_docs(got.state)[0][0].tolist() == \
        per_query[0][0].tolist()


@pytest.mark.parametrize("quantum", [1, 2, 3])
def test_batched_traverse_resume_matches_reference(index, port_idx, ragged, quantum):
    """Every carry leaf after every dispatch; the chain ends where one
    uninterrupted batched_traverse ends."""
    jeng, peng = _engines(index, port_idx, "int32", "packed")
    plans = ragged[:6]
    jbp = jax_bucketing.stack_plans([jeng.plan(q) for q in plans], 64, 8)
    pbp = bucketing.stack_plans([peng.plan(q) for q in plans], 64, 8)
    budgets = np.array([INT32_MAX, 700, INT32_MAX, 40, INT32_MAX, INT32_MAX, 0, 0])
    maxr = np.array([INT32_MAX, INT32_MAX, 3, INT32_MAX, 5, INT32_MAX, 0, 0])
    kw = dict(s_pad=peng.s_pad, k=peng.k, docs_format="packed")
    jargs = (jeng.dix, jbp.blk_tab, jbp.rest_tab, jbp.order, jbp.ordered_bounds,
             jnp.asarray(budgets, jnp.int32), jnp.asarray(maxr, jnp.int32))
    pargs = (peng.dix, pbp.blk_tab, pbp.rest_tab, pbp.order, pbp.ordered_bounds,
             budgets, maxr)
    jc = jax_daat.batched_init_carry(8, peng.k)
    pc = range_daat.batched_init_carry(8, peng.k)
    # A parked lane rides along inert.
    jc = jc._replace(exit_budget=jc.exit_budget.copy())
    pc = pc._replace(exit_budget=pc.exit_budget.copy())
    jc.exit_budget[5] = pc.exit_budget[5] = True
    n = 0
    R = index.n_ranges
    while not range_daat.carry_done(pc, R).all():
        jc = jax_daat.batched_traverse_resume(*jargs, jc, quantum=quantum, **kw)
        pc = range_daat.batched_traverse_resume(*pargs, pc, quantum=quantum,
                                                impl="torch", **kw)
        n += 1
        ctx = f"quantum {quantum} dispatch {n}"
        for name in ("i", "exit_safe", "exit_budget"):
            g, w = _np(getattr(pc, name)), np.asarray(getattr(jc, name))
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), f"{ctx}: {name}"
        for name in ("vals", "ids", "postings", "blocks"):
            g, w = _np(getattr(pc.state, name)), np.asarray(getattr(jc.state, name))
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), f"{ctx}: {name}"
        assert range_daat.carry_done(pc, R).tolist() == \
            jax_daat.carry_done(jc, R).tolist(), ctx
        assert n <= R + 2, ctx
    assert n >= 2
    whole = range_daat.batched_traverse(*pargs, impl="torch", **kw)
    done = range_daat.carry_result(pc)
    for lane in range(8):
        if lane == 5:  # parked: never ran
            assert int(done.ranges_processed[lane]) == 0
            continue
        assert int(done.ranges_processed[lane]) == int(whole.ranges_processed[lane])
        assert bool(done.exit_safe[lane]) == bool(whole.exit_safe[lane])
        assert bool(done.exit_budget[lane]) == bool(whole.exit_budget[lane])
        for name in ("vals", "ids", "postings", "blocks"):
            assert torch.equal(getattr(done.state, name)[lane],
                               getattr(whole.state, name)[lane]), (lane, name)


def test_single_query_traverse_and_resume_match_reference(index, port_idx, queries):
    """device_traverse and the single-carry loop from a mid-flight carry."""
    jeng, peng = _engines(index, port_idx, "int8", "int32")
    kw = dict(s_pad=peng.s_pad, k=peng.k, prune_blocks=True, docs_format="int32")
    for q in queries[:4]:
        jp, pp = jeng.plan(q), peng.plan(q)
        for budget, maxr in ((INT32_MAX, INT32_MAX), (500, INT32_MAX), (INT32_MAX, 2)):
            want = jax_daat.device_traverse(
                jeng.dix, jp.blk_tab, jp.rest_tab, jp.order, jp.ordered_bounds,
                budget_postings=budget, max_ranges=maxr, **kw)
            got = range_daat.device_traverse(
                peng.dix, pp.blk_tab, pp.rest_tab, pp.order, pp.ordered_bounds,
                budget_postings=budget, max_ranges=maxr, impl="torch", **kw)
            assert (got.ranges_processed, got.exit_safe, got.exit_budget) == (
                int(want.ranges_processed), bool(want.exit_safe), bool(want.exit_budget))
            assert _np(got.state.vals).tolist() == np.asarray(want.state.vals).tolist()
            assert _np(got.state.ids).tolist() == np.asarray(want.state.ids).tolist()
            assert int(got.state.postings) == int(want.state.postings)
            assert int(got.state.blocks) == int(want.state.blocks)


# ----------------------------------------------------------- the traverse wrapper


def _lanes(peng, plans, width, batch, budgets, maxr):
    bp = bucketing.stack_plans(plans, width, batch)
    bud, mr, carry = range_daat.upload_int32(
        (budgets, maxr, range_daat.carry_buffer(range_daat.batched_init_carry(batch, peng.k))),
        "cpu")
    return (peng.dix, bp.blk_tab, bp.rest_tab, bp.order, bp.ordered_bounds, bud, mr,
            carry)


def test_traverse_wrapper_on_cpu_is_the_plain_version(port_idx, ragged):
    peng = range_daat.Engine(port_idx, k=10, device="cpu", docs_format="packed")
    args = _lanes(peng, [peng.plan(q) for q in ragged[:3]], 32, 4,
                  [INT32_MAX, 300, 0, 0], [INT32_MAX, INT32_MAX, 0, 0])
    kw = dict(s_pad=peng.s_pad, k=peng.k, docs_format="packed")
    before = kernel.traverse.launches
    for quantum in (None, 0, 2):
        got = kernel.traverse(*args, quantum=quantum, **kw)
        want = ref.traverse_ref(*args, quantum=quantum, **kw)
        assert got.dtype == torch.int32 and got.shape == (4, ref.carry_width(peng.k))
        assert torch.equal(got, want)
    assert kernel.traverse.launches == before  # CPU calls launch nothing
    # quantum 0 returns the carry unchanged; dummy lanes stop at once.
    assert torch.equal(kernel.traverse(*args, quantum=0, **kw), args[-1])
    out = kernel.traverse(*args, **kw)
    k = peng.k
    assert out[2:, 2 * k + 2:].tolist() == [[0, 0, 1]] * 2


def test_traverse_wrapper_checks(port_idx, ragged):
    peng = range_daat.Engine(port_idx, k=10, device="cpu")
    args = _lanes(peng, [peng.plan(ragged[1])], 32, 2, [INT32_MAX, 0], [INT32_MAX, 0])
    kw = dict(s_pad=peng.s_pad, k=peng.k)
    with pytest.raises(ValueError, match="1 <= k <= s_pad"):
        kernel.traverse(*args, s_pad=peng.s_pad, k=0)
    with pytest.raises(ValueError, match="quantum"):
        kernel.traverse(*args, quantum=-1, **kw)
    with pytest.raises(ValueError, match="carry has shape"):
        kernel.traverse(*args[:-1], args[-1][:, :-1].contiguous(), **kw)
    with pytest.raises(ValueError, match="order has shape"):
        kernel.traverse(*args[:3], args[3][:, :-1].contiguous(), *args[4:], **kw)
    with pytest.raises(TypeError, match="budget must be torch.int32"):
        kernel.traverse(*args[:5], args[5].long(), *args[6:], **kw)
    with pytest.raises(ValueError, match="blk_tab must have 3 dims"):
        kernel.traverse(args[0], args[1][0], *args[2:], **kw)
    with pytest.raises(ValueError, match="needs dix.pack_words"):
        kernel.traverse(*args, docs_format="packed", **kw)
    with pytest.raises(ValueError, match="kernel"):
        kernel.acc_placement(9_984, "scatter")
    assert [kernel.acc_placement(s, "traverse") for s in (9_984, 42_624, 42_625)] == [
        "shared", "shared", "global"]
    assert kernel.acc_placement(42_668) == "shared"
    assert kernel.acc_placement(9_984, "traverse", k=2048) == "shared"


# --------------------------------------------------------------- request loop


class _Clock:
    """Deterministic: every reading advances 1.5 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.0015
        return self.t


def _recording(server_cls):
    class Recording(server_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sent = []

        def _run_batch(self, plans, budgets):
            self.sent.append(np.asarray(budgets).tolist())
            return super()._run_batch(plans, budgets)

    return Recording


@pytest.mark.parametrize("docs_format", ["packed", "int32"])
def test_microbatch_server_matches_reference(index, port_idx, ragged, queries, docs_format):
    """Same clock: the same budgets each batch, the same results and rids;
    int8 impacts with packed or int32 docids."""
    jeng, peng = _engines(index, port_idx, "int8", docs_format)
    stream = list(queries) + ragged[-2:] + list(queries[:5])
    servers = []
    for bmod, bkt, mb, eng, policy in (
        (batch_engine, bucketing, microbatch, peng, Reactive),
        (jax_batch_engine, jax_bucketing, jax_microbatch, jeng, JaxReactive),
    ):
        budgeter = mb.SlaBudgeter(sla_ms=4.0, policy=policy(alpha=1.0, beta=1.5, q=0.01),
                                  rate=50.0)
        server = _recording(mb.MicroBatchServer)(
            bmod.BatchEngine(eng, bkt.BucketSpec(max_batch=4)), budgeter, max_batch=4,
            clock=_Clock())
        served = server.replay(stream, batch_size=3)
        servers.append((server, served))
    (ps, pserved), (js, jserved) = servers
    assert ps.sent == js.sent and len(ps.sent) >= 6
    assert len(set(map(tuple, ps.sent))) > 1  # the budgets moved
    assert [s.rid for s in pserved] == [s.rid for s in jserved] == list(range(len(stream)))
    assert [s.latency_ms for s in pserved] == [s.latency_ms for s in jserved]
    assert [s.batch_size for s in pserved] == [s.batch_size for s in jserved]
    _assert_results_equal([s.result for s in pserved], [s.result for s in jserved],
                          "microbatch")
    assert [microbatch.result_exit_reason(s.result) for s in pserved] == \
        [jax_microbatch.result_exit_reason(s.result) for s in jserved]
    assert ps.budgeter.policy.alpha == js.budgeter.policy.alpha
    assert ps.budgeter.rate == js.budgeter.rate
    assert ps.pending == js.pending == 0


def test_sla_budgeter_reactive_feedback_shrinks_after_a_miss():
    tight = microbatch.SlaBudgeter(sla_ms=10.0, rate=100.0)
    before = int(tight.budgets(1)[0])
    tight.observe(elapsed_ms=50.0, total_postings=500, n=1)  # SLA miss
    after = int(tight.budgets(1)[0])
    assert tight.policy.alpha > 1.0 and after < before
    for _ in range(50):  # the floor still admits one block
        tight.observe(elapsed_ms=1e5, total_postings=1, n=1)
    assert int(tight.budgets(1)[0]) >= ref.BLOCK
    assert microbatch.SlaBudgeter(sla_ms=float("inf")).budgets(2).tolist() == [
        INT32_MAX] * 2


def test_serve_cli_batch_mode_on_cpu(port_idx, queries, monkeypatch, capsys):
    monkeypatch.setattr(serve, "build_preset", lambda *a, **k: (None, port_idx))

    class Log:
        terms = np.stack([np.pad(q[q >= 0], (0, 8 - (q >= 0).sum()),
                                 constant_values=-1)[:8] for q in queries])
        n_queries = len(queries)

    monkeypatch.setattr(serve, "make_query_log", lambda *a, **k: Log)
    serve.main(["--device", "cpu", "--mode", "batch", "--batch-size", "4",
                "--queries", str(len(queries))])
    out = capsys.readouterr().out
    assert "mode=batch" in out and "q/s" in out and "RBO" in out
    assert "dispatches, shapes" in out
