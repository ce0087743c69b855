"""The port's range-sharded serving against the JAX package's, on the CPU.

A small seeded index is built once with the JAX package and carried into
the port with ``index_from_arrays``. The port's index sharding
(``shard_device_index``, ``balance_range_shards``), its ``ShardedEngine``
and ``ShardedBatchEngine`` (whose launch is the ``traverse`` kernel's
plain version over stacked shards on the CPU), ``ShardedSlaBudgeter`` and
``MicroBatchServer`` over the sharded engine are held against the
reference's single-device (vmap) path: the path is integer, so every
comparison is bitwise. ``tests/test_torch_cuda.py`` holds the stacked-shard
``traverse`` kernel against its plain version on the card.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustered_index as jax_ci
from repro.core import range_daat as jax_daat
from repro.core.anytime import Reactive as JaxReactive
from repro.data.synth import make_corpus, make_query_log
from repro.serving import bucketing as jax_bucketing
from repro.serving import microbatch as jax_microbatch
from repro.serving import sharded as jax_sharded
from repro_torch.core import clustered_index, range_daat
from repro_torch.core.anytime import Reactive
from repro_torch.kernels.range_scorer import kernel, ref
from repro_torch.launch import serve
from repro_torch.serving import bucketing, microbatch, sharded

CONFIGS = [(dt, fmt) for dt in ("int32", "int8") for fmt in ("int32", "packed")]
INT32_MAX = 2**31 - 1
K = 5


def _cross(index):
    """The reference's index as the port's, array for array."""
    arrays = {n: getattr(index, n) for n in clustered_index.INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    return clustered_index.index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale)


@pytest.fixture(scope="module")
def setup():
    """A 6-range index (so S = 4 pads short shards) and a ragged query mix:
    plain queries, a 1-term stub and fat union queries in a wider bucket."""
    corpus = make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=7)
    jidx = jax_ci.build_index(corpus, n_ranges=6, strategy="clustered")
    log = make_query_log(corpus, n_queries=10, seed=8)
    plain = [log.terms[i] for i in range(log.n_queries)]
    stripped = [q[q >= 0] for q in plain]
    fat = np.unique(np.concatenate(stripped + [np.arange(80, dtype=np.int32)]))
    return jidx, _cross(jidx), plain, [stripped[0][:1]] + stripped[:5] + [fat, fat[::3]]


def _engines(setup, impact_dtype, docs_format, n_shards, impl="xla"):
    jidx, pidx = setup[:2]
    je = jax_daat.Engine(jidx, k=K, impl=impl, interpret=True, impact_dtype=impact_dtype,
                         docs_format=docs_format)
    pe = range_daat.Engine(pidx, k=K, device="cpu", impact_dtype=impact_dtype,
                           docs_format=docs_format)
    return (jax_sharded.ShardedEngine(je, n_shards, use_mesh=False),
            sharded.ShardedEngine(pe, n_shards))


def _assert_same(got, want, ctx):
    """Two ShardedResult lists, every field and property, bitwise."""
    assert len(got) == len(want), ctx
    for i, (g, w) in enumerate(zip(got, want)):
        for name in w._fields:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.tolist() == b.tolist(), (
                    f"{ctx} query {i}: {name} {a} != {b}")
            else:
                assert type(a) is type(b) and a == b, f"{ctx} query {i}: {name} {a} != {b}"
        assert (g.postings, g.blocks, g.exit_budget) == (w.postings, w.blocks,
                                                         w.exit_budget), ctx
        assert microbatch.result_exit_reason(g) == jax_microbatch.result_exit_reason(w)


# ------------------------------------------------------------ index sharding


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_device_index_matches_reference(setup, n_shards):
    jidx, pidx = setup[:2]
    got = clustered_index.shard_device_index(pidx, n_shards)
    want = jax_ci.shard_device_index(jidx, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), (n_shards, f.name)
            else:
                assert a == b, (n_shards, f.name)
        assert g.n_ranges == w.n_ranges
    assert clustered_index.shard_cuts(got).tolist() == jax_ci.shard_cuts(want).tolist()
    assert np.array_equal(clustered_index.range_postings_mass(pidx),
                          jax_ci.range_postings_mass(jidx))
    # Explicit cuts, as the reshard planner passes them, and their checks.
    cuts = np.array([0, 1, 5, 6])
    for g, w in zip(clustered_index.shard_device_index(pidx, cuts=cuts),
                    jax_ci.shard_device_index(jidx, cuts=cuts)):
        assert (g.range_lo, g.range_hi, g.doc_base) == (w.range_lo, w.range_hi, w.doc_base)
        assert np.array_equal(g.docs, w.docs) and np.array_equal(g.blk_map, w.blk_map)
    for kw in (dict(cuts=[0, 3, 3, 6]), dict(cuts=[1, 6]), dict(n_shards=2, cuts=cuts),
               dict()):
        for fn, idx in ((clustered_index.shard_device_index, pidx),
                        (jax_ci.shard_device_index, jidx)):
            with pytest.raises(ValueError):
                fn(idx, **kw)


def test_balance_range_shards_matches_reference():
    rng = np.random.default_rng(5)
    masses = [np.full(8, 10), np.array([100, 1, 1, 1, 1, 1, 1, 100]),
              rng.integers(0, 1_000, size=13), np.array([0, 0, 5, 0]),
              rng.integers(1, 10**9, size=32)]
    for mass in masses:
        for s in range(1, len(mass) + 1):
            got = clustered_index.balance_range_shards(mass, s)
            want = jax_ci.balance_range_shards(mass, s)
            assert got.dtype == want.dtype and got.tolist() == want.tolist(), (mass, s)
        for bad in (0, len(mass) + 1):
            for fn in (clustered_index.balance_range_shards, jax_ci.balance_range_shards):
                with pytest.raises(ValueError):
                    fn(mass, bad)


# --------------------------------------------------------------- the engines


def _budget_forms(S, seed):
    rng = np.random.default_rng(seed)
    down = np.zeros(S, bool)
    down[seed % S] = True
    return {
        "unbudgeted": {},
        "scalar": dict(budget_postings=700),
        "zero": dict(budget_postings=0),
        "per-shard": dict(budget_postings=rng.choice([0, 150, 900, INT32_MAX], size=S)),
        "range-capped": dict(max_ranges=2),
        "per-shard ranges": dict(max_ranges=rng.choice([0, 1, INT32_MAX], size=S)),
        "down": dict(down_mask=down, budget_postings=1_200),
    }


@pytest.mark.parametrize("impact_dtype,docs_format,n_shards",
                         [(dt, fmt, 2 + 2 * (i % 3 != 0)) for i, (dt, fmt) in
                          enumerate(CONFIGS)])
def test_sharded_engine_matches_reference(setup, impact_dtype, docs_format, n_shards):
    """ShardedEngine.traverse: every ShardedResult field under every budget
    form, both safe_stop settings, and the raw per-shard outputs of the
    launch (flags and ranges before any folding)."""
    jse, pse = _engines(setup, impact_dtype, docs_format, n_shards)
    assert (pse.r_loc.tolist(), pse.r_max, pse.mass.tolist(), pse.cuts.tolist()) == (
        jse.r_loc.tolist(), jse.r_max, jse.mass.tolist(), jse.cuts.tolist())
    for name in ("docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts",
                 "range_sizes", "pack_words", "pack_dir", "pack_first"):
        g, w = getattr(pse.dix, name), getattr(jse.dix, name)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        if name == "pack_words":
            w = w.view(np.int32)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name
    queries = setup[2][:6]
    for qi, q in enumerate(queries[:2]):
        jp, pp = jse.plan(q), pse.plan(q)
        tables = pse.shard_plan(pp)
        for g, w in zip(tables, jse.shard_plan(jp)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(pse.query_shard_mass(pp), jse.query_shard_mass(jp))
        for fi, (label, kw) in enumerate(_budget_forms(n_shards, qi).items()):
            for safe_stop in (True, False)[(qi + fi) % 2:][:1 + (fi == 0)]:
                _assert_same([pse.traverse(pp, safe_stop=safe_stop, **kw)],
                             [jse.traverse(jp, safe_stop=safe_stop, **kw)],
                             f"{impact_dtype}/{docs_format} S={n_shards} query {qi} "
                             f"{label} safe_stop={safe_stop}")
    # The raw launch outputs of a batch, padding slots included.
    blk, rest, order, bounds = (np.stack(t) for t in zip(
        *[pse.shard_plan(pse.plan(q), 32) for q in queries]))
    rng = np.random.default_rng(n_shards)
    budgets = rng.choice([0, 40, 600, INT32_MAX], size=(len(queries), n_shards))
    maxr = rng.choice([0, 1, 2, INT32_MAX], size=(len(queries), n_shards))
    for safe_stop in (True, False):
        got = sharded.split_outputs(pse.dispatch(blk, rest, order, bounds, budgets, maxr,
                                                 safe_stop=safe_stop), K, n_shards)
        want = jse.dispatch(blk, rest, order, bounds, budgets, maxr, safe_stop=safe_stop)
        for name, g, w in zip(("vals", "ids", "postings", "blocks", "ranges", "exit_safe",
                               "exit_budget"), got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.tolist() == w.tolist(), (name, safe_stop)


def test_sharded_engine_matches_reference_pallas(setup):
    """The reference's Pallas kernels (interpret mode) give the same results."""
    jse, pse = _engines(setup, "int8", "packed", 2, impl="pallas")
    for qi, q in enumerate(setup[2][:3]):
        for label, kw in list(_budget_forms(2, qi).items())[:4]:
            _assert_same([pse.traverse(pse.plan(q), **kw)],
                         [jse.traverse(jse.plan(q), **kw)], f"pallas query {qi} {label}")


@pytest.mark.parametrize("impact_dtype,docs_format,n_shards",
                         [("int32", "packed", 4), ("int8", "int32", 2)])
def test_sharded_batch_engine_matches_reference(setup, impact_dtype, docs_format,
                                                n_shards):
    """run_batch over a ragged mix (two width buckets, ragged chunks) under
    every budget form: None, scalar, [n], [n, S], range caps, down_mask."""
    jse, pse = _engines(setup, impact_dtype, docs_format, n_shards)
    jbe = jax_sharded.ShardedBatchEngine(jse, jax_bucketing.BucketSpec(max_batch=4))
    pbe = sharded.ShardedBatchEngine(pse, bucketing.BucketSpec(max_batch=4))
    queries = setup[3]
    jplans, pplans = jbe.plan_many(queries), pbe.plan_many(queries)
    n = len(queries)
    assert len({pbe.spec.width_bucket(p.blk_tab_host.shape[1]) for p in pplans}) >= 2
    rng = np.random.default_rng(n_shards)
    down = np.zeros(n_shards, bool)
    down[-1] = True
    forms = {
        "none": {}, "scalar": dict(budget_postings=500),
        "[n]": dict(budget_postings=rng.choice([0, 60, 900, INT32_MAX], size=n)),
        "[n, S]": dict(budget_postings=rng.choice([0, 60, 900, INT32_MAX],
                                                  size=(n, n_shards))),
        "ranges": dict(max_ranges=rng.choice([0, 1, 3, INT32_MAX], size=n)),
        "down": dict(down_mask=down, budget_postings=800),
    }
    for label, kw in forms.items():
        _assert_same(pbe.run_batch(pplans, **kw), jbe.run_batch(jplans, **kw),
                     f"{impact_dtype}/{docs_format} S={n_shards} {label}")
    assert pbe.compiled_shapes == jbe.compiled_shapes
    assert pbe.batches_run == jbe.batches_run
    assert pbe.run_batch([]) == jbe.run_batch([]) == []
    with pytest.raises(ValueError, match="budget shape"):
        pbe.run_batch(pplans, budget_postings=np.zeros((n, n_shards + 1)))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_matches_port_engine(setup, n_shards):
    """Merged shard heaps == the port's own Engine.traverse on the top-k:
    bitwise when both run exhaustively (no safe stop, no block pruning),
    and up to ties at the k-th score under safe stop or pruning (a block
    whose bound only ties θ is skipped, and each shard prunes against its
    own, lower θ; the reference behaves the same)."""
    _, pse = _engines(setup, "int8", "packed", n_shards)
    pbe = sharded.ShardedBatchEngine(pse, bucketing.BucketSpec(max_batch=8))
    eng = pse.engine
    plans = pbe.plan_many(setup[3])
    for safe_stop, prune in ((False, False), (False, True), (True, True)):
        kw = dict(safe_stop=safe_stop, prune_blocks=prune)
        for plan, res in zip(plans, pbe.run_batch(plans, **kw)):
            one = eng.traverse(plan, **kw)
            ids, vals = eng.topk_docs(one.state)
            assert res.scores.tolist() == vals.tolist()
            kth = vals[-1] if len(vals) else 0
            assert res.doc_ids[res.scores > kth].tolist() == ids[vals > kth].tolist()
            if not prune:
                assert res.doc_ids.tolist() == ids.tolist()
                assert res.exact and res.fidelity_bound == 0
                assert res.postings == int(one.state.postings)
                assert res.blocks == int(one.state.blocks)
            assert all(r in ("safe", "exhausted") for r in res.shard_exit_reasons)


def test_sharded_engine_budget_splits_and_checks(setup):
    jse, pse = _engines(setup, "int32", "int32", 3)
    for b in ([9000, INT32_MAX, 0, 1, 2**40], [128]):
        assert np.array_equal(pse.split_postings_budget(b), jse.split_postings_budget(b))
        assert np.array_equal(pse.split_range_budget(b), jse.split_range_budget(b))
    bud = np.array([[5, 0, 7], [1, 2, 3]], np.int32)
    for mask in (None, [False] * 3, [True, False, True]):
        for g, w in zip(sharded.apply_down_mask(bud, bud + 1, mask),
                        jax_sharded.apply_down_mask(bud, bud + 1, mask)):
            assert np.array_equal(g, w)
    for fn in (sharded.apply_down_mask, jax_sharded.apply_down_mask):
        with pytest.raises(ValueError, match="down_mask shape"):
            fn(bud, bud, [True])
    for args in ((True, False, 3, 3), (True, True, 1, 3), (False, True, 2, 3),
                 (False, False, 0, 3)):
        assert sharded.shard_exit_reason(*args) == jax_sharded.shard_exit_reason(*args)
    with pytest.raises(ValueError, match="per-shard budget"):
        pse.traverse(pse.plan(setup[2][0]), budget_postings=[1, 2])
    with pytest.raises(ValueError, match="process group"):  # no mesh here
        sharded.ShardedEngine(pse.engine, 2, use_mesh=True)
    with pytest.raises(ValueError, match="preloaded shard count"):
        sharded.ShardedEngine(pse.engine, 2, shards=pse.shards)
    again = sharded.ShardedEngine(pse.engine, 3, use_mesh=False, shards=pse.shards)
    assert again.shards is pse.shards


# ----------------------------------------------------- the stacked launch


def test_stacked_traverse_wrapper_on_cpu(setup):
    """The traverse wrapper over stacked shards is its plain version on the
    CPU, S = 1 stacked equals the unstacked index, and the checks hold."""
    _, pse = _engines(setup, "int8", "packed", 2)
    one = sharded.ShardedEngine(pse.engine, 1)
    plans = [pse.plan(q) for q in setup[2][:3]]
    kw = dict(s_pad=pse.s_pad, k=K, docs_format="packed")

    def lanes(se, n_lanes_per_q):
        tabs = [np.stack(t) for t in zip(*[se.shard_plan(p, 32) for p in plans])]
        n = len(plans) * n_lanes_per_q
        return range_daat.upload_int32(
            [t.reshape(n, *t.shape[2:]) for t in tabs]
            + [np.full(n, INT32_MAX), np.full(n, INT32_MAX),
               range_daat.carry_buffer(range_daat.batched_init_carry(n, K))], "cpu")

    args = lanes(pse, 2)
    before = kernel.traverse.launches
    got = kernel.traverse(pse.dix, *args, **kw)
    assert torch.equal(got, ref.traverse_ref(pse.dix, *args, **kw))
    assert kernel.traverse.launches == before
    # S = 1: the stacked [1, W] index and the engine's own give one carry.
    args1 = lanes(one, 1)
    stacked = kernel.traverse(one.dix, *args1, **kw)
    flat = kernel.traverse(pse.engine.dix, *args1, **kw)
    assert torch.equal(stacked, flat)
    # A shard row is the engine's index restricted to its ranges.
    row = ref.shard_row(pse.dix, 1)
    assert row.range_starts.tolist() == pse.dix.range_starts[1].tolist()
    with pytest.raises(ValueError, match="do not divide"):
        kernel.traverse(pse.dix, *[a[:3] for a in args], **kw)
    with pytest.raises(ValueError, match="dix.range_starts has shape"):
        kernel.traverse(pse.dix._replace(range_starts=pse.dix.range_starts[:, :-1]), *args,
                        **kw)
    with pytest.raises(ValueError, match="dix.impacts must have 2 dims"):
        kernel.traverse(pse.dix._replace(impacts=pse.dix.impacts[0]), *args, **kw)


# ------------------------------------------------------- budgeter and server


def test_sharded_sla_budgeter_matches_reference(setup):
    """budgets (rate and boundsum), observe_sharded and observe: the same
    int32 budgets and float64 state after the same feedback."""
    jse, pse = _engines(setup, "int32", "int32", 4)
    jplans = [jse.plan(q) for q in setup[3]]
    pplans = [pse.plan(q) for q in setup[3]]
    for mode in ("rate", "boundsum"):
        down = np.array([False, True, False, False])
        pair = []
        for mb, eng, pol in ((microbatch, pse, Reactive), (jax_microbatch, jse, JaxReactive)):
            pair.append(mb.ShardedSlaBudgeter(
                sla_ms=3.0, policy=pol(alpha=1.0, beta=1.5, q=0.01), rate=70.0, n_shards=4,
                mode=mode, shard_mass=eng.query_shard_mass if mode == "boundsum" else None,
                down_mask=(lambda: down) if mode == "rate" else None))
        pb, jb = pair
        for step in range(8):
            assert np.array_equal(pb.budgets(len(pplans), plans=pplans),
                                  jb.budgets(len(jplans), plans=jplans)), (mode, step)
            assert pb.budgets(2).tolist() == jb.budgets(2).tolist()
            post = np.array([900 * step, 40, 3_000, 0]) + step
            for b in (pb, jb):
                b.observe_sharded(1.0 + 0.7 * step, post, n=3, latencies_ms=[2.0, 5.5])
                b.observe(0.5 + step, 2_000 * step, n=2, latencies_ms=[1.0 * step])
                b.observe_sharded(2.0, post, n=1, active_mask=~down)
                b.observe(3.0, 100, n=1)
            assert pb.rates.tolist() == jb.rates.tolist(), (mode, step)
            assert pb.policy.alpha == jb.policy.alpha
    for mb in (microbatch, jax_microbatch):
        with pytest.raises(ValueError, match="mode"):
            mb.ShardedSlaBudgeter(sla_ms=1.0, n_shards=2, mode="mass")
        with pytest.raises(ValueError, match="shard_mass"):
            mb.ShardedSlaBudgeter(sla_ms=1.0, n_shards=2, mode="boundsum")
        whole_fleet_down = mb.ShardedSlaBudgeter(sla_ms=1.0, n_shards=2,
                                                 down_mask=lambda: [True, True])
        whole_fleet_down.observe(5.0, 100, n=1)
        assert whole_fleet_down.rates.tolist() == [100.0, 100.0]
    unbounded = microbatch.ShardedSlaBudgeter(sla_ms=float("inf"), n_shards=3)
    assert unbounded.budgets(1).tolist() == [[INT32_MAX] * 3]


class _Clock:
    """Deterministic: every reading advances 1.5 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.0015
        return self.t


def test_microbatch_server_over_sharded_engine_matches_reference(setup):
    """Same clock: the same [n, S] budgets each batch, the same results,
    rids and latencies, and the same per-shard rates (``_observe``'s
    sharded branch)."""
    jse, pse = _engines(setup, "int8", "packed", 2)
    stream = setup[2] + setup[3][-2:] + setup[2][:3]
    runs = []
    for mb, se_mod, bkt, se, pol in ((microbatch, sharded, bucketing, pse, Reactive),
                                     (jax_microbatch, jax_sharded, jax_bucketing, jse,
                                      JaxReactive)):
        sent = []

        class Recording(mb.MicroBatchServer):
            def _run_batch(self, plans, budgets):
                sent.append(np.asarray(budgets).tolist())
                return super()._run_batch(plans, budgets)

        budgeter = mb.ShardedSlaBudgeter(sla_ms=4.0, policy=pol(alpha=1.0, beta=1.5, q=0.01),
                                         rate=50.0, n_shards=2, mode="boundsum",
                                         shard_mass=se.query_shard_mass)
        server = Recording(se_mod.ShardedBatchEngine(se, bkt.BucketSpec(max_batch=4)),
                           budgeter, max_batch=4, clock=_Clock())
        runs.append((server, server.replay(stream, batch_size=3), sent))
    (ps, pserved, psent), (js, jserved, jsent) = runs
    assert psent == jsent and len(psent) >= 5 and len({str(b) for b in psent}) > 1
    assert [s.rid for s in pserved] == [s.rid for s in jserved] == list(range(len(stream)))
    assert [s.latency_ms for s in pserved] == [s.latency_ms for s in jserved]
    assert [s.batch_size for s in pserved] == [s.batch_size for s in jserved]
    _assert_same([s.result for s in pserved], [s.result for s in jserved], "server")
    assert ps.budgeter.rates.tolist() == js.budgeter.rates.tolist()
    assert ps.budgeter.policy.alpha == js.budgeter.policy.alpha
    assert not np.all(ps.budgeter.rates == 50.0)


def test_serve_cli_sharded_mode_on_cpu(setup, monkeypatch, capsys):
    monkeypatch.setattr(serve, "build_preset", lambda *a, **k: (None, setup[1]))
    queries = setup[2][:6]

    class Log:
        terms = np.stack([np.pad(q[q >= 0], (0, 8 - (q >= 0).sum()),
                                 constant_values=-1)[:8] for q in queries])
        n_queries = len(queries)

    monkeypatch.setattr(serve, "make_query_log", lambda *a, **k: Log)
    serve.main(["--device", "cpu", "--mode", "sharded", "--shards", "4",
                "--batch-size", "4", "--queries", str(len(queries)), "--k", str(K)])
    out = capsys.readouterr().out
    assert "mode=sharded" in out and "sharded: 4 range shards on cpu" in out
    assert "q/s" in out and "RBO" in out and "dispatches, shapes" in out
