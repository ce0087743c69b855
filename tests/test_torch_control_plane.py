"""The port's control plane against the reference's, on the CPU.

Follows the reference's ``tests/test_control_plane.py`` case for case
(but for its two mesh subprocess cases, which wait for the mesh paths):
the health ledger, ``restack_shards`` (array for array against a fresh
``shard_device_index(cuts=...)``, then the packed stream a
``ShardedEngine`` stacks from it), the reshard planner, the
``ControlPlane``'s serving, degraded failover, deferred and live
reshards (also from a shard artifact), BoundSum budgets and the replica
group's fallback. Each case runs the same steps through both packages'
planes over one index (built by the reference, carried over with
``index_from_arrays``) and holds every integer observable equal:
results, per-shard counters, exit reasons, ``fidelity_bound``,
``exact``, cuts, ledger state and ``stats()``, the budgeters' rates and
alpha under fake clocks of one step.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

from repro import index_io as ref_io
from repro.control import ControlPlane as RefPlane
from repro.control import HealthLedger as RefLedger
from repro.control import ReplicaGroupEngine as RefReplica
from repro.control import ReshardPlanner as RefPlanner
from repro.core import clustered_index as ref_ci
from repro.core import range_daat as ref_daat
from repro.core.reorder import Arrangement as RefArrangement
from repro.data.synth import Corpus as RefCorpus
from repro.data.synth import make_corpus, make_query_log
from repro.obs import FakeClock as RefFakeClock
from repro.serving import BucketSpec as RefSpec
from repro.serving import ShardedBatchEngine as RefSBE
from repro.serving import ShardedEngine as RefSE
from repro.serving import ShardedSlaBudgeter as RefBudgeter
from repro_torch import index_io
from repro_torch.control import (
    ControlPlane,
    HealthLedger,
    ReplicaGroupEngine,
    ReshardPlanner,
)
from repro_torch.core import clustered_index
from repro_torch.core.range_daat import Engine
from repro_torch.obs import FakeClock
from repro_torch.serving import (
    BucketSpec,
    ShardedBatchEngine,
    ShardedEngine,
    ShardedSlaBudgeter,
)

INT32_MAX = 2**31 - 1
BLOCK = clustered_index.BLOCK
SHARD_FIELDS = ("docs", "impacts", "blk_start", "blk_len", "blk_maxdoc", "blk_maximp",
                "blk_map", "range_starts", "range_sizes", "bounds_dense")
SHARD_META = ("shard_id", "range_lo", "range_hi", "doc_base", "n_docs", "postings")


def _cross(index):
    """The reference's index as the port's, array for array."""
    arrays = {n: getattr(index, n) for n in clustered_index.INDEX_ARRAYS
              if n not in ("doc_order", "range_ends")}
    arrays["doc_order"] = index.arrangement.doc_order
    arrays["range_ends"] = index.arrangement.range_ends
    out = clustered_index.index_from_arrays(
        arrays, n_docs=index.n_docs, n_terms=index.n_terms,
        strategy=index.arrangement.strategy, quant_bits=index.quantizer.bits,
        quant_scale=index.quantizer.scale)
    assert out.fingerprint() == index.fingerprint()
    return out


class Pair:
    """One index, both packages' engines over it, and a query log."""

    def __init__(self, ref_idx, k, queries):
        self.ref_idx = ref_idx
        self.idx = _cross(ref_idx)
        self.ref_eng = ref_daat.Engine(ref_idx, k=k)
        self.eng = Engine(self.idx, k=k, device="cpu")
        self.queries = queries

    def planes(self, n_shards, **kw):
        """(port plane, reference plane) with the same arguments (``spec``
        given as max_batch), each on a fake clock of the same step, so the
        budgeters learn the same rates and alpha."""
        mb = kw.pop("max_batch", 4)
        return (ControlPlane(self.eng, n_shards=n_shards, spec=BucketSpec(max_batch=mb),
                             use_mesh=False, clock=FakeClock(dt=0.001), **kw),
                RefPlane(self.ref_eng, n_shards=n_shards, spec=RefSpec(max_batch=mb),
                         use_mesh=False, clock=RefFakeClock(dt=0.001), **kw))


@functools.lru_cache(maxsize=None)
def _small_setup(seed: int, n_ranges: int, k: int = 5, n_queries: int = 10) -> Pair:
    corpus = make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=seed)
    idx = ref_ci.build_index(corpus, n_ranges=n_ranges, strategy="clustered")
    log = make_query_log(corpus, n_queries=n_queries, seed=seed + 1)
    return Pair(idx, k, [log.terms[i] for i in range(log.n_queries)])


@functools.lru_cache(maxsize=None)
def _planted_setup(seed: int = 0, n_topics: int = 4, ranges_per_topic: int = 4,
                   docs_per_range: int = 100, terms_per_topic: int = 40,
                   doc_len: int = 20) -> Pair:
    """The reference's fully planted topical index: topic t owns terms
    [t*T, (t+1)*T) and a contiguous band of ranges."""
    rng = np.random.default_rng(seed)
    docs_per_topic = ranges_per_topic * docs_per_range
    n_docs = n_topics * docs_per_topic
    doc_terms, doc_tfs, ptr = [], [], [0]
    for d in range(n_docs):
        topic = d // docs_per_topic
        vocab = np.arange(topic * terms_per_topic, (topic + 1) * terms_per_topic)
        doc_terms.append(np.sort(rng.choice(vocab, size=doc_len, replace=False)))
        doc_tfs.append(rng.integers(1, 5, size=doc_len))
        ptr.append(ptr[-1] + doc_len)
    corpus = RefCorpus(
        n_docs=n_docs, n_terms=n_topics * terms_per_topic,
        doc_ptr=np.asarray(ptr, np.int64),
        doc_terms=np.concatenate(doc_terms).astype(np.int32),
        doc_tfs=np.concatenate(doc_tfs).astype(np.int32),
        doc_topic=(np.arange(n_docs) // docs_per_topic).astype(np.int32),
        n_topics=n_topics,
    )
    n_ranges = n_topics * ranges_per_topic
    arrangement = RefArrangement(
        doc_order=np.arange(n_docs, dtype=np.int64),
        range_ends=(np.arange(1, n_ranges + 1) * docs_per_range).astype(np.int64),
        strategy="clustered",
    )
    return Pair(ref_ci.build_index(corpus, arrangement=arrangement), 10, [])


def _same_result(g, w, ctx=""):
    """Two ShardedResults, every field, bitwise."""
    for name in w._fields:
        a, b = getattr(g, name), getattr(w, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tolist() == b.tolist(), f"{ctx}: {name}"
        else:
            assert type(a) is type(b) and a == b, f"{ctx}: {name} {a} != {b}"


def _same_served(got, want, ctx=""):
    """Two served lists (ServedQuery), in rid order, bitwise but latency."""
    got, want = sorted(got, key=lambda s: s.rid), sorted(want, key=lambda s: s.rid)
    assert [(s.rid, s.batch_size) for s in got] == [(s.rid, s.batch_size) for s in want]
    for g, w in zip(got, want):
        _same_result(g.result, w.result, f"{ctx} rid {w.rid}")


def _same_state(plane, ref, ctx=""):
    """Cuts, ledger, planner and the JSON-able snapshot, equal."""
    assert plane.cuts.tolist() == ref.cuts.tolist(), ctx
    assert plane.health._up.tolist() == ref.health._up.tolist(), ctx
    assert [(e.seq, e.kind, e.shard, e.replica) for e in plane.health.events] == [
        (e.seq, e.kind, e.shard, e.replica) for e in ref.health.events], ctx
    assert plane.planner.load.tolist() == ref.planner.load.tolist(), ctx
    assert plane.budgeter.rates.tolist() == ref.budgeter.rates.tolist(), ctx
    assert plane.stats() == ref.stats(), ctx


def _same_shard(g, w, ctx=""):
    for name in SHARD_META:
        assert getattr(g, name) == getattr(w, name), f"{ctx}: {name}"
    for name in SHARD_FIELDS:
        a, b = getattr(g, name), getattr(w, name)
        assert a.dtype == b.dtype, f"{ctx}: {name} {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {name}")


# ----------------------------------------------------------- health ledger


def test_health_ledger_masks_and_events():
    for cls in (HealthLedger, RefLedger):
        led = cls(n_shards=3, n_replicas=2)
        assert led.all_up and led.n_healthy_replicas() == 2
        led.mark_down(1, replica=0)
        assert not led.shard_down_mask()[1]
        assert led.replica_healthy_mask().tolist() == [False, True]
        led.mark_down(1, replica=1)
        assert led.shard_down_mask().tolist() == [False, True, False]
        snap = led.snapshot()
        led.mark_up(1)
        assert led.all_up
        assert [e.kind for e in led.events] == ["down", "down", "up"]
        led.reset()
        assert led.all_up
        with pytest.raises(ValueError):
            led.mark_down(3)
        with pytest.raises(ValueError):
            led.mark_down(0, replica=2)
        with pytest.raises(ValueError):
            cls(n_shards=0)
        if cls is HealthLedger:
            port_snap = snap
    assert port_snap == snap  # the reference's snapshot, key for key


# ---------------------------------------------------------------- restack


@pytest.mark.parametrize(
    "new_cuts", [[0, 1, 3, 6], [0, 5, 6], [0, 1, 2, 3, 4, 5, 6], [0, 6]]
)
def test_restack_shards_matches_fresh_carve_bitwise(new_cuts):
    """restack == shard_device_index(cuts=...) array-for-array (and ==
    the reference's restack), including cuts that split old bands
    mid-way; then the stacked int8/packed stream of a ShardedEngine over
    the restacked shards equals one over the fresh carve."""
    pair = _small_setup(seed=7, n_ranges=6)
    old = clustered_index.shard_device_index(pair.idx, 3)
    cuts = np.asarray(new_cuts)
    fresh = clustered_index.shard_device_index(pair.idx, cuts=cuts)
    restacked = clustered_index.restack_shards(old, cuts)
    ref_restacked = ref_ci.restack_shards(ref_ci.shard_device_index(pair.ref_idx, 3), cuts)
    assert len(fresh) == len(restacked) == len(ref_restacked) == len(new_cuts) - 1
    for s, (f, r, w) in enumerate(zip(fresh, restacked, ref_restacked)):
        _same_shard(r, f, f"shard {s} vs fresh")
        _same_shard(r, w, f"shard {s} vs reference")
    # Staged variant: only= carves one output shard at a time, prep= shares
    # the geometry across the steps.
    prep = clustered_index.restack_prep(old, cuts)
    for s in range(len(new_cuts) - 1):
        (piece,) = clustered_index.restack_shards(old, cuts, only=s)
        (again,) = clustered_index.restack_shards(old, cuts, only=s, prep=prep)
        _same_shard(piece, fresh[s], f"only={s}")
        _same_shard(again, fresh[s], f"only={s}, prep")
        assert piece.shard_id == s
    # The packed stream a ShardedEngine stacks on its device, tensor for tensor.
    eng = Engine(pair.idx, k=5, device="cpu", impact_dtype="int8", docs_format="packed")
    a = ShardedEngine(eng, len(fresh), shards=restacked)
    b = ShardedEngine(eng, len(fresh), shards=fresh)
    for name, x, y in zip(a.dix._fields, a.dix, b.dix):
        assert x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all()), name
    assert a.doc_base.tolist() == b.doc_base.tolist()
    assert a.cuts.tolist() == cuts.tolist()


def test_restack_shards_rejects_bad_inputs():
    pair = _small_setup(seed=7, n_ranges=6)
    for mod, idx in ((clustered_index, pair.idx), (ref_ci, pair.ref_idx)):
        old = mod.shard_device_index(idx, 3)
        with pytest.raises(ValueError):
            mod.restack_shards(old, [0, 3])  # does not reach n_ranges
        with pytest.raises(ValueError):
            mod.restack_shards(old, [0, 3, 3, 6])  # empty band
        with pytest.raises(ValueError):
            mod.restack_shards([], [0, 6])
        with pytest.raises(ValueError):
            mod.restack_shards(old[:2], [0, 6])  # holes in the range space
        with pytest.raises(ValueError):
            mod.restack_prep(old[1:], [0, 6])


# ---------------------------------------------------------------- planner


def test_reshard_planner_arms_on_skewed_load():
    pair = _small_setup(seed=3, n_ranges=8)
    shards = clustered_index.shard_device_index(pair.idx, 4)
    mass = clustered_index.range_postings_mass(pair.idx)
    planners = [cls(range_mass=mass, cuts=clustered_index.shard_cuts(shards), trigger=1.25)
                for cls in (ReshardPlanner, RefPlanner)]

    def same():
        port, ref = planners
        assert port.load.tolist() == ref.load.tolist()
        assert port.imbalance() == ref.imbalance()
        assert port.propose().tolist() == ref.propose().tolist()
        assert port.should_reshard() == ref.should_reshard()
        assert port.batches_seen == ref.batches_seen
        return port

    assert not same().should_reshard()  # no observations yet
    for p in planners:
        p.observe(np.full(4, 1000.0), n_queries=4)
    port = same()
    assert port.imbalance() == pytest.approx(1.0) and not port.should_reshard()
    for _ in range(10):
        for p in planners:
            p.observe(np.asarray([8000.0, 1000.0, 1000.0, 1000.0]), 4)
        same()
    assert port.imbalance() > port.trigger and port.should_reshard()
    new_cuts, old_cuts = port.propose(), port.cuts
    assert not np.array_equal(new_cuts, old_cuts)
    assert new_cuts[1] <= old_cuts[1]  # hot shard's band did not grow
    for p in planners:
        p.committed(new_cuts)
        p.observe(np.zeros(4), n_queries=0)  # ignored
    assert same().batches_seen == 0 and not port.should_reshard()
    with pytest.raises(ValueError):
        port.observe(np.ones(3), 1)


def test_reshard_planner_scales_against_static_shares():
    for cls in (ReshardPlanner, RefPlanner):
        planner = cls(range_mass=np.asarray([100, 100, 100, 100]), cuts=np.asarray([0, 2, 4]))
        planner.observe(np.asarray([300.0, 100.0]), n_queries=1)
        np.testing.assert_array_equal(planner.propose(), [0, 1, 4])


# ------------------------------------------------- plane: serving + failover


def test_control_plane_serves_identically_to_sharded_engine():
    pair = _small_setup(seed=7, n_ranges=6, n_queries=12)
    plane, ref = pair.planes(3)
    _same_state(plane, ref, "fresh")
    base = ShardedEngine(pair.eng, 3)
    served = plane.replay(pair.queries, batch_size=4)
    _same_served(served, ref.replay(pair.queries, batch_size=4))
    assert sorted(s.rid for s in served) == list(range(len(pair.queries)))
    for s in served:
        b = base.traverse(pair.eng.plan(pair.queries[s.rid]))
        _same_result(s.result, b)
        assert s.result.exact
    assert plane.queries_served == len(pair.queries) == ref.queries_served
    _same_state(plane, ref, "served")


def test_degraded_serving_widens_fidelity_bound_and_recovers():
    pair = _small_setup(seed=9, n_ranges=6, n_queries=8)
    plane, ref = pair.planes(3)
    base = ShardedEngine(pair.eng, 3)
    dead = 1
    plane.mark_down(dead)
    ref.mark_down(dead)
    _same_state(plane, ref, "down")
    served = plane.replay(pair.queries, batch_size=4)
    _same_served(served, ref.replay(pair.queries, batch_size=4), "degraded")
    assert len(served) == len(pair.queries)
    degraded = 0
    for s in served:
        r = s.result
        plan = pair.eng.plan(pair.queries[s.rid])
        assert r.shard_exit_reasons[dead] == "down" and r.shard_postings[dead] == 0
        per_range = np.zeros(int(plane.cuts[-1]), np.int64)
        per_range[plan.order_host] = plan.bounds_host
        lo, hi = int(plane.cuts[dead]), int(plane.cuts[dead + 1])
        expect_fb = int(per_range[lo:hi].max())
        assert r.fidelity_bound == expect_fb
        if expect_fb > 0:
            assert not r.exact
            degraded += 1
    assert degraded > 0
    _same_state(plane, ref, "after outage")
    plane.mark_up(dead)
    ref.mark_up(dead)
    again = plane.replay(pair.queries, batch_size=4)
    _same_served(again, ref.replay(pair.queries, batch_size=4), "recovered")
    for s in again:
        b = base.traverse(pair.eng.plan(pair.queries[s.rid % len(pair.queries)]))
        _same_result(s.result, b)
        assert s.result.exact and "down" not in s.result.shard_exit_reasons
    _same_state(plane, ref, "recovered")


def test_down_mask_in_sharded_engine_traverse():
    pair = _small_setup(seed=11, n_ranges=6)
    se, ref_se = ShardedEngine(pair.eng, 4), RefSE(pair.ref_eng, 4, use_mesh=False)
    down = np.zeros(4, bool)
    down[2] = True
    for q in pair.queries[:4]:
        plan = pair.eng.plan(q)
        r = se.traverse(plan, down_mask=down)
        _same_result(r, ref_se.traverse(pair.ref_eng.plan(q), down_mask=down))
        assert r.shard_exit_reasons[2] == "down" and r.shard_postings[2] == 0
        if se.query_shard_mass(plan)[2] > 0:
            assert not r.exact and r.fidelity_bound > 0
        clean = se.traverse(plan)
        _same_result(clean, ref_se.traverse(pair.ref_eng.plan(q)))
        assert clean.exact or "budget" not in clean.shard_exit_reasons


def test_base_observe_api_never_credits_down_shards():
    down = np.zeros(4, bool)
    down[1] = True
    for cls in (ShardedSlaBudgeter, RefBudgeter):
        bud = cls(sla_ms=5.0, n_shards=4, down_mask=lambda: down)
        r0 = bud.rates.copy()
        bud.observe(10.0, total_postings=12000, n=3)
        assert bud.rates[1] == r0[1]
        assert np.all(bud.rates[[0, 2, 3]] > r0[[0, 2, 3]])
        expect = (1 - bud.ema) * r0[0] + bud.ema * (12000 / 3 / 3 / 10.0)
        assert np.isclose(bud.rates[0], expect)
        if cls is ShardedSlaBudgeter:
            port_rates = bud.rates.copy()
    assert port_rates.tolist() == bud.rates.tolist()

    pair = _small_setup(seed=5, n_ranges=6)
    plane, ref = pair.planes(3)
    assert plane.budgeter.down_mask is not None
    for p in (plane, ref):
        p.mark_down(1)
        frozen = p.budgeter.rates[1]
        p.budgeter.observe(7.0, 9000, 2)  # base API, mid-outage
        assert p.budgeter.rates[1] == frozen
    _same_state(plane, ref)


def test_reshard_refused_then_deferred_through_outage():
    pair = _small_setup(seed=19, n_ranges=6, n_queries=6)
    plane, ref = pair.planes(3)
    for p in (plane, ref):
        p.mark_down(1)
        with pytest.raises(RuntimeError, match="outage"):
            p.start_reshard(np.asarray([0, 1, 4, 6]))
        p.planner.load = np.asarray([9000.0, 100.0, 100.0])
        p.planner.batches_seen = 5
        assert p.planner.should_reshard()
        assert not p.maybe_reshard() and p.reshard_task is None
        with pytest.raises(ValueError, match="already the live layout"):
            p.start_reshard(p.cuts.copy(), defer_if_degraded=True)
        with pytest.raises(ValueError, match="rise strictly"):
            p.start_reshard(np.asarray([0, 4, 4, 6]), defer_if_degraded=True)
        assert p.deferred_reshard is None
        assert p.start_reshard(np.asarray([0, 1, 4, 6]), defer_if_degraded=True) is None
        assert p.stats()["reshard_deferred"]
    _same_state(plane, ref, "deferred")
    served = plane.replay(pair.queries, batch_size=4)
    _same_served(served, ref.replay(pair.queries, batch_size=4), "degraded")
    assert len(served) == len(pair.queries) and plane.reshard_task is None
    for p in (plane, ref):
        p.mark_up(1)
        assert p.reshard_task is not None and p.deferred_reshard is None
    while plane.reshard_task is not None:
        assert plane.reshard_task.stage == ref.reshard_task.stage
        plane.drain_once()
        ref.drain_once()
    assert ref.reshard_task is None
    np.testing.assert_array_equal(plane.cuts, [0, 1, 4, 6])
    _same_state(plane, ref, "cut over")
    fresh = ShardedEngine(pair.eng, 3, shards=clustered_index.shard_device_index(
        pair.idx, cuts=np.asarray([0, 1, 4, 6])))
    for q in pair.queries[:4]:
        plan = pair.eng.plan(q)
        a = plane.bengine.run_batch([plan])[0]
        _same_result(a, fresh.traverse(plan))
        _same_result(a, ref.bengine.run_batch([pair.ref_eng.plan(q)])[0])


# --------------------------------------------------- plane: online reshard


def test_live_reshard_never_pauses_and_cuts_over_bitwise():
    pair = _small_setup(seed=7, n_ranges=6, n_queries=12)
    plane, ref = pair.planes(3)
    new_cuts = np.asarray([0, 1, 4, 6])
    assert not np.array_equal(new_cuts, plane.cuts)
    task = plane.start_reshard(new_cuts)
    ref_task = ref.start_reshard(new_cuts)
    stages, i = [], 0
    while plane.reshard_task is not None:
        q = pair.queries[i % len(pair.queries)]
        plane.submit(q)
        ref.submit(q)
        stages.append(task.stage)
        assert task.stage == ref_task.stage
        served = plane.drain_once()
        _same_served(served, ref.drain_once(), f"drain {i}")
        assert len(served) == 1 and served[0].result.doc_ids.shape[0] > 0
        assert task.steps_done == ref_task.steps_done
        i += 1
    assert ref.reshard_task is None and task.ready
    assert plane.reshards_completed == 1
    assert "carve" in stages and "build" in stages
    np.testing.assert_array_equal(plane.cuts, new_cuts)
    assert plane.queries_served_during_reshard == len(stages)
    for s, (piece, want) in enumerate(zip(task.new_shards, ref_task.new_shards)):
        _same_shard(piece, want, f"carved shard {s}")
    _same_state(plane, ref, "cut over")

    fresh = ShardedEngine(pair.eng, 3, shards=clustered_index.shard_device_index(
        pair.idx, cuts=new_cuts))
    for q in pair.queries:
        plan = pair.eng.plan(q)
        a = plane.bengine.run_batch([plan])[0]
        _same_result(a, fresh.traverse(plan))
        _same_result(a, ref.bengine.run_batch([pair.ref_eng.plan(q)])[0])
    t2 = plane.start_reshard(np.asarray([0, 2, 4, 6]))
    with pytest.raises(RuntimeError):
        plane.start_reshard(np.asarray([0, 1, 2, 6]))
    while plane.reshard_task is not None:
        plane.drain_once()
    assert plane.reshards_completed == 2 and t2.ready


def test_reshard_from_saved_artifact(tmp_path):
    pair = _small_setup(seed=13, n_ranges=6, n_queries=6)
    plane, ref = pair.planes(3)
    path, ref_path = str(tmp_path / "layout"), str(tmp_path / "ref_layout")
    plane.save_shards(path)
    ref.save_shards(ref_path)
    manifest = index_io.read_manifest(path)
    assert manifest["range_cuts"] == plane.cuts.tolist()
    assert manifest["source_fingerprint"] == pair.idx.fingerprint()
    assert manifest == ref_io.read_manifest(ref_path)  # the same artifact

    bare = str(tmp_path / "bare")
    index_io.save_shards(plane.sengine.shards, bare)
    with pytest.raises(index_io.ArtifactError):
        plane.start_reshard(np.asarray([0, 1, 4, 6]), shards_path=bare)

    new_cuts = np.asarray([0, 1, 4, 6])
    if np.array_equal(new_cuts, plane.cuts):
        new_cuts = np.asarray([0, 2, 4, 6])
    # Each package's plane restacks from the OTHER package's artifact.
    plane.start_reshard(new_cuts, shards_path=ref_path)
    ref.start_reshard(new_cuts, shards_path=path)
    while plane.reshard_task is not None:
        plane.drain_once()
    while ref.reshard_task is not None:
        ref.drain_once()
    fresh = ShardedEngine(pair.eng, 3, shards=clustered_index.shard_device_index(
        pair.idx, cuts=new_cuts))
    for q in pair.queries:
        plan = pair.eng.plan(q)
        a = plane.bengine.run_batch([plan])[0]
        _same_result(a, fresh.traverse(plan))
        _same_result(a, ref.bengine.run_batch([pair.ref_eng.plan(q)])[0])


def test_planner_driven_reshard_under_skewed_traffic():
    pair = _planted_setup()
    plane, ref = pair.planes(4, reshard_trigger=1.2)
    rng = np.random.default_rng(5)
    topic_queries = [rng.choice(40, size=8, replace=False).astype(np.int32)
                     for _ in range(16)]
    _same_served(plane.replay(topic_queries, batch_size=4),
                 ref.replay(topic_queries, batch_size=4), "skewed")
    assert plane.planner.imbalance() > plane.planner.trigger
    _same_state(plane, ref, "armed")
    assert plane.maybe_reshard() and ref.maybe_reshard()
    old_hot_band = int(plane.cuts[1] - plane.cuts[0])
    while plane.reshard_task is not None:
        plane.submit(topic_queries[0])
        ref.submit(topic_queries[0])
        served = plane.drain_once()
        _same_served(served, ref.drain_once())
        assert len(served) == 1
    assert plane.reshards_completed == 1 == ref.reshards_completed
    assert int(plane.cuts[1] - plane.cuts[0]) <= old_hot_band
    _same_state(plane, ref, "cut over")
    fresh = ShardedEngine(pair.eng, 4, shards=clustered_index.shard_device_index(
        pair.idx, cuts=plane.cuts))
    for q in topic_queries[:4]:
        plan = pair.eng.plan(q)
        _same_result(plane.bengine.run_batch([plan])[0], fresh.traverse(plan))


# -------------------------------------------- shard-aware range selection


def test_boundsum_budgets_concentrate_on_scoring_shards():
    pair = _planted_setup()
    se, ref_se = ShardedEngine(pair.eng, 4), RefSE(pair.ref_eng, 4, use_mesh=False)
    q = np.arange(8, dtype=np.int32)  # topic-0 terms only
    plans, ref_plans = [pair.eng.plan(q)], [pair.ref_eng.plan(q)]
    kw = dict(sla_ms=1.0, rate=float(2 * BLOCK), n_shards=4)
    b = ShardedSlaBudgeter(**kw, mode="boundsum", shard_mass=se.query_shard_mass).budgets(
        1, plans=plans)
    want = RefBudgeter(**kw, mode="boundsum", shard_mass=ref_se.query_shard_mass).budgets(
        1, plans=ref_plans)
    assert b.dtype == want.dtype and b.tolist() == want.tolist()
    mass = se.query_shard_mass(plans[0])
    assert mass.tolist() == ref_se.query_shard_mass(ref_plans[0]).tolist()
    assert mass[0] > 0 and np.all(mass[1:] == 0)
    assert b[0][0] == 4 * 2 * BLOCK and np.all(b[0][1:] == 0)
    b_rate = ShardedSlaBudgeter(**kw).budgets(1, plans=plans)[0]
    assert np.all(b_rate == 2 * BLOCK)
    b_inf = ShardedSlaBudgeter(sla_ms=float("inf"), n_shards=4, mode="boundsum",
                               shard_mass=se.query_shard_mass).budgets(1, plans=plans)[0]
    assert np.all(b_inf == INT32_MAX)
    with pytest.raises(ValueError):
        ShardedSlaBudgeter(sla_ms=1.0, n_shards=4, mode="boundsum")
    with pytest.raises(ValueError):
        ShardedSlaBudgeter(sla_ms=1.0, n_shards=4, mode="nope")


def test_boundsum_budgets_improve_fidelity_on_skewed_index():
    pair = _planted_setup(seed=1)
    se = ShardedEngine(pair.eng, 4)
    beng = ShardedBatchEngine(se, BucketSpec(max_batch=8))
    ref_se = RefSE(pair.ref_eng, 4, use_mesh=False)
    ref_beng = RefSBE(ref_se, RefSpec(max_batch=8))
    rng = np.random.default_rng(2)
    queries = [rng.choice(40, size=12, replace=False).astype(np.int32) for _ in range(8)]
    plans, ref_plans = beng.plan_many(queries), ref_beng.plan_many(queries)
    kw = dict(sla_ms=1.0, rate=float(4 * BLOCK), n_shards=4)
    b_rate = ShardedSlaBudgeter(**kw).budgets(len(plans), plans=plans)
    b_bs = ShardedSlaBudgeter(**kw, mode="boundsum", shard_mass=se.query_shard_mass).budgets(
        len(plans), plans=plans)
    assert b_bs.tolist() == RefBudgeter(
        **kw, mode="boundsum", shard_mass=ref_se.query_shard_mass).budgets(
        len(plans), plans=ref_plans).tolist()
    assert int(b_bs.sum()) <= int(b_rate.sum()) * 2
    r_rate = beng.run_batch(plans, budget_postings=b_rate, safe_stop=False)
    r_bs = beng.run_batch(plans, budget_postings=b_bs, safe_stop=False)
    for got, want in ((r_rate, ref_beng.run_batch(ref_plans, budget_postings=b_rate,
                                                  safe_stop=False)),
                      (r_bs, ref_beng.run_batch(ref_plans, budget_postings=b_bs,
                                                safe_stop=False))):
        for i, (g, w) in enumerate(zip(got, want)):
            _same_result(g, w, f"query {i}")
    fb_rate = np.asarray([r.fidelity_bound for r in r_rate])
    fb_bs = np.asarray([r.fidelity_bound for r in r_bs])
    assert np.any(fb_rate > 0)
    assert np.all(fb_bs <= fb_rate)
    assert fb_bs.mean() < fb_rate.mean()


# ------------------------------------------------------ replica group (CPU)


def test_replica_group_fallback_matches_sharded_engine():
    """On one device the group serves through the wrapped engine unchanged;
    the (data x shard) mesh needs the wrapped engine on a mesh
    (``tests/test_torch_mesh.py`` runs it on one)."""
    pair = _small_setup(seed=17, n_ranges=6)
    se = ShardedEngine(pair.eng, 2)
    rep = ReplicaGroupEngine(se, 2, use_mesh=False)
    assert rep.group_mesh is None and rep.n_shards == 2 and rep.cuts is se.cuts
    beng = ShardedBatchEngine(rep, BucketSpec(max_batch=4))
    sbeng = ShardedBatchEngine(se, BucketSpec(max_batch=4))
    ref_rep = RefReplica(RefSE(pair.ref_eng, 2, use_mesh=False), 2, use_mesh=False)
    ref_beng = RefSBE(ref_rep, RefSpec(max_batch=4))
    plans = beng.plan_many(pair.queries)
    want = ref_beng.run_batch(ref_beng.plan_many(pair.queries))
    for a, b, w in zip(beng.run_batch(plans), sbeng.run_batch(plans), want):
        _same_result(a, b)
        _same_result(a, w)
    assert rep.dispatches == 0 == ref_rep.dispatches
    assert ReplicaGroupEngine(se, 2).group_mesh is None  # auto, one device
    with pytest.raises(ValueError):
        ReplicaGroupEngine(se, 0)
    with pytest.raises(ValueError, match="on the mesh"):
        ReplicaGroupEngine(se, 2, use_mesh=True)


def test_plane_with_replicas_serves_through_the_fallback():
    """``ControlPlane(..., n_replicas=2)`` on one device: ``replica_mesh``
    False, no replica-mesh dispatch, results and ``stats()`` the
    reference's; a degraded replica row reroutes through the single path
    at full fidelity; ``use_mesh=True`` without a process group raises."""
    pair = _small_setup(seed=7, n_ranges=6, n_queries=12)
    plane, ref = pair.planes(2, n_replicas=2)
    assert isinstance(plane.replicas, ReplicaGroupEngine)
    assert plane.stats()["replica_mesh"] is False
    _same_state(plane, ref, "fresh")
    _same_served(plane.replay(pair.queries, batch_size=4),
                 ref.replay(pair.queries, batch_size=4))
    plane.mark_down(0, replica=1)
    ref.mark_down(0, replica=1)
    served = plane.replay(pair.queries[:4], batch_size=4)
    _same_served(served, ref.replay(pair.queries[:4], batch_size=4))
    assert all(s.result.exact for s in served)
    assert plane.replicas.dispatches == 0
    _same_state(plane, ref, "degraded replica")
    with pytest.raises(ValueError, match="process group"):
        ControlPlane(pair.eng, n_shards=2, n_replicas=2, use_mesh=True)


def test_serve_control_mode_on_the_cpu(tmp_path):
    """``launch/serve.py --mode control``'s loop: healthy, shard 0 down
    (degraded answers), recovered, a live reshard with serving on; with
    ``obs`` the operations loop runs and the snapshot is written."""
    from repro_torch.launch import serve
    from repro_torch.obs import Instrumentation

    pair = _small_setup(seed=7, n_ranges=6, n_queries=24)
    metrics = str(tmp_path / "m.json")
    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    stats = serve.serve_control(pair.eng, pair.queries, n_shards=3, n_replicas=2,
                                batch_size=4, n_calibrate=8, obs=obs,
                                metrics_path=metrics)
    assert stats["queries"] == len(pair.queries) and stats["replica_mesh"] is False
    assert stats["degraded"] > 0 and stats["reshards"] == 1
    assert stats["cuts"] != stats["first_cuts"] and stats["served_during_reshard"] > 0
    assert stats["batches"] > 0 and stats["budget_mode"] == "boundsum"
    assert "availability" in stats["slo"]  # no latency SLO without an SLA
    assert json.load(open(metrics))["metrics"]["served_queries"]
