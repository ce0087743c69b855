"""The port's mesh paths against the JAX package's answers, on the CPU.

Each case spawns a gloo group of 2, 4 or 8 CPU ranks: this file, run as a
script (``python tests/test_torch_mesh.py <case> <rank> <world> <init>
<out>``), imports only ``repro_torch`` on the rank side (no JAX), meets
through ``init_method=file://`` under ``tmp_path`` and answers within a
timeout of its own. Rank 0 drives the serving scenarios
(``distributed.sharding.driving``); the other ranks execute what it sends
(``worker_loop``). The lookups and the partitioned IR are SPMD: every rank
calls them. The scenario code is shared: the test process runs the same
scenarios through the reference's single-device path (``use_mesh=False``,
its 1 x 1 mesh) and every observable is compared bitwise: the fields of
each ``ShardedResult``, served rids, batch sizes and latencies under one
fake clock, budgeter rates, plane state, the obs counters; the lookups
exactly in float32.

A sharded top-k equals the unsharded one only up to ties at the k-th
score unless both run exhaustively (ROADMAP C4), so the mesh is held
against the reference's *sharded* path, which it must equal exactly.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
INT32_MAX = 2**31 - 1
K = 5
GROUP_TIMEOUT_S = 240


# --------------------------------------------------------------------------
# Scenarios, written once over either package's names (a "kit")
# --------------------------------------------------------------------------


def _rec(r) -> tuple:
    """A ShardedResult as plain values, with the types of its scalars."""
    return (r.doc_ids.tolist(), str(r.doc_ids.dtype), r.scores.tolist(),
            str(r.scores.dtype), r.shard_postings.tolist(), r.shard_blocks.tolist(),
            r.shard_ranges.tolist(), tuple(r.shard_exit_reasons), r.fidelity_bound,
            type(r.fidelity_bound).__name__, r.exact, type(r.exact).__name__)


def _served(served) -> list:
    return [(s.rid, s.batch_size, _rec(s.result))
            for s in sorted(served, key=lambda s: s.rid)]


def _setup(kit):
    """A 6-range index at two storage configurations and 8 queries."""
    corpus = kit.make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=7)
    idx = kit.build_index(corpus, n_ranges=6, strategy="clustered")
    log = kit.make_query_log(corpus, n_queries=8, seed=8)
    engines = {cfg: kit.Engine(idx, k=K, impact_dtype=cfg[0], docs_format=cfg[1],
                               **kit.engine_kw)
               for cfg in (("int32", "int32"), ("int8", "packed"), ("int8", "int32"))}
    return idx, engines, [log.terms[i] for i in range(log.n_queries)]


def _make_server(kit, engines, rank: int, use_mesh: bool):
    """A sharded MicroBatchServer on a fake clock that differs per rank:
    rank 0's is the reference's; the others never drive."""
    se = kit.ShardedEngine(engines["int8", "packed"], 4, use_mesh=use_mesh)
    budgeter = kit.ShardedSlaBudgeter(
        sla_ms=4.0, policy=kit.Reactive(alpha=1.0, beta=1.5, q=0.01), rate=50.0,
        n_shards=4, mode="boundsum", shard_mass=se.query_shard_mass)
    return kit.MicroBatchServer(
        kit.ShardedBatchEngine(se, kit.BucketSpec(max_batch=4)), budgeter, max_batch=4,
        clock=kit.FakeClock(dt=0.0015 * (1 + rank), start=5.0 * rank))


def _serving(kit, engines, queries, server, use_mesh: bool) -> dict:
    """Every serving scenario; rank 0 runs it on the mesh."""
    out = {}
    n = len(queries)
    rng = np.random.default_rng(1)
    forms = {
        "none": {},
        "[n]": dict(budget_postings=rng.choice([0, 60, 900, INT32_MAX], size=n)),
        "starved": dict(budget_postings=np.tile([INT32_MAX, 0, 700, INT32_MAX], (n, 1))),
        "down": dict(down_mask=np.array([False, False, True, False]),
                     budget_postings=800),
    }
    for cfg in (("int32", "int32"), ("int8", "packed")):
        se = kit.ShardedEngine(engines[cfg], 4, use_mesh=use_mesh)
        be = kit.ShardedBatchEngine(se, kit.BucketSpec(max_batch=4))
        plans = be.plan_many(queries)
        for label, kw in forms.items():
            for ss in ((True, False) if label in ("none", "[n]") else (True,)):
                out["S4", cfg, label, ss] = [
                    _rec(r) for r in be.run_batch(plans, safe_stop=ss, **kw)]
        out["S4", cfg, "traverse"] = [_rec(se.traverse(plans[0], budget_postings=700))]
        out["S4", cfg, "shapes"] = (sorted(be.compiled_shapes), be.batches_run)
        kit.release(se)

    # S = 2 on the first two ranks, then the (data x shard) replica group.
    obs = kit.Instrumentation.make()
    se2 = kit.ShardedEngine(engines["int8", "int32"], 2, use_mesh=use_mesh, obs=obs)
    be2 = kit.ShardedBatchEngine(se2, kit.BucketSpec(max_batch=4))
    plans = be2.plan_many(queries)
    out["S2"] = [_rec(r) for r in be2.run_batch(plans, budget_postings=500)]
    rep = kit.ReplicaGroupEngine(se2, 2, use_mesh=use_mesh)
    rbe = kit.ShardedBatchEngine(rep, kit.BucketSpec(max_batch=4))
    out["replica", "full"] = [_rec(r) for r in rbe.run_batch(plans)]
    out["replica", "odd"] = [_rec(r) for r in rbe.run_batch(plans[:3],
                                                            budget_postings=400)]
    # A batch of 3 on 2 replica rows: one inert pad lane.
    w = max(se2.shard_plan(p)[0].shape[-1] for p in plans[:3])
    blk, rest, order, bounds = (np.stack(t) for t in zip(
        *[se2.shard_plan(p, w) for p in plans[:3]]))
    caps = np.array([[INT32_MAX, 300], [200, INT32_MAX], [0, 900]])
    out["replica", "dispatch3"] = [np.asarray(a).tolist() for a in kit.outputs(
        rep.dispatch(blk, rest, order, bounds, caps, np.full((3, 2), INT32_MAX)), K, 2)]
    out["replica", "obs"] = {
        name: m for name, m in obs.metrics.snapshot().items()
        if not name.startswith("replica_")}
    out["replica", "mesh"] = (
        rep.group_mesh is not None, rep.dispatches,
        obs.metrics.counter("replica_dispatches").total(),
        obs.metrics.histogram("replica_pad_lanes").count(),
        obs.metrics.histogram("replica_pad_lanes").mean()
        * obs.metrics.histogram("replica_pad_lanes").count())

    # The plane over the replica mesh: healthy, a degraded replica row, a
    # downed shard and its recovery, then a live reshard.
    plane = kit.ControlPlane(engines["int32", "int32"], n_shards=2, n_replicas=2,
                             spec=kit.BucketSpec(max_batch=4), use_mesh=use_mesh,
                             clock=kit.FakeClock(dt=0.001))
    out["plane", "replica_mesh"] = plane.stats()["replica_mesh"]
    out["plane", "healthy"] = _served(plane.replay(queries, batch_size=4))
    plane.mark_down(0, replica=1)
    out["plane", "row down"] = _served(plane.replay(queries[:4], batch_size=4))
    plane.mark_up(0, replica=1)
    plane.mark_down(1)
    out["plane", "shard down"] = _served(plane.replay(queries[:5], batch_size=4))
    plane.mark_up(1)
    out["plane", "recovered"] = _served(plane.replay(queries, batch_size=4))
    cuts = plane.cuts.copy()
    cuts[1] += 1 if cuts[1] + 1 < cuts[2] else -1
    task = plane.start_reshard(cuts)
    served, qi = [], 0
    while plane.reshard_task is not None or plane.pending:
        for q in queries[qi % n:qi % n + 2]:
            plane.submit(q)
        qi += 2
        served.extend(plane.drain_once())
    out["plane", "reshard"] = (_served(served), task.steps_done, plane.cuts.tolist())
    out["plane", "after"] = _served(plane.replay(queries, batch_size=4))
    st = plane.stats()
    st.pop("replica_mesh")
    out["plane", "stats"] = (st, plane.budgeter.rates.tolist(), plane.health._up.tolist())

    # Degraded failover on four shards, mid-stream, and bitwise recovery.
    plane4 = kit.ControlPlane(engines["int8", "packed"], n_shards=4,
                              spec=kit.BucketSpec(max_batch=4), use_mesh=use_mesh,
                              clock=kit.FakeClock(dt=0.001))
    base = _served(plane4.replay(queries, batch_size=4))
    for q in queries[: n // 2]:
        plane4.submit(q)
    first = plane4.drain_once()
    plane4.mark_down(2)
    rest = []
    while plane4.pending:
        rest.extend(plane4.drain_once())
    for q in queries[n // 2:]:
        plane4.submit(q)
    while plane4.pending:
        rest.extend(plane4.drain_once())
    plane4.mark_up(2)
    out["failover"] = (base, _served(first), _served(rest),
                       _served(plane4.replay(queries, batch_size=4)))

    stream = queries + queries[:3]
    s = server.replay(stream, batch_size=3)
    out["server"] = ([(x.rid, x.batch_size, x.latency_ms, _rec(x.result)) for x in s],
                     server.budgeter.rates.tolist(), float(server.budgeter.policy.alpha))
    return out


def _lookup_inputs():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((16, 6)).astype(np.float32)
    return table, {"[8, 3]": rng.integers(-1, 16, size=(8, 3)).astype(np.int32),
                   "[5]": np.array([3, -1, 15, 0, 8], np.int32)}


def _ir_setup(kit):
    """Partitioned IR over 4 sub-indexes of a corpus with every document
    twice (tied scores in every top-k), and 8 queries."""
    corpus = kit.make_corpus(n_docs=600, n_terms=700, n_topics=4, mean_doc_len=40, seed=3)
    corpus = kit.concat_corpora(corpus, corpus)
    log = kit.make_query_log(corpus, n_queries=8, seed=4)
    arrays, engines = kit.build_sharded_index(corpus, n_shards=4, n_ranges_per_shard=4,
                                              **kit.engine_kw)
    return arrays, kit.plan_queries(engines, log.terms)


# --------------------------------------------------------------------------
# The rank side (no JAX)
# --------------------------------------------------------------------------


def _port_kit():
    import types

    from repro_torch.configs.registry import ARCHS
    from repro_torch.control import ControlPlane, ReplicaGroupEngine
    from repro_torch.core.anytime import Reactive
    from repro_torch.core.clustered_index import build_index
    from repro_torch.core.range_daat import Engine
    from repro_torch.data.synth import concat_corpora, make_corpus, make_query_log
    from repro_torch.distributed.sharding import release
    from repro_torch.obs import FakeClock, Instrumentation
    from repro_torch.serve.distributed_ir import build_sharded_index, plan_queries
    from repro_torch.serving import (
        BucketSpec, MicroBatchServer, ShardedBatchEngine, ShardedEngine,
        ShardedSlaBudgeter,
    )
    from repro_torch.serving.sharded import split_outputs

    def outputs(out, k, n_shards):
        return split_outputs(out.cpu().numpy(), k, n_shards)

    return types.SimpleNamespace(**locals(), engine_kw=dict(device="cpu"))


def _rank_serve(kit, rt) -> dict | None:
    """World 4: the lookups (SPMD), then rank 0 drives the serving."""
    import torch
    import torch.distributed

    from repro_torch.distributed import sharding as ms
    from repro_torch.models.embedding import sharded_field_lookup

    out = {}
    table, ids = _lookup_inputs()
    for shape in ((1, 4), (2, 2)):
        ctx = ms.ShardCtx(ms.make_mesh(shape, ("data", "model")))
        for name, i in ids.items():
            got = sharded_field_lookup(torch.from_numpy(table), torch.from_numpy(i), ctx)
            out["lookup", shape, name] = got.numpy()
    for fn, args in ((ms.replica_mesh, (4, 2)), (ms.retrieval_mesh, (5,)),
                     (ms.make_mesh, ((3, 2), ("data", "model")))):
        try:
            fn(*args)
            out["raises", fn.__name__] = None
        except ValueError as e:
            out["raises", fn.__name__] = str(e)
    idx, engines, queries = _setup(kit)
    out["fingerprint"] = idx.fingerprint()
    for e in engines.values():  # lockstep: rank 0 may name them later
        ms.register(e)
    server = _make_server(kit, engines, rt.rank, use_mesh=True)
    if rt.rank == 0:
        with ms.driving():
            out.update(_serving(kit, engines, queries, server, use_mesh=True))
    else:
        ms.worker_loop()
    # Rank 0 leaving driving() on an exception makes the other ranks raise.
    aborted = False
    if rt.rank == 0:
        with pytest.raises(KeyError):
            with ms.driving():
                raise KeyError("stop")
    else:
        try:
            ms.worker_loop()
        except RuntimeError:
            aborted = True
    flags = [None] * rt.world
    torch.distributed.all_gather_object(flags, aborted, group=rt.control)
    out["aborted"] = flags
    return out if rt.rank == 0 else None


def _rank_ir(kit, rt) -> dict:
    """World 8: partitioned IR on a 2 x 4 (data x model) context (SPMD)."""
    from repro_torch.distributed import sharding as ms
    from repro_torch.serve.distributed_ir import sharded_anytime_query

    ctx = ms.ShardCtx(ms.make_mesh((2, 4), ("data", "model")))
    arrays, tables = _ir_setup(kit)
    out = {}
    for budget in (INT32_MAX, 300):
        v, i, r = sharded_anytime_query(arrays, tables, ctx, budget=budget)
        out["ir", budget] = (v.numpy(), i.numpy(), int(r))
    arch = kit.ARCHS["anytime-ir"]
    cfg = dict(arch.model_config(True), s_pad=arrays.s_pad, k=arrays.k, nnz_loc=64 * 200)
    step, _ = arch.build_step(cfg, "serve_anytime", shard_ctx=ctx)
    v, i, r = step(arrays, {"tables": tables})
    out["arch"] = (v.numpy(), i.numpy(), int(r))
    return out


def _rank_main(case: str, rank: str, world: str, init: str, path: str) -> None:
    import torch

    from repro_torch.distributed import sharding as ms

    torch.set_num_threads(1)
    rt = ms.init_mesh_group(device="cpu", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world), timeout_s=GROUP_TIMEOUT_S - 30)
    out = {"serve": _rank_serve, "ir": _rank_ir}[case](_port_kit(), rt)
    if rt.rank == 0:
        out["backend"] = (rt.backend, str(rt.device), rt.world, rt.staged)
        with open(path, "wb") as f:
            pickle.dump(out, f)
    ms.close_mesh_group()


def _spawn(case: str, world: int, tmp: Path) -> dict:
    """Run ``case`` on ``world`` ranks; rank 0's answers."""
    init, path = tmp / f"{case}.init", tmp / f"{case}.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(world), str(init), str(path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    with open(path, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
    sys.exit(0)


# --------------------------------------------------------------------------
# The test side: the reference's answers
# --------------------------------------------------------------------------


def _ref_kit():
    import types

    from repro.control import ControlPlane, ReplicaGroupEngine
    from repro.core.anytime import Reactive
    from repro.core.clustered_index import build_index
    from repro.core.range_daat import Engine
    from repro.data.synth import concat_corpora, make_corpus, make_query_log
    from repro.obs import FakeClock, Instrumentation
    from repro.serve.distributed_ir import build_sharded_index, plan_queries
    from repro.serving import (
        BucketSpec, MicroBatchServer, ShardedBatchEngine, ShardedEngine,
        ShardedSlaBudgeter,
    )

    def release(obj):
        del obj

    def outputs(out, k, n_shards):
        return [np.asarray(x) for x in out]

    return types.SimpleNamespace(**locals(), engine_kw={})


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """(the mesh's answers on 4 ranks, the reference's)."""
    got = _spawn("serve", 4, tmp_path_factory.mktemp("mesh_serve"))
    kit = _ref_kit()
    idx, engines, queries = _setup(kit)
    want = _serving(kit, engines, queries, _make_server(kit, engines, 0, False), False)
    want["fingerprint"] = idx.fingerprint()
    return got, want


def _ref_mesh_step(arrays, tables, budget):
    """The reference's mesh step with one shard per model rank: its
    shard_map body's ``_local_traverse`` on every (query, shard) pair, the
    docid lift, the shard-major gather and its stable ``argsort`` merge,
    and the ranges summed. (Its own 1 x 1 mesh gives each rank the whole
    [M, ...] block and traverses only shard 0 of it, ``a[0]``/``b[0]``, so
    it is not the reference's answer at M = 4; ROADMAP C6.)"""
    import jax.numpy as jnp

    from repro.serve.distributed_ir import _local_traverse

    blk, rest, order, bounds = (np.asarray(t) for t in tables)
    Q, M = blk.shape[:2]
    arr = [np.asarray(getattr(arrays, f)) for f in (
        "docs", "impacts", "blk_start", "blk_len", "blk_maximp", "range_starts")]
    base = np.asarray(arrays.doc_base)
    vals, gids, nr = [], [], 0
    for qi in range(Q):
        for m in range(M):
            v, i, r = _local_traverse(
                tuple(jnp.asarray(a[m]) for a in arr), jnp.asarray(blk[qi, m]),
                jnp.asarray(rest[qi, m]), jnp.asarray(order[qi, m]),
                jnp.asarray(bounds[qi, m]), s_pad=arrays.s_pad, k=arrays.k, budget=budget)
            i = np.asarray(i)
            vals.append(np.asarray(v))
            gids.append(np.where(i >= 0, i + base[m], -1))
            nr += int(r)
    mv = jnp.asarray(np.stack(vals).reshape(Q, -1))
    mi = jnp.asarray(np.stack(gids).reshape(Q, -1))
    sel = jnp.argsort(-mv, axis=1)[:, :arrays.k]
    return (np.asarray(jnp.take_along_axis(mv, sel, axis=1)),
            np.asarray(jnp.take_along_axis(mi, sel, axis=1)), nr)


@pytest.fixture(scope="module")
def ir_run(tmp_path_factory):
    """(the 2 x 4 mesh's answers on 8 ranks, the reference's step with one
    shard per model rank)."""
    got = _spawn("ir", 8, tmp_path_factory.mktemp("mesh_ir"))
    arrays, tables = _ir_setup(_ref_kit())
    want = {("ir", b): _ref_mesh_step(arrays, tables, b) for b in (INT32_MAX, 300)}
    want["arch"] = _ref_mesh_step(arrays, tables, 200)  # serve_anytime: nnz_loc // 64
    return got, want


def test_mesh_group_is_gloo_on_the_cpu(serve_run):
    got, want = serve_run
    assert got["backend"] == ("gloo", "cpu", 4, False)
    assert got["fingerprint"] == want["fingerprint"]


SERVE_KEYS = [
    (("S4", cfg, label, ss), f"S4-{cfg[0]}-{cfg[1]}-{label}-{ss}")
    for cfg in (("int32", "int32"), ("int8", "packed"))
    for label, sss in (("none", (True, False)), ("[n]", (True, False)),
                       ("starved", (True,)), ("down", (True,)))
    for ss in sss
] + [(("S4", cfg, what), f"S4-{cfg[0]}-{cfg[1]}-{what}")
     for cfg in (("int32", "int32"), ("int8", "packed")) for what in ("traverse", "shapes")]


@pytest.mark.parametrize("key", [k for k, _ in SERVE_KEYS], ids=[i for _, i in SERVE_KEYS])
def test_sharded_engine_on_four_ranks_matches_reference(serve_run, key):
    """One shard per rank, S = 4, driven from rank 0: every ShardedResult
    field of ``run_batch`` and ``traverse``, bitwise, under both safe-stop
    settings, per-query budgets, a starved shard and a downed shard."""
    got, want = serve_run
    assert got[key] == want[key]


def test_starved_shard_exit_reasons_survive_the_gather(serve_run):
    got, _ = serve_run
    for cfg in (("int32", "int32"), ("int8", "packed")):
        reasons = [rec[7] for rec in got["S4", cfg, "starved", True]]
        assert any(r[1] == "budget" for r in reasons), reasons
        down = [rec[7] for rec in got["S4", cfg, "down", True]]
        assert all(r[2] == "down" for r in down), down


def test_two_shards_on_a_four_rank_group_match_reference(serve_run):
    got, want = serve_run
    assert got["S2"] == want["S2"]


@pytest.mark.parametrize("what", ["full", "odd", "dispatch3"])
def test_replica_mesh_matches_one_replica(serve_run, what):
    """2 x 2 (data x shard): the batch split over replica rows, an odd
    batch padded with inert lanes; bitwise the reference's one replica."""
    got, want = serve_run
    assert got["replica", what] == want["replica", what]


def test_replica_mesh_counts_once_per_dispatch(serve_run):
    """The obs counters of rank 0 read as the reference's (no per-rank
    double count); one pad lane in the odd batch's one dispatch."""
    got, want = serve_run
    assert got["replica", "obs"] == want["replica", "obs"]
    on_mesh, dispatches, counted, pads_seen, pad_lanes = got["replica", "mesh"]
    assert on_mesh and dispatches >= 3 and dispatches == counted == pads_seen
    assert pad_lanes == pytest.approx(1.0)
    assert want["replica", "mesh"][:2] == (False, 0)


@pytest.mark.parametrize("phase", ["healthy", "row down", "shard down", "recovered",
                                   "reshard", "after", "stats"])
def test_control_plane_on_the_replica_mesh_matches_reference(serve_run, phase):
    """``ControlPlane(n_replicas=2)`` on the 2 x 2 mesh under a fake clock:
    served queries, a degraded replica row, a downed shard, recovery and a
    live reshard whose successor every rank builds, then the plane's
    state; ``replica_mesh`` True."""
    got, want = serve_run
    assert got["plane", "replica_mesh"] is True
    assert want["plane", "replica_mesh"] is False
    assert got["plane", phase] == want["plane", phase]


def test_degraded_failover_on_four_ranks_matches_reference(serve_run):
    """Shard 2 down mid-stream on a 4-rank mesh: every query answers
    degraded through the fidelity bound; recovery is bitwise."""
    got, want = serve_run
    assert got["failover"] == want["failover"]
    base, _, rest, after = got["failover"]
    assert all(rec[7][2] == "down" for _, _, rec in rest)
    assert any(not rec[10] for _, _, rec in rest)
    assert [x[1:] for x in after] == [x[1:] for x in base]  # rids run on


def test_server_under_mismatched_rank_clocks_matches_reference(serve_run):
    """Every rank built its server on its own fake clock; rank 0 drives,
    so budgets, batches, latencies and rates are the reference's."""
    got, want = serve_run
    assert got["server"] == want["server"]
    assert len({str(rec[3][4]) for rec in got["server"][0]}) > 1


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["[8, 3]", "[5]"])
def test_sharded_field_lookup_on_a_context_matches_reference(serve_run, shape, name):
    """Row-sharded lookup, ``psum`` over ``model``: exactly the reference's
    ``ctx=None`` lookup in float32, padding ids (-1) reading zeros."""
    import jax.numpy as jnp

    from repro.models.embedding import sharded_field_lookup

    got, _ = serve_run
    table, ids = _lookup_inputs()
    want = np.asarray(sharded_field_lookup(jnp.asarray(table), jnp.asarray(ids[name]),
                                           None))
    g = got["lookup", shape, name]
    assert g.dtype == np.float32 and g.shape == want.shape
    assert np.array_equal(g, want)


def test_workers_raise_when_rank_0_fails_while_driving(serve_run):
    got, _ = serve_run
    assert got["aborted"] == [False, True, True, True]


def test_meshes_larger_than_the_group_raise(serve_run):
    got, _ = serve_run
    assert "needs 8 ranks, have 4" in got["raises", "replica_mesh"]
    assert "needs 5 ranks, have 4" in got["raises", "retrieval_mesh"]
    assert "needs 6 ranks, have 4" in got["raises", "make_mesh"]


@pytest.mark.parametrize("budget", [INT32_MAX, 300])
def test_partitioned_ir_on_a_2x4_context_matches_reference(ir_run, budget):
    """Queries over ``data``, sub-indexes over ``model``: the stable broker
    merge after the gather, ties included (every document is in the
    corpus twice), and the ranges summed over the mesh, bitwise the
    reference's one-device step."""
    got, want = ir_run
    gv, gi, gr = got["ir", budget]
    wv, wi, wr = want["ir", budget]
    assert gv.dtype == np.int32 and gi.dtype == np.int32
    assert gv.tolist() == wv.tolist() and gi.tolist() == wi.tolist() and gr == wr
    ties = sum(len(row) - len(set(row)) for row in gv.tolist())
    assert ties > 0


def test_anytime_ir_arch_step_on_a_2x4_context_matches_reference(ir_run):
    got, want = ir_run
    assert got["arch"][0].tolist() == want["arch"][0].tolist()
    assert got["arch"][1].tolist() == want["arch"][1].tolist()
    assert got["arch"][2] == want["arch"][2]


def test_mesh_engines_need_a_process_group():
    """Without a group: ``use_mesh=True`` raises, ``None`` is the stacked
    path, and the meshes raise naming the process group."""
    from repro_torch.control import ReplicaGroupEngine
    from repro_torch.core.clustered_index import build_index
    from repro_torch.core.range_daat import Engine
    from repro_torch.data.synth import make_corpus
    from repro_torch.distributed import sharding as ms
    from repro_torch.serving import ShardedEngine

    assert ms.runtime() is None and ms.mesh_world_size() == 1
    idx = build_index(make_corpus(n_docs=300, n_terms=400, n_topics=2, mean_doc_len=30,
                                  seed=0), n_ranges=4, strategy="clustered")
    eng = Engine(idx, k=K, device="cpu")
    se = ShardedEngine(eng, 2)
    assert se.mesh is None and tuple(se.dix.docs.shape)[0] == 2
    assert ReplicaGroupEngine(se, 2).group_mesh is None
    for fn in (lambda: ShardedEngine(eng, 2, use_mesh=True),
               lambda: ms.retrieval_mesh(1), lambda: ms.replica_mesh(1, 1),
               lambda: ms.make_mesh((1, 1), ("data", "model"))):
        with pytest.raises(ValueError, match="process group"):
            fn()
    with pytest.raises(RuntimeError, match="rank 0"):
        with ms.driving():
            pass


def test_serve_cli_on_a_two_rank_mesh():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mode
    sharded --shards 2``: rank 0 serves on the mesh and prints the mesh
    line and the report; the other rank prints nothing of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--mode", "sharded",
         "--shards", "2", "--device", "cpu", "--n-docs", "1500", "--n-terms", "2000",
         "--strategy", "clustered", "--queries", "24", "--batch-size", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=GROUP_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("mesh: 2 gloo on cpu,cpu (2 ranks)") == 1, out
    assert out.count("sharded: 2 range shards on the mesh") == 1, out
    assert out.count("policy=sharded SLA") == 1 and "RBO" in out, out
