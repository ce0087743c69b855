"""The port's in-flight serving against the JAX package's, on the CPU.

A small seeded index is built once with the JAX package and carried into
the port with ``index_from_arrays``. The port's ``InflightServer`` (each
step one ``batched_traverse_resume``, the ``traverse`` kernel's plain
version on the CPU) is held against the reference's under one
deterministic clock: every ``ServedQuery`` field (rid, doc ids, scores,
postings, blocks, ranges, exit reason, quanta, latency), at quantum 1/2/3
and 1/3/8 slots, budgeted and unbudgeted, across mid-flight slot swaps
and a width growth. The path is integer, so every comparison is bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import clustered_index as jax_ci
from repro.core import range_daat as jax_daat
from repro.core.anytime import Reactive as JaxReactive
from repro.data.synth import make_corpus, make_query_log
from repro.serving import batch_engine as jax_batch_engine
from repro.serving import bucketing as jax_bucketing
from repro.serving import inflight as jax_inflight
from repro.serving import microbatch as jax_microbatch
from repro.serving import sharded as jax_sharded
from repro_torch.core import clustered_index, range_daat
from repro_torch.core.anytime import Reactive
from repro_torch.launch import serve
from repro_torch.serving import batch_engine, bucketing, inflight, microbatch, sharded

INT32_MAX = 2**31 - 1
K = 5
FIELDS = ("doc_ids", "scores", "ranges_processed", "postings", "blocks", "exit_safe",
          "exit_budget")


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
    """A 6-range index, and a stream of plain queries with a 1-term stub
    and, late in the stream, a fat union query that widens the slots."""
    corpus = make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=10)
    jidx = jax_ci.build_index(corpus, n_ranges=6, strategy="clustered")
    log = make_query_log(corpus, n_queries=14, seed=11)
    plain = [log.terms[i] for i in range(log.n_queries)]
    stripped = [q[q >= 0] for q in plain]
    fat = np.unique(np.concatenate(stripped + [np.arange(80, dtype=np.int32)]))
    stream = plain[:7] + [stripped[0][:1]] + plain[7:11] + [fat] + plain[11:]
    return jidx, _cross(jidx), stream


def _engines(setup, impact_dtype="int8", docs_format="packed"):
    jidx, pidx = setup[:2]
    je = jax_daat.Engine(jidx, k=K, impl="xla", interpret=True, impact_dtype=impact_dtype,
                         docs_format=docs_format)
    pe = range_daat.Engine(pidx, k=K, device="cpu", impact_dtype=impact_dtype,
                           docs_format=docs_format)
    return je, pe


class _Clock:
    """Deterministic: every reading advances 1.5 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.0015
        return self.t


def _servers(setup, n_slots, quantum, budgeter_fn, impact_dtype="int8",
             docs_format="packed"):
    """The port's and the reference's servers, each with its own clock and a
    budgeter from ``budgeter_fn(microbatch module, Reactive class)``."""
    je, pe = _engines(setup, impact_dtype, docs_format)
    out = []
    for inf, be, bkt, mb, eng, pol in (
        (inflight, batch_engine, bucketing, microbatch, pe, Reactive),
        (jax_inflight, jax_batch_engine, jax_bucketing, jax_microbatch, je, JaxReactive),
    ):
        out.append(inf.InflightServer(
            be.BatchEngine(eng, bkt.BucketSpec(max_batch=4)), budgeter_fn(mb, pol),
            n_slots=n_slots, quantum=quantum, clock=_Clock()))
    return out


def _assert_served_equal(got, want, ctx):
    assert len(got) == len(want), ctx
    for g, w in zip(got, want):
        c = f"{ctx} rid {w.rid}"
        assert (g.rid, g.latency_ms, g.batch_size, g.quanta) == (
            w.rid, w.latency_ms, w.batch_size, w.quanta), c
        for name in FIELDS:
            a, b = getattr(g.result, name), getattr(w.result, name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.tolist() == b.tolist(), f"{c}: {name}"
            else:
                assert type(a) is type(b) and a == b, f"{c}: {name} {a} != {b}"
        assert g.result.exit_reason == w.result.exit_reason, c
        assert microbatch.result_exit_reason(g.result) == \
            jax_microbatch.result_exit_reason(w.result)


def _sla(sla_ms):
    def make(mb, pol):
        return mb.SlaBudgeter(sla_ms=sla_ms, policy=pol(alpha=1.0, beta=1.5, q=0.01),
                              rate=40.0)
    return make


@pytest.mark.parametrize("quantum", [1, 2, 3])
@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_inflight_server_matches_reference(setup, n_slots, quantum):
    """Unbudgeted, then under a tight SLA whose budgets move every step:
    every ServedQuery equal, the steps, shapes and budgeter state too."""
    stream = setup[2]
    for label, sla in (("unbudgeted", float("inf")), ("budgeted", 2.5)):
        ps, js = _servers(setup, n_slots, quantum, _sla(sla))
        got, want = ps.replay(stream), js.replay(stream)
        ctx = f"slots={n_slots} quantum={quantum} {label}"
        _assert_served_equal(got, want, ctx)
        assert sorted(s.rid for s in got) == list(range(len(stream))), ctx
        assert (ps.steps_run, ps.admissions, ps.compiled_shapes) == (
            js.steps_run, js.admissions, js.compiled_shapes), ctx
        assert ps.budgeter.rate == js.budgeter.rate, ctx
        assert ps.budgeter.policy.alpha == js.budgeter.policy.alpha, ctx
        assert ps.pending == js.pending == 0 and ps.active == js.active == 0
        if label == "budgeted":
            assert "budget" in {s.result.exit_reason for s in got}, ctx
        # The width growth: the fat query widened the slots mid-stream.
        assert len({w for _, w in ps.compiled_shapes}) == 2, ctx


def test_slot_swap_mid_flight_and_width_growth(setup):
    """Queries admit into freed slots while others are still in flight, and
    the fat query's admission widens the tables of live lanes; each served
    query equals the port's own Engine.traverse under its budget."""
    ps, js = _servers(setup, 3, 1, _sla(25.0))
    admitted, budgets = [], {}
    real = ps._admit

    def spy(lane, rid, plan, t_enq):
        admitted.append((ps.steps_run, ps.active))
        real(lane, rid, plan, t_enq)
        budgets[rid] = int(ps.buffers.back.budget[lane])

    ps._admit = spy
    for q in setup[2]:
        ps.submit(q)
        js.submit(q)
    got, want, swapped = [], [], False
    while ps.pending or ps.active:
        done = ps.step()
        if done and ps.active > 0:
            swapped = True  # a slot retired while a batchmate kept flying
        got.extend(done)
        want.extend(js.step())
    assert not (js.pending or js.active)
    assert swapped
    assert any(step > 0 and active > 0 for step, active in admitted)
    _assert_served_equal(got, want, "swap")
    widths = sorted({w for _, w in ps.compiled_shapes})
    assert len(widths) == 2 and ps.buffers.front.width == widths[-1]
    eng = ps.engine
    assert len(set(budgets.values())) > 1  # the budgets moved
    for s in got:
        assert s.quanta >= 1
        one = eng.traverse(eng.plan(setup[2][s.rid]), budget_postings=budgets[s.rid])
        ids, vals = eng.topk_docs(one.state)
        assert (s.result.doc_ids.tolist(), s.result.scores.tolist(),
                s.result.ranges_processed, s.result.postings, s.result.blocks,
                s.result.exit_safe, s.result.exit_budget) == (
            ids.tolist(), vals.tolist(), one.ranges_processed, int(one.state.postings),
            int(one.state.blocks), one.exit_safe, one.exit_budget), s.rid


def test_server_matches_single_traversals_under_fixed_budgets(setup):
    """The bitwise-resume invariant on the port alone: quantum 2, fixed
    budgets per admission, each query equal to one Engine.traverse."""
    _, pe = _engines(setup, "int32", "int32")

    class Fixed(microbatch.SlaBudgeter):
        def budgets(self, n, plans=None):
            return np.full(n, 260, np.int32)

    for budget_cls, cap in ((Fixed, 260), (None, INT32_MAX)):
        budgeter = budget_cls(sla_ms=1.0) if budget_cls else microbatch.SlaBudgeter(
            sla_ms=float("inf"))
        server = inflight.InflightServer(batch_engine.BatchEngine(pe), budgeter,
                                         n_slots=4, quantum=2)
        served = server.replay(setup[2])
        assert len(served) == len(setup[2])
        for s in served:
            one = pe.traverse(pe.plan(setup[2][s.rid]), budget_postings=cap)
            ids, vals = pe.topk_docs(one.state)
            assert s.result.doc_ids.tolist() == ids.tolist(), s.rid
            assert s.result.scores.tolist() == vals.tolist(), s.rid
            assert (s.result.ranges_processed, s.result.postings, s.result.blocks,
                    s.result.exit_safe, s.result.exit_budget) == (
                one.ranges_processed, int(one.state.postings), int(one.state.blocks),
                one.exit_safe, one.exit_budget), s.rid


def test_inflight_step_is_one_upload_and_one_read(setup, monkeypatch):
    """A step stages tables, caps and carry in one upload and reads the
    [n_slots, 2k+5] carry back in one copy of the launch's buffer."""
    _, pe = _engines(setup)
    server = inflight.InflightServer(batch_engine.BatchEngine(pe),
                                     microbatch.SlaBudgeter(sla_ms=float("inf")),
                                     n_slots=3, quantum=1)
    uploads, reads = [], []
    real_upload, real_read = range_daat.upload_int32, range_daat.carry_to_host

    def upload(arrays, device):
        uploads.append(sum(not isinstance(a, torch.Tensor) for a in arrays))
        return real_upload(arrays, device)

    def read(carry):
        base = carry.i._base
        reads.append(base is not None and tuple(base.shape) == (3, 2 * K + 5))
        return real_read(carry)

    monkeypatch.setattr(range_daat, "upload_int32", upload)
    monkeypatch.setattr(inflight, "carry_to_host", read)
    served = server.replay(setup[2][:5])
    assert len(served) == 5
    assert uploads == [7] * server.steps_run and reads == [True] * server.steps_run
    # The host carry is writable and aliases no device buffer.
    c = server.carry
    assert all(isinstance(x, np.ndarray) and x.flags.writeable
               for x in (c.i, c.state.vals, c.state.ids, c.exit_safe, c.exit_budget))
    assert c.i.dtype == np.int32 and c.exit_safe.dtype == bool
    assert c.exit_budget.all()  # every slot parked again


def test_carry_to_host_reads_any_carry():
    k, n = 3, 4
    host = range_daat.batched_init_carry(n, k, parked=True)
    again = range_daat.carry_to_host(host)
    assert np.array_equal(range_daat.carry_buffer(again), range_daat.carry_buffer(host))
    buf = torch.arange(n * (2 * k + 5), dtype=torch.int32).view(n, 2 * k + 5) % 5
    buf[:, 2 * k + 3:] %= 2  # the flags are 0 or 1
    dev = range_daat.carry_from_buffer(buf, k)
    got = range_daat.carry_to_host(dev)
    assert np.array_equal(range_daat.carry_buffer(got), buf.numpy())
    got.i[0] = 99  # a copy: the device buffer is untouched
    assert int(buf[0, 2 * k + 2]) != 99
    stacked = range_daat.TraverseCarry(i=dev.i.clone(), state=dev.state,
                                       exit_safe=dev.exit_safe, exit_budget=dev.exit_budget)
    assert np.array_equal(range_daat.carry_buffer(range_daat.carry_to_host(stacked)),
                          buf.numpy())


def test_inflight_with_sharded_budgeter_matches_reference(setup):
    """The 2-D branch of _admission_budget: one engine serves the sum of a
    ShardedSlaBudgeter's per-shard caps (boundsum mode)."""
    je, pe = _engines(setup)
    jse = jax_sharded.ShardedEngine(je, 3, use_mesh=False)
    pse = sharded.ShardedEngine(pe, 3)

    def make(mb, pol):
        se = pse if mb is microbatch else jse
        return mb.ShardedSlaBudgeter(sla_ms=3.0, policy=pol(alpha=1.0, beta=1.5, q=0.01),
                                     rate=30.0, n_shards=3, mode="boundsum",
                                     shard_mass=se.query_shard_mass)

    ps, js = _servers(setup, 4, 2, make)
    _assert_served_equal(ps.replay(setup[2]), js.replay(setup[2]), "sharded budgeter")
    assert ps.budgeter.rates.tolist() == js.budgeter.rates.tolist()
    assert ps.budgeter.policy.alpha == js.budgeter.policy.alpha


def test_inflight_server_checks(setup):
    _, pe = _engines(setup)
    be = batch_engine.BatchEngine(pe)
    for kw, msg in ((dict(n_slots=0), "n_slots"), (dict(quantum=0), "quantum")):
        with pytest.raises(ValueError, match=msg):
            inflight.InflightServer(be, microbatch.SlaBudgeter(sla_ms=1.0), **kw)
    server = inflight.InflightServer(be, microbatch.SlaBudgeter(sla_ms=1.0), n_slots=2)
    assert server.step() == [] and server.steps_run == 0
    assert server.run_until_idle() == []
    server.submit(setup[2][0])
    with pytest.raises(RuntimeError, match="still busy"):
        server.run_until_idle(max_steps=1)


def test_serve_cli_inflight_mode_on_cpu(setup, monkeypatch, capsys):
    monkeypatch.setattr(serve, "build_preset", lambda *a, **k: (None, setup[1]))
    queries = setup[2][:8]

    class Log:
        terms = np.stack([np.pad(q[q >= 0], (0, 8 - (q >= 0).sum()),
                                 constant_values=-1)[:8] for q in queries])
        n_queries = len(queries)

    monkeypatch.setattr(serve, "make_query_log", lambda *a, **k: Log)
    serve.main(["--device", "cpu", "--mode", "inflight", "--batch-size", "3",
                "--quantum", "2", "--queries", str(len(queries)), "--k", str(K)])
    out = capsys.readouterr().out
    assert "mode=inflight" in out and "q/s" in out and "RBO" in out
    assert "slots=3, quantum=2" in out and "steps, shapes" in out
