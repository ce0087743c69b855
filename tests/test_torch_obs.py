"""The port's telemetry (``repro_torch.obs`` and its hooks) against the reference's.

Follows the reference's ``tests/test_obs.py``: the metrics, histogram,
sampling, tracer/sink, clock, export, report/slo/watch CLIs, detectors and
profiler classification of the port's copy; and the contracts of its
hooks on the port's engines, servers and ``ControlPlane`` (on the CPU):

  * **results neutrality** — serving with full instrumentation (metrics,
    tracing at sample rate 1.0 to a JSONL sink, profiler) is bitwise
    identical to serving with ``NOOP``, in the four modes (host, batch,
    in-flight, sharded);
  * **exit-reason conservation** at every layer;
  * **the reference's counters** — under one ``FakeClock`` and the same
    queries, every metric that does not read the clock equals the
    reference's instrumented run, per mode;
  * **compiles** — the port's launchers count loaded CUDA libraries, not
    XLA programs, so a dispatch compiles once per process on the card and
    never on the CPU, where the reference compiles once per bucket; a
    recompile stays 0 over the bucket ladder in both;
  * **the control plane** — the reference's four ``ControlPlane`` cases:
    health transitions and degraded serving in the counters (equal to the
    reference's plane under one ``FakeClock``), every metric's help, a
    planted shard skew arming a reshard through the drift monitor's alert,
    and an SLO burn marking the plane degraded;
  * **OBSGUARD** — every telemetry call in the port's ``core``,
    ``serving`` and ``control`` sits behind an ``enabled`` (or ``is not
    None``) guard, by the reference's own analyzer.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from differential import assert_exit_reason_conservation
from repro.core import clustered_index as ref_ci
from repro.core import range_daat as ref_daat
from repro.data.synth import make_corpus, make_query_log
from repro.obs import FakeClock as RefFakeClock
from repro.obs import Instrumentation as RefInstrumentation
from repro.serving import batch_engine as ref_batch
from repro.serving import bucketing as ref_bucketing
from repro.serving import inflight as ref_inflight
from repro.serving import microbatch as ref_microbatch
from repro.serving import sharded as ref_sharded
from repro_torch.core.clustered_index import build_index
from repro_torch.core.range_daat import Engine, exit_reason
from repro_torch.kernels.range_scorer import kernel as scorer_kernel
from repro_torch.obs import (
    N_BUCKETS,
    NOOP,
    FakeClock,
    Instrumentation,
    MetricsRegistry,
    Tracer,
    TraceSink,
    json_snapshot,
    prometheus_text,
    read_traces,
    render,
    summarize,
)
from repro_torch.obs.metrics import BUCKET_EDGES, bucket_index
from repro_torch.obs.trace import sampled
from repro_torch.serving import (
    BatchEngine,
    BucketSpec,
    InflightServer,
    MicroBatchServer,
    ShardedBatchEngine,
    ShardedEngine,
    ShardedSlaBudgeter,
    SlaBudgeter,
    result_exit_reason,
)
from repro_torch.serving import batch_engine as port_batch

ROOT = Path(__file__).resolve().parents[1]
MODES = ("host", "batch", "inflight", "sharded")
# Metrics whose values read the clock (latencies, rates learned from time)
# or the device (byte gauges): left out of the cross-package comparison.
CLOCK_METRICS = {"latency_ms", "batch_ms", "step_ms", "budgeter_feedback_ms",
                 "budgeter_rate", "budgeter_shard_rate", "hbm_bytes",
                 "hbm_total_bytes"}


def _small_setup(seed: int, n_ranges: int, k: int = 5, n_queries: int = 12):
    corpus = make_corpus(
        n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=seed
    )
    idx = build_index(corpus, n_ranges=n_ranges, strategy="clustered")
    eng = Engine(idx, k=k, device="cpu")
    log = make_query_log(corpus, n_queries=n_queries, seed=seed + 1)
    return eng, [log.terms[i] for i in range(log.n_queries)]


# --------------------------------------------------------------------------
# metrics substrate
# --------------------------------------------------------------------------


def test_bucket_index_edges():
    assert bucket_index(-3.0) == 0
    assert bucket_index(0.0) == 0
    assert bucket_index(0.9) == 0
    assert bucket_index(1.0) == 1
    assert bucket_index(1.9) == 1
    assert bucket_index(2.0) == 2
    assert bucket_index(3.0) == 2
    assert bucket_index(4.0) == 3
    assert bucket_index(2.0**62) == N_BUCKETS - 1
    assert bucket_index(float(2**200)) == N_BUCKETS - 1
    assert BUCKET_EDGES[-1] == float("inf")


def test_counter_gauge_label_series():
    reg = MetricsRegistry()
    c = reg.counter("served")
    c.inc(reason="safe")
    c.inc(2.0, reason="budget")
    c.inc(reason="safe")
    assert c.value(reason="safe") == 2.0
    assert c.value(reason="budget") == 2.0
    assert c.value(reason="down") == 0.0
    assert c.total() == 4.0
    g = reg.gauge("alpha")
    g.set(1.5)
    g.set(2.5)
    assert g.value() == 2.5
    assert reg.counter("served") is c
    with pytest.raises(TypeError):
        reg.gauge("served")


def test_histogram_percentiles_one_octave():
    reg = MetricsRegistry()
    h = reg.histogram("latency_ms")
    values = [0.4, 1.5, 3.0, 3.0, 6.0, 12.0, 100.0, 900.0]
    for v in values:
        h.observe(v)
    assert h.count() == len(values)
    assert h.mean() == pytest.approx(float(np.mean(values)))
    for p in (50.0, 95.0, 99.0):
        got = h.percentile(p)
        true = float(np.percentile(values, p))
        assert true / 2.0 <= got <= true * 2.0 + 1.0, (p, got, true)
    snap = h.snapshot()["samples"][""]
    assert snap["count"] == len(values)
    assert sum(snap["buckets"].values()) == len(values)


def test_histogram_overflow_bucket_reports_floor():
    h = MetricsRegistry().histogram("huge")
    h.observe(float(2**100))
    assert h.percentile(99.0) == 2.0 ** (N_BUCKETS - 2)


# --------------------------------------------------------------------------
# tracing substrate
# --------------------------------------------------------------------------


def test_sampling_is_deterministic_and_calibrated():
    from repro.obs.trace import sampled as ref_sampled

    assert all(sampled(r, 1.0) for r in range(100))
    assert not any(sampled(r, 0.0) for r in range(100))
    hits = [sampled(r, 0.25) for r in range(4000)]
    assert hits == [sampled(r, 0.25) for r in range(4000)]
    assert hits == [ref_sampled(r, 0.25) for r in range(4000)]
    assert 0.15 < np.mean(hits) < 0.35


def test_tracer_ring_and_sink_roundtrip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = Tracer(sample_rate=1.0, ring=4, sink=TraceSink(path))
    for rid in range(6):
        tr.begin(rid)
        t = tr.get(rid)
        t.span("queue", 0.0, 0.001, depth=rid)
        t.attrs["exit_reason"] = "safe"
        tr.end(rid)
    tr.close()
    assert len(tr.ring) == 4
    assert tr.started == 6 and tr.finished == 6
    recs = read_traces(path)
    assert [r["rid"] for r in recs] == list(range(6))
    assert recs[0]["spans"][0]["name"] == "queue"
    assert recs[0]["exit_reason"] == "safe"


def test_read_traces_skips_torn_tail_only(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = Tracer(sample_rate=1.0, sink=TraceSink(path))
    for rid in range(3):
        tr.begin(rid)
        tr.end(rid)
    tr.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"rid": 3, "torn')
    assert [r["rid"] for r in read_traces(path)] == [0, 1, 2]
    tr2 = Tracer(sample_rate=1.0, sink=TraceSink(path))
    tr2.begin(7)
    tr2.end(7)
    tr2.close()
    assert [r["rid"] for r in read_traces(path)] == [0, 1, 2, 7]
    lines = open(path, encoding="utf-8").read().splitlines()
    lines.insert(1, "{broken")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError):
        read_traces(path)


def test_fake_clock_is_shared_and_deterministic():
    clock = FakeClock(dt=0.5, start=10.0)
    assert clock() == 10.5
    assert clock() == 11.0
    clock.advance(4.0)
    assert clock() == 15.5


# --------------------------------------------------------------------------
# export + report
# --------------------------------------------------------------------------


def test_prometheus_exposition_shape():
    reg = MetricsRegistry()
    reg.counter("served", "queries served").inc(3, server="micro", reason="safe")
    reg.gauge("alpha").set(1.25)
    h = reg.histogram("latency_ms")
    for v in (0.5, 3.0, 70.0):
        h.observe(v, server="micro")
    text = prometheus_text(reg)
    assert '# TYPE served counter' in text
    assert 'served_total{reason="safe",server="micro"} 3' in text
    assert "alpha 1.25" in text
    assert '# TYPE latency_ms histogram' in text
    assert 'latency_ms_bucket{server="micro",le="+Inf"} 3' in text
    assert 'latency_ms_count{server="micro"} 3' in text
    les = [
        (float(ln.split('le="')[1].split('"')[0].replace("+Inf", "inf")),
         int(ln.rsplit(" ", 1)[1]))
        for ln in text.splitlines() if ln.startswith("latency_ms_bucket")
    ]
    assert les == sorted(les) and les[-1][1] == 3
    json.loads(json_snapshot(reg))


def test_report_summary_math():
    recs = []
    for i in range(10):
        lat = 2.0 + i
        recs.append({
            "rid": i,
            "exit_reason": "safe" if i % 2 == 0 else "budget",
            "latency_ms": lat,
            "sla_ms": 8.0,
            "quanta": 1 + i % 3,
            "fidelity_bound": 0 if i < 8 else 5,
            "exact": i < 8,
            "spans": [
                {"name": "queue", "t0_ms": 0.0, "dur_ms": 1.0},
                {"name": "service", "t0_ms": 1.0, "dur_ms": lat - 1.0},
            ],
        })
    s = summarize(recs, sla_ms=8.0)
    assert s["queries"] == 10
    assert s["sla"]["judged"] == 10
    assert s["sla"]["met"] == 7
    assert s["sla"]["compliance"] == pytest.approx(0.7)
    assert s["exit_reasons"] == {"budget": 5, "safe": 5}
    assert s["queue_wait_ms"]["p50"] == pytest.approx(1.0)
    assert 0.0 < s["queue_share"] < 0.5
    assert s["fidelity_bound"]["nonzero"] == 2
    assert s["inexact"] == 2
    text = render(s)
    assert "compliance" in text and "exit reasons" in text


def test_report_cli(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    path = str(tmp_path / "t.jsonl")
    tr = Tracer(sample_rate=1.0, sink=TraceSink(path))
    for rid in range(4):
        tr.begin(rid)
        t = tr.get(rid)
        t.span("queue", 0.0, 0.001)
        t.attrs.update(exit_reason="safe", latency_ms=3.0)
        tr.end(rid)
    tr.close()
    assert main(["report", path, "--sla-ms", "10"]) == 0
    out = capsys.readouterr().out
    assert "queries" in out and "4" in out
    assert main(["report", path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["queries"] == 4
    assert main(["report", str(tmp_path / "missing.jsonl")]) == 1


def test_cdf_below_bucket_edges():
    from repro_torch.obs.slo import cdf_below

    buckets = [0] * N_BUCKETS
    buckets[bucket_index(5.0)] = 8
    assert cdf_below(buckets, 8.0) == pytest.approx(8.0)
    assert cdf_below(buckets, 4.0) == pytest.approx(0.0)
    assert cdf_below(buckets, 6.0) == pytest.approx(4.0)
    assert cdf_below(buckets, -1.0) == 0.0
    over = [0] * N_BUCKETS
    over[N_BUCKETS - 1] = 3
    assert cdf_below(over, 1e18) == 0.0
    assert cdf_below(over, float("inf")) == pytest.approx(3.0)


def test_slo_tracker_windowed_burn_hand_computed():
    from repro_torch.obs.slo import HistogramBelow, SloSpec, SloTracker

    obs = Instrumentation()
    tracker = SloTracker(
        obs,
        [SloSpec("lat", 0.9, HistogramBelow("latency_ms", 8.0))],
        windows={"10s": 10.0, "100s": 100.0},
    )
    tracker.sample(now=0.0)
    for _ in range(6):
        obs.observe("latency_ms", 3.0)
    tracker.sample(now=50.0)
    for _ in range(4):
        obs.observe("latency_ms", 100.0)
    tracker.sample(now=100.0)
    rep = tracker.evaluate(now=100.0)["lat"]
    w10, w100 = rep["windows"]["10s"], rep["windows"]["100s"]
    assert w10["total"] == pytest.approx(4.0)
    assert w10["attainment"] == pytest.approx(0.0)
    assert w10["burn"] == pytest.approx(10.0)
    assert w100["total"] == pytest.approx(10.0)
    assert w100["attainment"] == pytest.approx(0.6)
    assert w100["burn"] == pytest.approx(4.0)
    assert rep["budget_remaining"] == 0.0
    g = obs.metrics.gauge("slo_burn_rate")
    assert g.value(slo="lat", window="10s") == pytest.approx(10.0)
    assert obs.metrics.gauge("slo_state").value(slo="lat") == 0


def test_ewma_detector_fire_clear_hysteresis():
    from repro_torch.obs.detect import EwmaDetector

    det = EwmaDetector(
        "sig", patience=3, clear_patience=2, min_samples=4, direction="above"
    )
    clock = FakeClock(dt=1.0)
    for _ in range(6):
        assert det.update(10.0, clock()) is None
    assert det.mean == pytest.approx(10.0)
    got = [det.update(100.0, clock()) for _ in range(3)]
    assert got[0] is None and got[1] is None
    assert got[2] is not None and got[2].state == "fire"
    assert det.firing
    assert det.mean == pytest.approx(10.0)
    back = [det.update(10.0, clock()) for _ in range(2)]
    assert back[0] is None
    assert back[1] is not None and back[1].state == "clear"
    assert not det.firing
    assert det.update(100.0, clock()) is None
    assert det.mean < 20.0


def test_threshold_detector_and_monitor_emit_to_sink(tmp_path):
    from repro_torch.obs.detect import DriftMonitor, ThresholdDetector

    path = str(tmp_path / "t.jsonl")
    obs = Instrumentation.make(sample_rate=1.0, trace_path=path, clock=FakeClock(dt=1.0))
    mon = DriftMonitor(obs)
    sig = {"v": 0.5}
    mon.add(ThresholdDetector("skew", 2.0, patience=2, clear_patience=1),
            lambda reg: sig["v"])
    seen = []
    mon.subscribe(lambda ev: seen.append((ev.detector, ev.state)))
    assert mon.poll() == []
    sig["v"] = 3.0
    assert mon.poll() == []
    fired = mon.poll()
    assert [e.state for e in fired] == ["fire"]
    assert mon.firing() == ["skew"]
    sig["v"] = 1.0
    assert [e.state for e in mon.poll()] == ["clear"]
    assert seen == [("skew", "fire"), ("skew", "clear")]
    assert obs.metrics.counter("alerts").value(detector="skew", state="fire") == 1
    obs.close()
    recs = read_traces(path)
    alerts = [r for r in recs if r.get("kind") == "alert"]
    assert [a["state"] for a in alerts] == ["fire", "clear"]
    assert summarize(recs)["queries"] == 0
    assert summarize(recs)["alerts"] == 2


def test_slo_cli(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    path = str(tmp_path / "t.jsonl")
    tr = Tracer(sample_rate=1.0, sink=TraceSink(path))
    clock = FakeClock(dt=0.01)
    for rid in range(8):
        tr.begin(rid)
        t = tr.get(rid)
        t0 = clock()
        lat = 2.0 if rid < 6 else 50.0
        t.span("service", t0, t0 + lat / 1e3)
        t.attrs.update(exit_reason="safe", latency_ms=lat, sla_ms=10.0, exact=True)
        tr.end(rid)
    tr.close()
    assert main(["slo", path]) == 0
    out = capsys.readouterr().out
    assert "latency_sla" in out and "burn" in out
    assert main(["slo", path, "--json", "--windows", "w=1"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["queries"] == 8
    assert rep["sla_ms"] == 10.0
    assert rep["slos"]["latency_sla"]["attainment"] == pytest.approx(0.75)
    assert main(["slo", str(tmp_path / "missing.jsonl")]) == 1


def test_watch_cli(tmp_path, capsys):
    from repro_torch.obs import write_snapshot
    from repro_torch.obs.__main__ import main

    obs = Instrumentation.make(sample_rate=1.0)
    obs.count("served_queries", 5, server="micro", reason="safe")
    obs.observe("latency_ms", 3.0, server="micro")
    obs.gauge("queue_depth", 2.0, server="micro")
    snap = str(tmp_path / "snap.json")
    write_snapshot(
        snap, obs.metrics,
        alerts=[{"detector": "skew", "state": "fire", "value": 2.5, "t_ms": 1.0}],
        t=12.5,
    )
    assert main(["watch", snap, "--once"]) == 0
    out = capsys.readouterr().out
    assert "served_queries" in out and "latency_ms" in out
    assert "skew" in out
    assert main(["watch", str(tmp_path / "missing.json"), "--once"]) == 1


# --------------------------------------------------------------------------
# results neutrality: instrumentation changes nothing served
# --------------------------------------------------------------------------


def _observables(mode, out):
    """Every field a mode serves, as plain values in query order."""
    if mode == "host":
        return out
    rows = []
    for s in sorted(out, key=lambda s: s.rid):
        r = s.result
        rows.append((s.rid, s.quanta, [np.asarray(v).tolist() if isinstance(
            v, np.ndarray) else v for v in r]))
    return rows


def _serve(mode, eng, queries, obs, cap=None, clock=None):
    """One mode's run over the port's engines, instrumented by ``obs``."""
    if mode == "host":
        e = Engine(eng.index, k=eng.k, device="cpu", obs=obs)
        out = []
        for i, q in enumerate(queries):
            res = e.traverse(e.plan(q), budget_postings=cap or 2**31 - 1)
            out.append((e.topk_docs(res.state)[0].tolist(), res.ranges_processed,
                        res.exit_safe, res.exit_budget, res.state.postings.tolist()))
        return out
    if mode == "sharded":
        beng = ShardedBatchEngine(ShardedEngine(eng, 2, obs=obs), BucketSpec(max_batch=4))
        bud = ShardedSlaBudgeter(sla_ms=float("inf"), n_shards=2, obs=obs)
    else:
        beng = BatchEngine(eng, BucketSpec(max_batch=4), obs=obs)
        bud = SlaBudgeter(sla_ms=float("inf"), obs=obs)
    if cap is not None:
        bud.budgets = lambda n, plans=None: np.full(
            (n, 2) if mode == "sharded" else n, cap, np.int32)
    if mode == "inflight":
        srv = InflightServer(beng, bud, n_slots=4, quantum=2, obs=obs, clock=clock)
        for q in queries:
            srv.submit(q)
        return srv.run_until_idle()
    srv = MicroBatchServer(beng, bud, max_batch=4, obs=obs, clock=clock)
    for q in queries:
        srv.submit(q)
    served = []
    while srv.pending:
        served.extend(srv.drain_once())
    return served


@pytest.fixture(scope="module")
def setup():
    return _small_setup(seed=3, n_ranges=6)


@pytest.mark.parametrize("mode", MODES)
def test_instrumented_serving_is_bitwise_identical(tmp_path, setup, mode):
    eng, queries = setup
    for cap in (None, 150, 800):  # unbounded and budget-exit paths pinned
        path = str(tmp_path / f"{mode}-{cap}.jsonl")
        obs = Instrumentation.make(sample_rate=1.0, trace_path=path, profile=True)
        instrumented = _serve(mode, eng, queries, obs, cap)
        obs.close()
        baseline = _serve(mode, eng, queries, NOOP, cap)
        assert _observables(mode, instrumented) == _observables(mode, baseline)
        if mode == "host":
            continue
        recs = read_traces(path)
        assert sorted(r["rid"] for r in recs) == sorted(s.rid for s in baseline)
        for r in recs:
            assert r["exit_reason"] in ("safe", "budget", "exhausted", "down")
            assert any(sp["name"] == "queue" for sp in r["spans"])
            assert any(sp["name"] in ("service", "dispatch") for sp in r["spans"])


def _ref_serve(mode, idx, queries, obs, cap, clock):
    """The reference's run of ``_serve``."""
    eng = ref_daat.Engine(idx, k=5, obs=obs if mode == "host" else None)
    if mode == "host":
        for q in queries:
            eng.traverse(eng.plan(q), budget_postings=cap or 2**31 - 1)
        return
    spec = ref_bucketing.BucketSpec(max_batch=4)
    if mode == "sharded":
        beng = ref_sharded.ShardedBatchEngine(
            ref_sharded.ShardedEngine(eng, 2, use_mesh=False, obs=obs), spec)
        bud = ref_microbatch.ShardedSlaBudgeter(sla_ms=float("inf"), n_shards=2,
                                                obs=obs)
    else:
        beng = ref_batch.BatchEngine(eng, spec, obs=obs)
        bud = ref_microbatch.SlaBudgeter(sla_ms=float("inf"), obs=obs)
    if cap is not None:
        bud.budgets = lambda n, plans=None: np.full(
            (n, 2) if mode == "sharded" else n, cap, np.int32)
    if mode == "inflight":
        ref_inflight.InflightServer(beng, bud, n_slots=4, quantum=2, obs=obs,
                                    clock=clock).replay(queries)
        return
    srv = ref_microbatch.MicroBatchServer(beng, bud, max_batch=4, obs=obs, clock=clock)
    for q in queries:
        srv.submit(q)
    while srv.pending:
        srv.drain_once()


@pytest.mark.parametrize("mode", MODES)
def test_counters_equal_the_references_under_one_fake_clock(setup, mode):
    """Under one FakeClock per package and the same queries, the port's
    instrumented run records every clock-free metric the reference's does,
    sample for sample."""
    eng, queries = setup
    ref_idx = ref_ci.build_index(
        make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=3),
        n_ranges=6, strategy="clustered")
    assert ref_idx.fingerprint() == eng.index.fingerprint()
    for cap in (None, 60):
        clock, ref_clock = FakeClock(dt=0.001), RefFakeClock(dt=0.001)
        obs = Instrumentation.make(sample_rate=1.0, clock=clock)
        ref_obs = RefInstrumentation.make(sample_rate=1.0, clock=ref_clock)
        _serve(mode, eng, queries, obs, cap, clock=clock)
        _ref_serve(mode, ref_idx, queries, ref_obs, cap, ref_clock)
        got = {n: m for n, m in obs.snapshot().items() if n not in CLOCK_METRICS}
        want = {n: m for n, m in ref_obs.snapshot().items() if n not in CLOCK_METRICS}
        assert sorted(got) == sorted(want)
        assert got == want
        key = {"host": "engine_queries", "batch": "served_queries",
               "inflight": "served_queries", "sharded": "shard_exits"}[mode]
        assert obs.metrics.counter(key).total() >= len(queries)
        if cap is not None:
            assert "reason=budget" in str(got[key]["samples"])


# --------------------------------------------------------------------------
# exit-reason conservation at every layer
# --------------------------------------------------------------------------


def test_engine_exit_reason_conservation():
    eng, queries = _small_setup(seed=5, n_ranges=6)
    obs = Instrumentation()
    eng_i = Engine(eng.index, k=5, obs=obs, device="cpu")
    reasons = []
    for i, q in enumerate(queries):
        kw = {"budget_postings": 500} if i % 2 else {}
        res = eng_i.traverse(eng_i.plan(q), **kw)
        reasons.append(exit_reason(res.exit_safe, res.exit_budget))
    assert_exit_reason_conservation(obs, "engine_queries", reasons)
    assert obs.metrics.histogram("engine_postings").count() == len(queries)


def test_batch_engine_exit_reason_conservation():
    eng, queries = _small_setup(seed=6, n_ranges=6)
    obs = Instrumentation()
    beng = BatchEngine(Engine(eng.index, k=5, device="cpu"), BucketSpec(max_batch=4),
                       obs=obs)
    plans = beng.plan_many(queries)
    caps = [400 if i % 3 == 0 else None for i in range(len(plans))]
    results = beng.run_batch(plans, budget_postings=[c or 2**31 - 1 for c in caps])
    assert_exit_reason_conservation(
        obs, "batch_engine_queries", [r.exit_reason for r in results]
    )


@pytest.mark.parametrize("mode", ["micro", "inflight"])
def test_server_exit_reason_conservation(mode):
    eng, queries = _small_setup(seed=7, n_ranges=6)
    obs = Instrumentation.make(sample_rate=1.0)
    beng = BatchEngine(eng, BucketSpec(max_batch=4))
    bud = SlaBudgeter(sla_ms=float("inf"), obs=obs)
    if mode == "micro":
        srv = MicroBatchServer(beng, bud, max_batch=4, obs=obs)
        for q in queries:
            srv.submit(q)
        served = []
        while srv.pending:
            served.extend(srv.drain_once())
    else:
        srv = InflightServer(beng, bud, n_slots=4, quantum=2, obs=obs)
        for q in queries:
            srv.submit(q)
        served = srv.run_until_idle()
    assert_exit_reason_conservation(
        obs, "served_queries", [result_exit_reason(s.result) for s in served],
        server=mode,
    )
    assert obs.metrics.counter("submitted").value(server=mode) == len(queries)


def test_sharded_exit_reason_conservation_per_shard():
    eng, queries = _small_setup(seed=8, n_ranges=8)
    obs = Instrumentation()
    se = ShardedEngine(Engine(eng.index, k=5, device="cpu"), n_shards=2, use_mesh=False,
                       obs=obs)
    per_shard: dict[int, list[str]] = {0: [], 1: []}
    merged = []
    for q in queries:
        r = se.traverse(se.engine.plan(q))
        for s, reason in enumerate(r.shard_exit_reasons):
            per_shard[s].append(reason)
        merged.append(result_exit_reason(r))
    for s, reasons in per_shard.items():
        assert_exit_reason_conservation(
            obs, "shard_exits", reasons, context=f"shard {s}", shard=s
        )
    total = obs.metrics.counter("sharded_queries").total()
    assert total == len(queries) == len(merged)
    assert obs.metrics.histogram("fidelity_bound").count() == len(queries)


def test_every_registered_metric_carries_help(setup):
    """Drive every port layer through one handle: no empty help strings."""
    from repro_torch.obs.slo import SloTracker, default_serving_slos

    eng, queries = setup
    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    for mode in MODES:
        _serve(mode, eng, queries[:8], obs)
    tracker = SloTracker(obs, default_serving_slos(sla_ms=5.0))
    tracker.sample(now=0.0)
    tracker.evaluate(now=1.0)
    assert obs.metrics.missing_help() == []
    text = prometheus_text(obs.metrics)
    for name in ("latency_ms", "served_queries", "profiler_dispatches",
                 "engine_queries", "shard_exits"):
        assert f"# HELP {name}" in text


def test_unlimited_budget_sentinel_stays_out_of_histogram():
    eng, queries = _small_setup(seed=13, n_ranges=6)
    obs = Instrumentation.make(sample_rate=1.0)
    srv = InflightServer(BatchEngine(eng, BucketSpec(max_batch=4)),
                         SlaBudgeter(sla_ms=float("inf"), obs=obs), n_slots=4, obs=obs)
    for q in queries:
        srv.submit(q)
    srv.run_until_idle()
    assert obs.metrics.histogram("budget_postings").count(server="inflight") == 0
    unl = obs.metrics.counter("unlimited_admissions").value(server="inflight")
    adm = obs.metrics.counter("admissions").value(server="inflight")
    assert unl == adm == len(queries)

    obs2 = Instrumentation.make(sample_rate=1.0)
    bud = SlaBudgeter(sla_ms=float("inf"), obs=obs2)
    bud.budgets = lambda n, plans=None: np.full(n, 800, np.int32)
    srv2 = MicroBatchServer(BatchEngine(eng, BucketSpec(max_batch=4)), bud, max_batch=4,
                            obs=obs2)
    for q in queries:
        srv2.submit(q)
    while srv2.pending:
        srv2.drain_once()
    h2 = obs2.metrics.histogram("budget_postings")
    assert h2.count(server="micro") == len(queries)
    assert h2.percentile(50.0, server="micro") <= 1024.0
    assert obs2.metrics.counter("unlimited_admissions").value(server="micro") == 0


# --------------------------------------------------------------------------
# profiler: what a compile is in the port
# --------------------------------------------------------------------------


def test_profiler_compile_recompile_classification():
    from repro_torch.obs.profiler import Profiler

    obs = Instrumentation()
    prof = Profiler(obs)
    prof.record_dispatch("s", (4, 32), cache_before=0, cache_after=1)
    prof.record_dispatch("s", (4, 32), cache_before=1, cache_after=1)
    prof.record_dispatch("s", (4, 32), cache_before=1, cache_after=2)
    prof.record_dispatch("s", (8, 32), cache_before=2, cache_after=3)
    prof.record_dispatch("s", (8, 64))
    prof.record_dispatch("s", (8, 64))
    snap = prof.snapshot()["s"]
    assert snap["dispatches"] == 6
    assert snap["compiles"] == 3
    assert snap["recompiles"] == 1
    assert prof.recompiles() == 1
    assert obs.metrics.counter("profiler_recompiles").value(site="s") == 1


def _ladder(beng, plans):
    for chunk in (plans[:1], plans[:3], plans):  # batch buckets 1, 4, 4 x 3
        beng.run_batch(chunk)


def test_profiler_tracks_bucket_ladder_without_recompiles(setup, monkeypatch):
    """Across the pow2 ladder, recompiles stay 0. The compile count is not
    the reference's by design: the reference's cache grows once per
    (batch, width) program, the port's launcher once per process, when its
    CUDA library loads. On the CPU nothing loads, so no compile is counted
    and no device time is measured; a library load simulated at the first
    launch counts exactly one compile over the ladder."""
    eng, queries = setup
    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    beng = BatchEngine(eng, BucketSpec(max_batch=4), obs=obs)
    plans = beng.plan_many(queries)
    _ladder(beng, plans)
    snap = obs.profiler.snapshot()["batch_engine"]
    assert snap["recompiles"] == 0 and snap["compiles"] == 0
    assert snap["dispatches"] == beng.batches_run
    assert {tuple(s) for s in snap["shapes"]} == beng.compiled_shapes
    assert len(beng.compiled_shapes) > 1
    assert snap["device_ms"] == 0.0  # CPU: not measured
    assert snap["hbm_total_bytes"] > 0

    ref_obs = RefInstrumentation.make(sample_rate=1.0, profile=True)
    ref_eng = ref_daat.Engine(ref_ci.build_index(
        make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=3),
        n_ranges=6, strategy="clustered"), k=7)
    ref_beng = ref_batch.BatchEngine(ref_eng, ref_bucketing.BucketSpec(max_batch=4),
                                     obs=ref_obs)
    _ladder(ref_beng, ref_beng.plan_many(queries))
    ref_snap = ref_obs.profiler.snapshot()["batch_engine"]
    assert ref_snap["recompiles"] == 0
    assert ref_snap["compiles"] == len(ref_beng.compiled_shapes)
    assert ref_snap["shapes"] == snap["shapes"]

    loads = {"n": 0}
    launch = port_batch.traverse_lanes

    def loading_launch(*args, **kw):
        loads["n"] = 1
        return launch(*args, **kw)

    monkeypatch.setattr(port_batch, "traverse_lanes", loading_launch)
    monkeypatch.setattr(scorer_kernel.traverse, "_cache_size", lambda: loads["n"])
    obs2 = Instrumentation.make(sample_rate=1.0, profile=True)
    beng2 = BatchEngine(eng, BucketSpec(max_batch=4), obs=obs2)
    _ladder(beng2, plans)
    beng2.run_batch(plans)
    snap2 = obs2.profiler.snapshot()["batch_engine"]
    assert (snap2["compiles"], snap2["recompiles"]) == (1, 0)
    assert snap2["dispatches"] == beng2.batches_run


def test_launchers_count_loaded_libraries():
    """``_cache_size`` reads the range scorer's library count: 0 until the
    library is loaded in this process (never, on the CPU)."""
    from repro_torch.obs import jit_cache_size

    for fn in (scorer_kernel.traverse, scorer_kernel.range_step):
        assert jit_cache_size(fn) == scorer_kernel._LIB.programs() == 0


def test_inflight_profiler_counts_steps_without_recompiles(setup):
    eng, queries = setup
    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    srv = InflightServer(BatchEngine(eng, BucketSpec(max_batch=4)),
                         SlaBudgeter(sla_ms=float("inf"), obs=obs), n_slots=4,
                         quantum=2, obs=obs)
    srv.replay(queries)
    snap = obs.profiler.snapshot()["inflight"]
    assert snap["dispatches"] == srv.steps_run
    assert snap["recompiles"] == 0 and snap["compiles"] == 0
    assert {tuple(s) for s in snap["shapes"]} == srv.compiled_shapes


# --------------------------------------------------------------------------
# control plane instrumentation
# --------------------------------------------------------------------------


def _plane_health_run(plane, queries):
    served = plane.replay(queries, batch_size=4)
    plane.mark_down(1)
    down = plane.replay(queries[:4], batch_size=4)
    plane.mark_up(1)
    return served, down


def test_control_plane_health_and_serving_telemetry():
    """The reference's case on the port's plane, and its clock-free
    counters equal the reference plane's under one ``FakeClock`` step."""
    from repro.control import ControlPlane as RefPlane
    from repro_torch.control import ControlPlane

    eng, queries = _small_setup(seed=9, n_ranges=8)
    clock = FakeClock(dt=0.001)
    obs = Instrumentation.make(sample_rate=1.0, clock=clock)
    plane = ControlPlane(eng, n_shards=2, use_mesh=False, obs=obs)
    served, down = _plane_health_run(plane, queries)
    assert len(served) == len(queries) and len(down) == 4
    ht = obs.metrics.counter("health_transitions")
    assert ht.value(event="down", shard=1) == 1
    assert ht.value(event="up", shard=1) == 1
    assert_exit_reason_conservation(
        obs, "served_queries",
        [result_exit_reason(s.result) for s in served + down], server="micro",
    )
    assert obs.metrics.counter("sharded_exact").value(exact=False) >= 1
    assert obs.metrics.gauge("plane_available").value() == 1.0

    ref_idx = ref_ci.build_index(
        make_corpus(n_docs=900, n_terms=700, n_topics=4, mean_doc_len=50, seed=9),
        n_ranges=8, strategy="clustered")
    assert ref_idx.fingerprint() == eng.index.fingerprint()
    ref_obs = RefInstrumentation.make(sample_rate=1.0, clock=RefFakeClock(dt=0.001))
    _plane_health_run(RefPlane(ref_daat.Engine(ref_idx, k=5), n_shards=2,
                               use_mesh=False, obs=ref_obs), queries)
    got = {n: m for n, m in obs.snapshot().items() if n not in CLOCK_METRICS}
    want = {n: m for n, m in ref_obs.snapshot().items() if n not in CLOCK_METRICS}
    assert sorted(got) == sorted(want) and got == want


def test_every_plane_metric_carries_help():
    """The reference's case: the plane, an in-flight server and the SLO
    tracker through one handle, no empty help string."""
    from repro_torch.control import ControlPlane
    from repro_torch.obs.slo import SloTracker, default_serving_slos

    eng, queries = _small_setup(seed=10, n_ranges=8)
    obs = Instrumentation.make(sample_rate=1.0, profile=True)
    plane = ControlPlane(eng, n_shards=2, use_mesh=False, obs=obs)
    plane.replay(queries[:8], batch_size=4)
    srv = InflightServer(BatchEngine(eng, BucketSpec(max_batch=4)),
                         SlaBudgeter(sla_ms=float("inf"), obs=obs), n_slots=4, obs=obs)
    for q in queries[:4]:
        srv.submit(q)
    srv.run_until_idle()
    tracker = SloTracker(obs, default_serving_slos(sla_ms=5.0))
    tracker.sample(now=0.0)
    tracker.evaluate(now=1.0)
    assert obs.metrics.missing_help() == []
    text = prometheus_text(obs.metrics)
    for name in ("latency_ms", "served_queries", "profiler_dispatches", "shard_postings",
                 "plane_available"):
        assert f"# HELP {name}" in text


def test_planted_shard_skew_arms_reshard_via_alert(tmp_path):
    """Detector -> ControlPlane arming, end to end through real serving."""
    from repro_torch.control import ControlPlane
    from repro_torch.obs.detect import DriftMonitor, ShardSkewProbe, ThresholdDetector

    eng, queries = _small_setup(seed=11, n_ranges=8, n_queries=24)
    path = str(tmp_path / "trace.jsonl")
    obs = Instrumentation.make(sample_rate=1.0, trace_path=path)
    plane = ControlPlane(eng, n_shards=2, use_mesh=False, obs=obs, reshard_trigger=1.02)
    twin = ShardedEngine(Engine(eng.index, k=5, device="cpu"), n_shards=2, use_mesh=False)
    ratio = []
    for q in queries:
        p = np.asarray(twin.traverse(twin.engine.plan(q)).shard_postings, np.float64)
        ratio.append(p.max() * 2.0 / max(p.sum(), 1.0))
    hot = queries[int(np.argmax(ratio))]
    assert max(ratio) >= 1.5

    monitor = DriftMonitor(obs)
    monitor.add(ThresholdDetector("shard_skew", 1.3, patience=2), ShardSkewProbe(2))
    plane.enable_operations(monitor=monitor)
    for _ in range(16):
        plane.submit(hot)
        plane.drain_once()
    while plane.pending or plane.reshard_task is not None:
        plane.drain_once()
    assert obs.metrics.counter("alerts").value(detector="shard_skew", state="fire") >= 1
    assert plane.reshards_completed >= 1
    assert obs.metrics.counter("reshard_started").total() >= 1
    assert obs.metrics.counter("reshard_cutovers").total() == plane.reshards_completed
    assert obs.metrics.histogram("reshard_ms").count() == plane.reshards_completed
    obs.close()
    alerts = [r for r in read_traces(path) if r.get("kind") == "alert"]
    assert any(a["detector"] == "shard_skew" and a["state"] == "fire" for a in alerts)


def test_burn_rate_alert_marks_plane_degraded():
    """Impossible latency SLO -> fast burn -> degraded-SLO plane state."""
    from repro_torch.control import ControlPlane
    from repro_torch.obs.detect import DriftMonitor, ThresholdDetector, gauge_probe
    from repro_torch.obs.slo import SloTracker, default_serving_slos

    eng, queries = _small_setup(seed=14, n_ranges=8)
    obs = Instrumentation.make(sample_rate=1.0)
    plane = ControlPlane(eng, n_shards=2, use_mesh=False, obs=obs)
    tracker = SloTracker(obs, default_serving_slos(sla_ms=1e-4))
    monitor = DriftMonitor(obs)
    monitor.add(ThresholdDetector("slo_fast_burn", 14.4, patience=2),
                gauge_probe("slo_burn_rate", slo="latency_sla", window="5m"))
    plane.enable_operations(slos=tracker, monitor=monitor)
    plane.replay(queries, batch_size=4)
    assert plane.stats()["degraded_slo"] is True
    assert "slo_fast_burn" in monitor.firing()
    assert obs.metrics.gauge("plane_degraded_slo").value() == 1.0
    assert obs.metrics.gauge("slo_state").value(slo="latency_sla") == 2


# --------------------------------------------------------------------------
# OBSGUARD: every telemetry call of core, serving and control is guarded
# --------------------------------------------------------------------------


def test_port_telemetry_calls_are_guarded():
    """The port's OBSGUARD rule (``repro_torch.analysis``, DESIGN.md §15)
    over the port's ``core``, ``serving`` and ``control`` modules, each
    analyzed under a ``serving/`` path so the rule's scope covers it."""
    from repro_torch.analysis.runner import analyze_source

    files = [f for sub in ("core", "serving", "control")
             for f in sorted((ROOT / "src" / "repro_torch" / sub).glob("*.py"))]
    hooked = 0
    for path in files:
        text = path.read_text()
        hooked += text.count("obs.enabled")
        report = analyze_source(text, path=f"serving/{path.parent.name}_{path.name}")
        bad = [f for f in report.findings + report.waived if f.rule == "OBSGUARD"]
        assert bad == [], [(path.name, f.line) for f in bad]
    assert hooked >= 10
    # The rule bites: an unguarded call in a port module is found.
    report = analyze_source(
        "def f(self, x):\n    self.obs.count('served_queries')\n",
        path="serving/fixture.py")
    assert [f.rule for f in report.findings] == ["OBSGUARD"]
