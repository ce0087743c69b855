"""The harness on the CPU at a tiny size, with the kernels' plain versions."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from anytime_bench import drive
from anytime_bench.data import synth
from anytime_bench.harness import BENCH_DIR
from anytime_bench.reference import engine as ref
from anytime_bench.tests.tiny import CELLS, CONFIGS, run_tiny
from anytime_bench.yardstick import step_bytes

ROOT = os.path.dirname(BENCH_DIR)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tiny"))


def test_synth_copy_equals_the_port():
    from repro_torch.data import synth as port

    args = dict(n_docs=1500, n_terms=1200, n_topics=5, mean_doc_len=60, seed=9)
    a, b = synth.make_corpus(**args), port.make_corpus(**args)
    for f in ("doc_ptr", "doc_terms", "doc_tfs", "doc_topic"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    qa, qb = synth.make_query_log(a, 100, seed=4), port.make_query_log(b, 100, seed=4)
    assert np.array_equal(qa.terms, qb.terms) and np.array_equal(qa.lengths, qb.lengths)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_equals_the_port(name):
    """Every prefix the port's traversal can stop at, under budgets, equals the
    reference's trajectory: ids, scores, counters and the exit."""
    from repro_torch.core.clustered_index import build_index
    from repro_torch.core.range_daat import Engine
    from repro_torch.core.reorder import Arrangement
    from repro_torch.data.synth import Corpus

    cfg = CONFIGS[name]
    c = synth.make_corpus(cfg["n_docs"], cfg["n_terms"], cfg["n_ranges"], cfg["mean_doc_len"],
                          seed=cfg["collection_seed"])
    order, ends = synth.topic_partition(c)
    index = build_index(Corpus(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)}),
                        arrangement=Arrangement(order, ends, "topical"), bits=cfg["impact_bits"])
    eng = Engine(index, k=cfg["k"], device="cpu", impact_dtype=cfg["impact_dtype"],
                 docs_format=cfg["docs_format"])
    rix = ref.build_reference_index(c, order, ends, cfg["impact_bits"], 0.4, 0.9)
    assert np.array_equal(rix.imps, index.impacts) and np.array_equal(rix.docs, index.docs)
    R = index.n_ranges
    for q in synth.make_query_log(c, 30, seed=2).terms:
        tr = ref.trajectory(rix, q, cfg["k"], 1, False)
        for budget in (2**31 - 1, 200, 1500):
            res = eng.traverse(eng.plan(q), budget_postings=budget)
            n = int(res.ranges_processed)
            assert np.array_equal(res.state.ids.numpy(), tr["ids"][n])
            assert np.array_equal(res.state.vals.numpy(), tr["vals"][n])
            assert int(res.state.postings) == tr["postings"][n]
            assert int(res.state.blocks) == tr["blocks"][n]
            if res.exit_safe:
                assert n == tr["first_safe"]
            elif res.exit_budget:
                assert n < tr["first_safe"]
            else:
                assert n == R == tr["first_safe"]


def test_byte_model_equals_chip_smokes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    rng = np.random.default_rng(0)
    nb = 64
    lens = rng.integers(1, 129, nb).astype(np.int32)
    maximp = rng.integers(1, 256, nb).astype(np.int32)
    widths = rng.choice([0, 4, 8, 16, 32], nb).astype(np.int32)
    codes = np.searchsorted([0, 4, 8, 16, 32], widths).astype(np.int64)
    blk = np.r_[rng.choice(nb, 40, replace=False), -np.ones(24, np.int64)]
    rest = rng.integers(0, 300, blk.shape[0])
    for packed, imps in ((False, torch.zeros(10, dtype=torch.int8)),
                         (True, torch.zeros(10, dtype=torch.int32))):
        dix = type("Dix", (), dict(
            blk_len=torch.from_numpy(lens), blk_maximp=torch.from_numpy(maximp), impacts=imps,
            pack_dir=torch.from_numpy((codes << 27).astype(np.int32))))
        fmt = "packed" if packed else "int32"
        for theta in (0, 150, 400):
            want = chip_smoke.StepBytes(dix, fmt)(blk, rest, theta)
            got = step_bytes(blk, rest, theta, lens, maximp, widths,
                             imps.element_size(), packed)
            assert got == want


class _StallServer:
    """One query in service at a time, a fixed service time, and one step
    that stalls."""

    def __init__(self, service_s, stall_at, stall_s):
        self.queue, self.served, self.rid = [], 0, 0
        self.service_s, self.stall_at, self.stall_s = service_s, stall_at, stall_s
        self.active = 0

    @property
    def pending(self):
        return len(self.queue)

    def submit(self, q):
        self.rid += 1
        self.queue.append(self.rid)
        return self.rid

    def step(self):
        rid = self.queue.pop(0)
        t = self.service_s + (self.stall_s if self.served == self.stall_at else 0.0)
        drive.time.sleep(t)
        self.served += 1
        return [type("S", (), dict(rid=rid, result=object()))]


def test_open_loop_counts_latency_from_the_due_time():
    """A stall in one step raises the latency of every query due during it:
    the loop submits late but times each query from when it was due."""
    due = np.arange(40) * 0.01
    terms = np.zeros((40, 1), np.int32)
    calm = drive.drive_open_loop(_StallServer(0.001, -1, 0.0), terms, due, np.arange(40), 0.4)
    stall = drive.drive_open_loop(_StallServer(0.001, 10, 0.2), terms, due, np.arange(40), 0.4)
    lat_calm = (calm.done - calm.due) * 1e3
    lat_stall = (stall.done - stall.due) * 1e3
    assert lat_calm.max() < 50
    # Queries 11.. were due during the 200 ms stall: each waited for it.
    assert np.all(lat_stall[11:20] > lat_calm[11:20] + 50)
    assert stall.lag_s > 0.1 and np.all(np.diff(stall.done) >= 0)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_has_the_result_keys(tiny_root, cell, trace):
    from anytime_bench.run import result_line

    result, checks = run_tiny(tiny_root, cell, trace=bool(trace))
    line = json.loads(result_line(result, checks))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    want = {0: {"tiny.poisson": {"setup_s", "p99_ms"},
                "tinyp.backlog": {"setup_s", "qps"}},
            1: {"tiny.poisson": {"plan_ms.p99", "queue_ms.p99"},
                "tinyp.backlog": {"plan_ms.qps", "dispatch_ms.qps"}}}[trace][cell]
    assert set(line["metrics"]) == want


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT}/src"),
        capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_imports_neither_jax_nor_either_package():
    names = _top_level("import anytime_bench.reference.engine, anytime_bench.reference.judge,"
                       " anytime_bench.data.synth, anytime_bench.yardstick")
    assert "anytime_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch", "torch"}


def test_a_run_holds_no_jax(tiny_root):
    """A whole run loads the port, never JAX or the JAX package, compared by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    code = (f"from anytime_bench.tests.tiny import run_tiny\n"
            f"run_tiny({tiny_root!r} + '/sub', 'tiny.poisson')\n"
            f"from anytime_bench.harness import forbidden_modules\n"
            f"assert forbidden_modules() == [], forbidden_modules()")
    names = _top_level(code)
    assert "repro_torch" in names and not names & {"jax", "jaxlib", "flax", "repro"}


def test_a_query_served_past_its_first_safe_point_is_a_bad_exit():
    """The reference works out no state past the first safe point: a query
    served beyond it is a bad exit and mismatched; one stopped there is sound."""
    from anytime_bench.reference.judge import judge

    k, R = 2, 3
    traj = {"ids": np.full((1, R + 1, k), -1, np.int32), "vals": np.zeros((1, R + 1, k), np.int32),
            "postings": np.zeros((1, R + 1), np.int64), "blocks": np.zeros((1, R + 1), np.int64),
            "bound": np.zeros((1, R), np.int64), "first_safe": np.array([1])}
    traj["ids"][0, 1], traj["vals"][0, 1] = [4, 9], [30, 20]
    traj["postings"][0, 1], traj["blocks"][0, 1] = 7, 2

    def served(n, ids, vals, postings, blocks):
        return type("R", (), dict(ranges_processed=n, doc_ids=ids, scores=vals, postings=postings,
                                  blocks=blocks, exit_safe=True, exit_budget=False))

    sound = judge([0], [served(1, [4, 9], [30, 20], 7, 2)], traj, bounded=False)
    past = judge([0], [served(2, [4, 9], [31, 20], 9, 3)], traj, bounded=False)
    assert sound["failed"] == 0
    assert past["bad_exit"] == 1 and past["mismatched"] == 1 and past["failed"] == 1


def test_setup_s_leaves_out_the_first_build(tiny_root, monkeypatch):
    """A first run's build of the collection is logged apart and not counted
    in setup_s: a build made to take 6 s more moves setup_s by far less."""
    from anytime_bench.collection import Collection

    run_tiny(tiny_root, "tiny.poisson")  # the cache exists from here on
    base, _ = run_tiny(tiny_root, "tiny.poisson")
    prepare = Collection.prepare

    def slow_build(self, *a, **kw):
        prepare(self, *a, **kw)
        drive.time.sleep(6.0)
        return True

    monkeypatch.setattr(Collection, "prepare", slow_build)
    logged = []
    slow, _ = run_tiny(tiny_root, "tiny.poisson", log=logged.append)
    assert any(m.startswith("first build of tiny in ") for m in logged)
    assert abs(slow["metrics"]["setup_s"]["value"] - base["metrics"]["setup_s"]["value"]) < 3.0
