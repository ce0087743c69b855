"""``BENCHMARK.json`` against its format rules, and every cell's files."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from anytime_bench import traffic as traffic_mod
from anytime_bench.harness import BENCH_DIR, load_cell

ROOT = os.path.dirname(BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["anytime_bench"] and BENCH["command"][1] == "anytime_bench/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
        for e in BENCH[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_metrics_and_bounds():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in cells.values()} == configs
    assert all(w["chips"] == 1 for w in cells.values())
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:  # each cell of the metric reports what it moves
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    for w in cells:
        reported = [m for m in e2e.values() if w in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(w in m["workloads"] for m in BENCH["per_layer"])
    for m in [*BENCH["end_to_end"], *BENCH["per_layer"]]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")), m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_parses(workload):
    cell, cfg, traffic = load_cell(BENCH, workload, ROOT)
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert entry["file"].startswith("anytime_bench/") and cfg["name"] == cell["config"]
    assert cfg["n_docs"] == cfg["n_ranges"] * cfg["docs_per_range"]
    for key in entry["reduced"]:
        assert cfg[key] != cfg["published"].get(key, cfg[key]) or key == "n_docs"
    assert traffic["server"] in ("inflight", "microbatch")
    for seed in (0, 2**31 + 5):
        s = traffic_mod.make_stream(traffic["arrivals"], seed, BENCH["run_seconds"],
                                    traffic["pool"]["size"])
        assert s.qidx.min() >= 0 and s.qidx.max() < traffic["pool"]["size"]
        if s.due is not None:
            assert np.all(np.diff(s.due) >= 0) and 0 <= s.due[0] and s.due[-1] < BENCH["run_seconds"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_seed_orders_the_same_work(workload):
    """Two seeds give the same number of arrivals, the same gaps and the same
    pool rows, in another order."""
    _, _, traffic = load_cell(BENCH, workload, ROOT)
    a, b = (traffic_mod.make_stream(traffic["arrivals"], s, 30, traffic["pool"]["size"])
            for s in (3, 2**31 + 11))
    assert sorted(a.qidx.tolist()) == sorted(b.qidx.tolist())
    assert not np.array_equal(a.qidx, b.qidx)
    if a.due is not None:
        qs = [0.1, 0.5, 0.9]
        assert a.due.shape == b.due.shape
        assert np.allclose(np.quantile(np.diff(a.due), qs), np.quantile(np.diff(b.due), qs),
                           rtol=0.05)
