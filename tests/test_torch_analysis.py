"""The port's static-hazard analyzer (``repro_torch.analysis``).

Four layers, as tests/test_analysis.py has them for the reference:

* per-rule fixtures in torch idiom: a positive, a negative and a waiver
  per rule (PALLASCONST: registered, moot, finds nothing);
* ratchet semantics: a new finding fails, a stale baseline entry fails,
  keys survive line drift, the CLI round trip;
* the repo gate: ``src/repro_torch`` is clean against the committed
  ``analysis_baseline_torch.json`` (and the CLI defaults to both);
* parity: on the reference's own OBSGUARD, ARTIFACT and NARROW fixtures
  (numpy idiom, which both analyzers read) the port's analyzer gives the
  reference's finding keys.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (
    RULES,
    analyze_paths,
    analyze_source,
    diff_baseline,
    help_for,
    load_baseline,
    missing_help,
    write_baseline,
)
from repro_torch.analysis.__main__ import main as analysis_main

REPO = Path(__file__).resolve().parents[1]


def rules_of(report):
    return sorted({f.rule for f in report.findings})


# ----------------------------------------------------------- rule fixtures


class TestRecompile:
    def test_define_from_parameter_fires(self):
        rep = analyze_source(
            "def build(k):\n"
            "    flags = ['-O3', f'-DTOPK={k}']\n"
            "    return flags\n",
            path="kernels/range_scorer/kernel.py",
        )
        assert rules_of(rep) == ["RECOMPILE"]
        assert "k" in rep.findings[0].message

    def test_template_name_from_config_fires(self):
        rep = analyze_source(
            "def entry(cfg):\n"
            "    return 'rs_traverse<' + str(cfg.k) + '>'\n",
            path="kernels/range_scorer/kernel.py",
        )
        assert rules_of(rep) == ["RECOMPILE"]

    def test_bounded_literals_and_runtime_args_are_clean(self):
        rep = analyze_source(
            "def build_all():\n"
            "    for k in (16, 64, 256):\n"
            "        yield f'-DTOPK={k}'\n"
            "def pick(fmt):\n"
            "    assert fmt in ('int32', 'packed')\n"
            "    return f'-DFMT_{fmt}'\n"
            "def check(k, s_pad):\n"
            "    raise ValueError(f'k must be 1 <= k <= {s_pad}, got {k}')\n"
            "def launch(lib, k):\n"
            "    lib.launch('rs_traverse', k)\n",
            path="kernels/range_scorer/kernel.py",
        )
        assert rep.findings == []

    def test_out_of_scope_and_waiver(self):
        src = "def build(k):\n    return f'-DTOPK={k}'\n"
        assert analyze_source(src, path="serving/fixture.py").findings == []
        rep = analyze_source(src.replace("f'-DTOPK={k}'",
                                         "f'-DTOPK={k}'  # analysis: allow[RECOMPILE]"),
                             path="kernels/x/kernel.py")
        assert rep.findings == [] and len(rep.waived) == 1


class TestHostsync:
    HOT = (
        "import numpy as np\n"
        "import torch\n"
        "class InflightServer:\n"
        "    def step(self):\n"
        "        out = self.dispatch_quantum()\n"
        "        torch.cuda.synchronize()\n"
        "        host = np.asarray(out)\n"
        "        n = out.sum().item()\n"
        "        return host, n\n"
        "    def dispatch_quantum(self):\n"
        "        return 1\n"
    )

    def test_sync_and_materialize_in_hot_root_fire(self):
        rep = analyze_source(self.HOT)
        assert rules_of(rep) == ["HOSTSYNC"]
        msgs = " ".join(f.message for f in rep.findings)
        assert "torch.cuda.synchronize" in msgs and "np.asarray" in msgs
        assert ".item()" in msgs

    @pytest.mark.parametrize("attr", ["cpu", "tolist", "numpy"])
    def test_copies_to_host_in_hot_root_fire(self, attr):
        rep = analyze_source(
            "class MicroBatchServer:\n"
            "    def drain_once(self):\n"
            "        out = self.run()\n"
            f"        return out.{attr}()\n"
        )
        assert rules_of(rep) == ["HOSTSYNC"]
        assert f".{attr}()" in rep.findings[0].message

    def test_same_body_outside_hot_roots_is_clean(self):
        rep = analyze_source(self.HOT.replace("InflightServer", "Offline"))
        assert rep.findings == []

    def test_drain_boundary_is_allowlisted(self):
        rep = analyze_source(
            "class BatchEngine:\n"
            "    def run_batch(self, x):\n"
            "        return self._host(x)\n"
            "    def _host(self, x):\n"
            "        return x.cpu().numpy()\n"
        )
        assert rep.findings == []

    def test_event_sync_inside_python_loop_fires_anywhere(self):
        rep = analyze_source(
            "def train(steps, ev):\n"
            "    for s in steps:\n"
            "        ev.synchronize()\n"
        )
        assert rules_of(rep) == ["HOSTSYNC"]

    def test_waiver_suppresses_and_is_counted(self):
        waived = self.HOT.replace(
            "torch.cuda.synchronize()",
            "torch.cuda.synchronize()  # analysis: allow[HOSTSYNC]",
        ).replace(
            "host = np.asarray(out)",
            "host = np.asarray(out)  # analysis: allow[HOSTSYNC]",
        ).replace(
            "n = out.sum().item()",
            "n = out.sum().item()  # analysis: allow[HOSTSYNC]",
        )
        rep = analyze_source(waived)
        assert rep.findings == []
        assert len(rep.waived) == 3

    def test_comment_block_waiver_covers_next_code_line(self):
        rep = analyze_source(
            "import torch\n"
            "def train(xs):\n"
            "    for x in xs:\n"
            "        # step timing is the point here\n"
            "        # analysis: allow[HOSTSYNC]\n"
            "        torch.cuda.synchronize()\n"
        )
        assert rep.findings == [] and len(rep.waived) == 1


class TestNarrow:
    @pytest.mark.parametrize("cast", [
        "new_ids.to(torch.int32)",
        "new_ids.to(dtype=torch.int32)",
        "new_ids.int()",
        "new_ids.type(torch.int32)",
        "torch.as_tensor(new_ids, dtype=torch.int32)",
        "np.asarray(new_ids, np.int32)",
        "new_ids.astype(np.int32)",
    ])
    def test_unguarded_docid_cast_fires(self, cast):
        rep = analyze_source(
            "import numpy as np\n"
            "import torch\n"
            "def build(new_ids):\n"
            f"    docs = {cast}\n"
            "    return docs\n",
            path="core/fixture.py",
        )
        assert rules_of(rep) == ["NARROW"]

    def test_clipped_cast_unwatched_name_and_allocation_are_clean(self):
        rep = analyze_source(
            "import numpy as np\n"
            "import torch\n"
            "def build(new_ids, arr):\n"
            "    docs = torch.clamp(new_ids, 0, 7).to(torch.int32)\n"
            "    lane = arr.to(torch.int32)\n"
            "    buf = torch.zeros(4, dtype=torch.int32)\n"
            "    bounds = torch.full((4,), 7, dtype=torch.int32)\n"
            "    return docs, lane, buf, bounds\n",
            path="core/fixture.py",
        )
        assert rep.findings == []

    def test_out_of_scope_module_and_waiver(self):
        src = ("import torch\n"
               "def build(new_ids):\n"
               "    docs = new_ids.to(torch.int32)\n"
               "    return docs\n")
        assert analyze_source(src, path="tools/fixture.py").findings == []
        rep = analyze_source(src.replace("to(torch.int32)",
                                         "to(torch.int32)  # analysis: allow[NARROW]"),
                             path="core/fixture.py")
        assert rep.findings == [] and len(rep.waived) == 1


class TestObsguard:
    def test_unguarded_obs_call_fires(self):
        rep = analyze_source(
            "class S:\n"
            "    def drain(self):\n"
            "        self.obs.observe('x', 1)\n",
            path="serving/fixture.py",
        )
        assert rules_of(rep) == ["OBSGUARD"]

    def test_enabled_guard_and_early_return_are_clean(self):
        rep = analyze_source(
            "class S:\n"
            "    def drain(self):\n"
            "        if self.obs.enabled:\n"
            "            self.obs.observe('x', 1)\n"
            "    def record(self):\n"
            "        if not self.obs.enabled:\n"
            "            return\n"
            "        self.obs.count('y')\n",
            path="serving/fixture.py",
        )
        assert rep.findings == []

    def test_waiver(self):
        rep = analyze_source(
            "class S:\n"
            "    def drain(self):\n"
            "        self.obs.observe('x', 1)  # analysis: allow[OBSGUARD]\n",
            path="serving/fixture.py",
        )
        assert rep.findings == [] and len(rep.waived) == 1


class TestArtifact:
    def test_bare_write_and_torch_save_fire(self):
        rep = analyze_source(
            "import json, torch\n"
            "def save(path, rows, state):\n"
            "    with open(path, 'w') as f:\n"
            "        json.dump(rows, f)\n"
            "def dump(state, path):\n"
            "    torch.save(state, path)\n",
            path="train/fixture.py",
        )
        assert rules_of(rep) == ["ARTIFACT"]
        assert len(rep.findings) == 2

    def test_staged_replace_is_clean(self):
        rep = analyze_source(
            "import os, torch\n"
            "def save(state, path):\n"
            "    torch.save(state, path + '.tmp')\n"
            "    os.replace(path + '.tmp', path)\n"
            "def again(state, path):\n"
            "    torch.save(state, path)\n"
            "    os.replace(path, path + '.old')\n",
            path="train/fixture.py",
        )
        assert rep.findings == []

    def test_waiver(self):
        rep = analyze_source(
            "import torch\n"
            "def dump(state, path):\n"
            "    torch.save(state, path)  # analysis: allow[ARTIFACT]\n",
            path="train/fixture.py",
        )
        assert rep.findings == [] and len(rep.waived) == 1


class TestPallasconst:
    def test_registered_and_moot(self):
        # The reference's positive fixture finds nothing here: no Pallas.
        rep = analyze_source(
            "def scatter_kernel(ref, out_ref):\n"
            "    if ref[0] > 0:\n"
            "        out_ref[0] = 1\n",
            path="kernels/fixture.py",
        )
        assert rep.findings == []
        assert "no Pallas" in help_for("PALLASCONST")


# -------------------------------------------------------- ratchet semantics


class TestBaselineRatchet:
    BAD = (
        "import torch\n"
        "def build(new_ids):\n"
        "    docs = new_ids.to(torch.int32)\n"
        "    return docs\n"
    )

    def findings(self):
        return analyze_source(self.BAD, path="core/fixture.py").findings

    def test_pinned_finding_passes(self, tmp_path):
        f = self.findings()
        bl = tmp_path / "baseline.json"
        write_baseline(str(bl), f)
        new, stale = diff_baseline(f, load_baseline(str(bl)))
        assert new == [] and stale == []

    def test_new_finding_fails(self, tmp_path):
        bl = tmp_path / "baseline.json"
        write_baseline(str(bl), [])
        new, stale = diff_baseline(self.findings(), load_baseline(str(bl)))
        assert len(new) == 1 and stale == []

    def test_stale_baseline_entry_fails(self, tmp_path):
        bl = tmp_path / "baseline.json"
        write_baseline(str(bl), self.findings())
        new, stale = diff_baseline([], load_baseline(str(bl)))
        assert new == [] and len(stale) == 1

    def test_key_survives_line_drift(self):
        shifted = "# a new comment line\n\n" + self.BAD
        a = self.findings()
        b = analyze_source(shifted, path="core/fixture.py").findings
        assert [f.key for f in a] == [f.key for f in b]
        assert a[0].line != b[0].line

    def test_cli_check_baseline_roundtrip(self, tmp_path, monkeypatch):
        pkg = tmp_path / "core"
        pkg.mkdir()
        (pkg / "fixture.py").write_text(self.BAD)
        monkeypatch.chdir(tmp_path)
        assert analysis_main(["check", "core"]) == 1
        assert analysis_main(["baseline", "core", "--out", "b.json"]) == 0
        assert analysis_main(["check", "core", "--baseline", "b.json"]) == 0
        (pkg / "fixture.py").write_text("x = 1\n")  # debt paid -> stale pin
        assert analysis_main(["check", "core", "--baseline", "b.json"]) == 1

    def test_cli_json_report(self, tmp_path, monkeypatch):
        pkg = tmp_path / "core"
        pkg.mkdir()
        (pkg / "fixture.py").write_text(self.BAD)
        monkeypatch.chdir(tmp_path)
        analysis_main(["check", "core", "--json", "rep.json"])
        rep = json.loads((tmp_path / "rep.json").read_text())
        assert rep["count"] == 1 and rep["by_rule"] == {"NARROW": 1}


# ------------------------------------------------------- catalog and gate


def test_every_rule_has_help_text():
    assert missing_help() == []
    assert sorted(RULES) == ["ARTIFACT", "HOSTSYNC", "NARROW", "OBSGUARD", "PALLASCONST",
                             "RECOMPILE"]


def test_explain_cli_covers_every_rule(capsys):
    assert analysis_main(["explain"]) == 0
    out = capsys.readouterr().out
    for name in RULES:
        assert name in out
    assert analysis_main(["explain", "nope"]) == 2


def test_repo_is_clean_against_committed_baseline():
    """The port's gate: ``src/repro_torch`` against
    ``analysis_baseline_torch.json``, no new and no stale finding."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rep = analyze_paths(["src/repro_torch"])
        new, stale = diff_baseline(rep.findings,
                                   load_baseline("analysis_baseline_torch.json"))
    finally:
        os.chdir(cwd)
    assert new == [], [f.render() for f in new]
    assert stale == [], stale


def test_cli_defaults_to_the_port_and_its_baseline():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "check", "--baseline",
         "analysis_baseline_torch.json"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new, 0 stale" in out.stdout
    from repro_torch.analysis.__main__ import DEFAULT_BASELINE, DEFAULT_PATHS

    assert (DEFAULT_PATHS, DEFAULT_BASELINE) == (["src/repro_torch"],
                                                 "analysis_baseline_torch.json")


# ------------------------------------------------- parity with the reference

_REF_FIXTURES = [
    ("OBSGUARD", "serving/fixture.py",
     "class S:\n    def drain(self):\n        self.obs.observe('x', 1)\n"),
    ("OBSGUARD", "control/fixture.py",
     "class S:\n    def drain(self):\n        if self.obs.enabled:\n"
     "            self.obs.observe('x', 1)\n    def record(self):\n"
     "        self.prof.record_dispatch('y')\n"),
    ("ARTIFACT", "index_io/fixture.py",
     "import json\ndef save(path, rows):\n    with open(path, 'w') as f:\n"
     "        json.dump(rows, f)\n"),
    ("ARTIFACT", "index_io/fixture.py",
     "import json, os\ndef save(path, rows):\n    with open(path + '.tmp', 'w') as f:\n"
     "        json.dump(rows, f)\n    os.replace(path + '.tmp', path)\n"),
    ("NARROW", "core/fixture.py",
     "import numpy as np\ndef build(new_ids):\n    docs = new_ids.astype(np.int32)\n"
     "    return docs\n"),
    ("NARROW", "core/fixture.py",
     "import numpy as np\ndef build(new_ids, arr):\n"
     "    docs = np.clip(new_ids, 0, 7).astype(np.int32)\n"
     "    lane = arr.astype(np.int32)\n    buf = np.zeros(4, dtype=np.int32)\n"
     "    return docs, lane, buf\n"),
    ("NARROW", "serving/fixture.py",
     "import numpy as np\ndef f(bounds, budget):\n    b = np.int32(bounds)\n"
     "    c = budget.astype('int32')\n    return b, c\n"),
]


@pytest.mark.parametrize("rule_name,path,src", _REF_FIXTURES,
                         ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(_REF_FIXTURES)])
def test_finding_keys_equal_the_references(rule_name, path, src):
    from repro.analysis import analyze_source as ref_analyze

    want = [(f.rule, f.key, f.line) for f in ref_analyze(src, path=path).findings]
    got = [(f.rule, f.key, f.line) for f in analyze_source(src, path=path).findings]
    assert got == want
    assert all(r == rule_name for r, _, _ in got)
