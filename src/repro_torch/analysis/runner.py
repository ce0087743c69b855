"""Drive the registered checkers over a source tree (DESIGN.md §15).

The counterpart of the JAX package's ``analysis/runner.py``.

``analyze_paths`` walks ``.py`` files, parses them into a
:class:`~repro_torch.analysis.model.Project`, runs every registered rule, and
splits the results into active findings and waived ones (inline
``# analysis: allow[RULE]`` on the flagged line or the line above).
Paths are stored relative to ``rel_to`` (default: the current working
directory) so baseline keys are stable: run from the repo root they read
``src/repro_torch/serving/inflight.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from repro_torch.analysis.model import Finding, Project, SourceFile
from repro_torch.analysis.registry import RULES

__all__ = ["AnalysisReport", "analyze_paths", "analyze_source", "count_findings"]


@dataclass
class AnalysisReport:
    findings: list[Finding] = field(default_factory=list)
    waived: list[Finding] = field(default_factory=list)
    files: int = 0

    @property
    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "files": self.files,
            "count": len(self.findings),
            "waived": len(self.waived),
            "by_rule": self.by_rule,
            "findings": [
                dict(f.to_json(), key=f.key) for f in self.findings
            ],
            "waivers": [
                dict(f.to_json(), key=f.key) for f in self.waived
            ],
        }


def _walk_py(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [
                d for d in dirnames if not d.startswith((".", "__pycache__"))
            ]
            out.extend(
                os.path.join(dirpath, f)
                for f in filenames
                if f.endswith(".py")
            )
    return sorted(set(out))


def load_project(paths: list[str], rel_to: str | None = None) -> Project:
    rel_to = rel_to or os.getcwd()
    files: list[SourceFile] = []
    for fp in _walk_py(paths):
        with open(fp, encoding="utf-8") as fh:
            text = fh.read()
        try:
            rel = os.path.relpath(fp, rel_to)
        except ValueError:  # different drive (windows)
            rel = fp
        if rel.startswith(".."):
            rel = fp
        files.append(SourceFile(rel.replace(os.sep, "/"), text))
    return Project(files=files)


def analyze_project(project: Project) -> AnalysisReport:
    report = AnalysisReport(files=len(project.files))
    by_path = {sf.path: sf for sf in project.files}
    findings: list[Finding] = []
    for r in RULES.values():
        findings.extend(r.check(project))
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        sf = by_path.get(f.path)
        if sf is not None and sf.is_waived(f.rule, f.line):
            report.waived.append(f)
        else:
            report.findings.append(f)
    return report


def analyze_paths(
    paths: list[str], rel_to: str | None = None
) -> AnalysisReport:
    return analyze_project(load_project(paths, rel_to=rel_to))


def analyze_source(text: str, path: str = "fixture.py") -> AnalysisReport:
    """Analyze one in-memory snippet — the unit-test entry point.

    ``path`` participates in rule scoping: name it e.g.
    ``serving/fixture.py`` to put the snippet inside OBSGUARD's scope.
    """
    return analyze_project(Project(files=[SourceFile(path, text)]))


def count_findings(root: str = "src/repro_torch") -> dict:
    """Compact finding counts for the benchmark trajectory (perf_gate)."""
    rep = analyze_paths([root])
    return {
        "count": len(rep.findings),
        "waived": len(rep.waived),
        "by_rule": rep.by_rule,
    }
