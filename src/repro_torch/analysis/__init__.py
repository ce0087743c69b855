"""repro_torch.analysis: the port's static-hazard linter (DESIGN.md §15).

The counterpart of the JAX package's ``repro.analysis``: the same
stdlib-``ast`` analyzer, registry, ratchet and CLI, each rule restated for
PyTorch and the hand-written CUDA kernels: host syncs in dispatch hot
loops (HOSTSYNC: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``torch.cuda.synchronize``), unguarded int32 narrowing (NARROW, torch's
casts too), unguarded telemetry in hot paths (OBSGUARD), non-atomic
artifact writes (ARTIFACT, ``torch.save`` too), kernel variants built
from unbounded values (RECOMPILE, the ``nvcc`` build cache), and
PALLASCONST, registered and moot (the port has no Pallas). Findings
ratchet through ``analysis_baseline_torch.json``; intentional sites carry
``# analysis: allow[RULE]`` waivers.

CLI: ``python -m repro_torch.analysis {check,baseline,explain}`` (default
root ``src/repro_torch``).
"""

from repro_torch.analysis.model import Finding, Project, SourceFile
from repro_torch.analysis.registry import RULES, Rule, help_for, missing_help, rule
from repro_torch.analysis import checkers  # noqa: F401  (registers the rules)
from repro_torch.analysis.baseline import (
    diff_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.runner import (
    AnalysisReport,
    analyze_paths,
    analyze_source,
    count_findings,
)

__all__ = [
    "AnalysisReport",
    "Finding",
    "Project",
    "RULES",
    "Rule",
    "SourceFile",
    "analyze_paths",
    "analyze_source",
    "count_findings",
    "diff_baseline",
    "help_for",
    "load_baseline",
    "missing_help",
    "rule",
    "write_baseline",
]
