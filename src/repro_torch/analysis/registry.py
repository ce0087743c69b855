"""Checker-plugin registry for the port's static-hazard analyzer (DESIGN.md §15).

The counterpart of the JAX package's ``analysis/registry.py``, unchanged.

Mirrors the ``obs/catalog.py`` discipline: every rule registers with a
non-empty help string, ``python -m repro_torch.analysis explain <RULE>`` prints
it, and ``missing_help()`` lets a meta-test keep the catalog total. A new
checker is one decorated function::

    @rule("MYRULE", "What it catches, why it matters, how to fix/waive.")
    def check_myrule(project: Project) -> list[Finding]:
        ...

The check callable receives the whole :class:`~repro_torch.analysis.model.Project`
(cross-file rules like HOSTSYNC need the call graph); per-file rules just
loop over ``project.files``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

from repro_torch.analysis.model import Finding, Project

__all__ = ["RULES", "Rule", "help_for", "missing_help", "rule"]


@dataclass(frozen=True)
class Rule:
    name: str
    help: str
    check: Callable[[Project], List[Finding]]


RULES: dict[str, Rule] = {}


def rule(name: str, help: str):
    """Register a checker under ``name`` with mandatory help text."""

    def deco(fn: Callable[[Project], List[Finding]]):
        RULES[name] = Rule(name=name, help=help, check=fn)
        return fn

    return deco


def help_for(name: str) -> str:
    """Help text for one rule; raises ``KeyError`` on unknown rules."""
    return RULES[name.upper()].help


def missing_help() -> list[str]:
    """Registered rules with empty help — must stay ``[]`` (meta-test)."""
    return sorted(n for n, r in RULES.items() if not r.help.strip())
