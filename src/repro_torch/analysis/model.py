"""Data model for the port's static-hazard analyzer (DESIGN.md §15).

The counterpart of the JAX package's ``analysis/model.py``, unchanged.

A :class:`Finding` is one rule violation at one source location. Its
``key`` deliberately excludes the line number: it hashes the rule, the
file, the enclosing scope, and the *normalized source snippet*, so the
committed ``analysis_baseline.json`` ratchet survives unrelated edits
above a finding but invalidates (as "stale") when the flagged code is
actually changed or removed.

Inline waivers use the comment marker ``# analysis: allow[RULE]`` (or
``allow[RULE1,RULE2]``), placed on the flagged line or the line directly
above it. Waivers are extracted with :mod:`tokenize` so strings that
merely *look* like comments never waive anything.
"""

from __future__ import annotations

import ast
import hashlib
import io
import re
import tokenize
from dataclasses import dataclass, field

__all__ = ["Finding", "Project", "SourceFile", "WAIVER_RE"]

WAIVER_RE = re.compile(r"analysis:\s*allow\[([A-Za-z0-9_,\s]+)\]")


def _hash8(text: str) -> str:
    """First 8 hex chars of the whitespace-normalized snippet hash."""
    norm = " ".join(text.split())
    return hashlib.sha1(norm.encode("utf-8")).hexdigest()[:8]


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    scope: str
    message: str
    snippet: str = ""

    @property
    def key(self) -> str:
        """Stable baseline key: line-number-free, snippet-hashed."""
        return (
            f"{self.rule}:{self.path}:{self.scope}:"
            f"{_hash8(self.snippet or self.message)}"
        )

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
        }

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.scope}: "
            f"{self.message}"
        )


def _parse_waivers(text: str) -> dict[int, set[str]]:
    """Map line number -> set of waived rule names, via real comment tokens.

    A trailing waiver covers its own line. A waiver inside a comment-only
    block also covers the first code line after the block, so multi-line
    rationale comments above the flagged statement work naturally.
    """
    waivers: dict[int, set[str]] = {}
    lines = text.splitlines()

    def _comment_only(line_no: int) -> bool:
        if not 1 <= line_no <= len(lines):
            return False
        stripped = lines[line_no - 1].strip()
        return not stripped or stripped.startswith("#")

    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = WAIVER_RE.search(tok.string)
            if not m:
                continue
            rules = {
                r.strip().upper() for r in m.group(1).split(",") if r.strip()
            }
            line = tok.start[0]
            waivers.setdefault(line, set()).update(rules)
            if _comment_only(line):
                nxt = line + 1
                while _comment_only(nxt) and nxt <= len(lines):
                    nxt += 1
                waivers.setdefault(nxt, set()).update(rules)
    except tokenize.TokenError:
        pass
    return waivers


class SourceFile:
    """A parsed source file: AST with parent links, waivers, snippets."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child.parent = parent  # type: ignore[attr-defined]
        self.waivers = _parse_waivers(text)

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.text, node) or ""

    def scope_of(self, node: ast.AST) -> str:
        """Dotted enclosing class/function chain, or ``<module>``."""
        parts: list[str] = []
        cur: ast.AST | None = node
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                parts.append(cur.name)
            cur = getattr(cur, "parent", None)
        return ".".join(reversed(parts)) or "<module>"

    def is_waived(self, rule: str, line: int) -> bool:
        """Waiver on the flagged line or the line directly above it."""
        return rule in self.waivers.get(line, ()) or rule in self.waivers.get(
            line - 1, ()
        )


@dataclass
class Project:
    """The unit checkers operate on: every parsed file under the scan root."""

    files: list[SourceFile] = field(default_factory=list)

    def by_path(self, path: str) -> SourceFile | None:
        for sf in self.files:
            if sf.path == path:
                return sf
        return None
