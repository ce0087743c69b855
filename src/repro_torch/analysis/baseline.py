"""The ratcheted finding baseline (DESIGN.md §15).

The counterpart of the JAX package's ``analysis/baseline.py``, unchanged;
the port's pin file, ``analysis_baseline_torch.json``, pins the findings
the port has consciously deferred. The ratchet only tightens:

* a finding **not** in the baseline fails the check (new debt),
* a baseline entry with no matching finding **also** fails (the debt was
  paid — delete the entry so it can never regress silently).

Keys come from :attr:`Finding.key` — line-number-free and snippet-hashed,
so pure line drift neither breaks nor loosens the ratchet.
"""

from __future__ import annotations

import json
import os

from repro_torch.analysis.model import Finding

__all__ = ["diff_baseline", "load_baseline", "write_baseline"]

VERSION = 1


def load_baseline(path: str) -> dict[str, dict]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} "
            f"in {path} (want {VERSION})"
        )
    return dict(data.get("findings") or {})


def write_baseline(path: str, findings: list[Finding]) -> None:
    payload = {
        "version": VERSION,
        "findings": {
            f.key: f.to_json()
            for f in sorted(findings, key=lambda f: f.key)
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def diff_baseline(
    findings: list[Finding], baseline: dict[str, dict]
) -> tuple[list[Finding], list[str]]:
    """(new findings not in the baseline, stale baseline keys)."""
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(k for k in baseline if k not in keys)
    return new, stale
