"""Architecture registry: ``--arch <id>`` resolution (the counterpart of the
JAX package's ``configs/registry.py``, the same 11 names)."""

from __future__ import annotations

from repro_torch.configs.anytime_ir import AnytimeIRArch
from repro_torch.configs.base import Arch
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.configs.other_archs import OTHER_ARCHS

__all__ = ["ARCHS", "get_arch", "all_cells"]

ARCHS: dict[str, Arch] = {
    a.name: a for a in [*LM_ARCHS, *OTHER_ARCHS, AnytimeIRArch()]
}


def get_arch(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) dry-run cell, with skip annotations."""
    out = []
    for name, arch in ARCHS.items():
        for shape, info in arch.shapes().items():
            if info.skip and not include_skipped:
                continue
            out.append((name, shape, info))
    return out
