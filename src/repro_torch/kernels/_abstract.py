"""Shapes without data: the kernels' callers on fake and meta tensors.

A dry run (``launch/dryrun.py``) runs a whole step under
``torch._subclasses.fake_tensor.FakeTensorMode``, where a tensor has a
shape, a type and a device but no data. A CUDA kernel takes raw pointers
and the plain versions loop on data, so neither runs there. The callers of
the kernels (``core.range_daat.traverse_lanes``,
``kernels.range_scorer.ops.score_blocks``,
``kernels.embedding_bag.ops.bag_reduce``) test their inputs with
``is_abstract`` first: on fake or meta tensors they return an empty
output of the kernel's shape and type and record the inputs the kernel
(or its plain version) would read in the census that ``launch_census``
opens (a dry run counts them as read); on their ``cuda`` route only (the
plain versions launch nothing) they also count one launch of the kernel
by name. The test is one type
check a launch; the wrappers' own launch counters are not touched.
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_abstract", "launch_census", "launch_inputs", "record_launch", "record_reads"]

_CENSUS: list[tuple[dict, list]] = []  # the open censuses: (counts, inputs)


def is_abstract(x) -> bool:
    """True for a fake tensor or a tensor on the meta device."""
    return isinstance(x, FakeTensor) or (isinstance(x, torch.Tensor) and x.is_meta)


def record_reads(*inputs) -> None:
    """Note in the innermost open census that the step reads ``inputs``
    (tensors, or tuples of them): a plain route's shape rule."""
    if _CENSUS:
        _CENSUS[-1][1].extend(inputs)


def record_launch(name: str, *inputs) -> None:
    """Count one launch of kernel ``name`` in the innermost open census; the
    kernel would read ``inputs`` (``record_reads``)."""
    if _CENSUS:
        counts = _CENSUS[-1][0]
        counts[name] = counts.get(name, 0) + 1
    record_reads(*inputs)


def launch_inputs() -> list:
    """What the launches of the innermost open census were given."""
    return _CENSUS[-1][1] if _CENSUS else []


@contextlib.contextmanager
def launch_census():
    """``{kernel name: launches}`` of the shape rules run inside the block."""
    counts: dict = {}
    _CENSUS.append((counts, []))
    try:
        yield counts
    finally:
        _CENSUS.pop()
