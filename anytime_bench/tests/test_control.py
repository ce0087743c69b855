"""The comparison that decides ``correct`` is shown to fail.

The control: the port serving an index it built at the configuration's
``control_impact_bits`` (the next precision down) against the reference at
the stated precision. Then the timed path broken underneath, once for each
fault a one-chip serving cell can have: a step that returns its state
unchanged, the upper half of the batch's lanes left out, an answer altered
where it is produced. (No cell spans chips, so there is no exchange between chips to
leave out.) Every one has to read ``correct`` false; the sound run true.
On the card: ``python -m pytest -m cuda anytime_bench/tests``
from the repository root runs the same at the tiny size with the kernels.
"""

from __future__ import annotations

import pytest
import torch

from anytime_bench.tests.tiny import CELLS, CONFIGS, run_tiny


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tiny"))


def _unchanged(launch):
    def fault(*a, **kw):
        return a[7].clone()  # the carry in: the step did nothing
    return fault


def _half_the_lanes(launch):
    def fault(*a, **kw):
        out = launch(*a, **kw)
        half = out.shape[0] // 2
        out[half:] = a[7][half:]  # the upper half of the lanes never runs
        return out
    return fault


def _altered_answer(launch):
    def fault(*a, **kw):
        out = launch(*a, **kw)
        k = (out.shape[1] - 5) // 2
        ids = out[:, k + 2]
        out[:, k + 2] = torch.where(ids >= 0, ids + 1, ids)  # each lane's best doc id
        return out
    return fault


FAULTS = {"unchanged": _unchanged, "half_the_lanes": _half_the_lanes,
          "altered_answer": _altered_answer}


def _run(root, cell, device="cpu", fault=None, **kw):
    from repro_torch.core import range_daat
    from repro_torch.serving import batch_engine

    launch = range_daat.traverse_lanes
    if fault is not None:
        broken = FAULTS[fault](launch)
        range_daat.traverse_lanes = batch_engine.traverse_lanes = broken
    try:
        return run_tiny(root, cell, device=device, **kw)
    finally:
        range_daat.traverse_lanes = batch_engine.traverse_lanes = launch


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result, checks = _run(tiny_root, cell)
    assert result["correct"] and all(v == 0 for v, _ in checks.values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    cfg = CONFIGS[cell.split(".")[0]]
    result, checks = _run(tiny_root, cell,
                          program_cfg={"impact_bits": cfg["control_impact_bits"]})
    assert not result["correct"] and checks["mismatched"][0] > 0


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(tiny_root, cell, fault):
    result, checks = _run(tiny_root, cell, fault=fault, drain_limit_s=1.0)
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card(tmp_path, cell, fault):
    """The same at the tiny size on the card, through the kernels; a traced
    run reads the device trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = _run(str(tmp_path), cell, device="cuda", fault=fault, trace=fault is None,
                     drain_limit_s=1.0)
    assert result["correct"] is (fault is None)
    if fault is None:
        dev = result["device"]
        assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
        assert result["breakdown"]["device_ops"]
