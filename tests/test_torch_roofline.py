"""The port's roofline collator (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), on the CPU.

* ``model_flops_for`` equals the reference's for every (arch, shape) cell
  and every kind, on both meshes' device counts;
* ``collate`` over fixture dry-run records equals the reference's with
  the reference's TPU constants swapped for the H100's, the renamed
  counted-FLOPs keys aside (``compute_s_counted`` is the reference's
  ``compute_s_hlo``, ``counted_flops_total`` its ``hlo_flops_total``);
  ``to_markdown`` gives the same table.
"""

from __future__ import annotations

import json

import pytest

from repro.configs.registry import all_cells as ref_cells
from repro.launch import roofline as ref
from repro_torch.launch import roofline as port

CELLS = [(a, s) for a, s, _ in ref_cells()]


def test_constants_are_the_h100_data_sheets():
    assert (port.PEAK_FLOPS, port.HBM_BW, port.LINK_BW) == (989.4e12, 3.35e12, 50e9)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_references(arch, shape):
    for kind in ("train", "serve", "prefill", "decode", "retrieval"):
        for n_dev in (256, 512):
            assert port.model_flops_for(arch, shape, kind, n_dev) == ref.model_flops_for(
                arch, shape, kind, n_dev), (kind, n_dev)


def _record(arch, shape, mesh, kind, variant="baseline", *, ok=True, flops=1.5e12,
            bytes_acc=3.2e10, coll=(7e8, 2e8), peak=9 * 2**30):
    n = 512 if mesh == "multi" else 256
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "variant": variant, "kind": kind,
        "n_devices": n, "ok": ok,
        "memory": {"argument_size_in_bytes": 1, "peak_memory_in_bytes": peak},
        "per_device_flops": flops, "per_device_bytes_accessed": bytes_acc,
        "collectives": {"bytes_by_kind": {"all-gather": coll[0], "all-reduce": coll[1]},
                        "count_by_kind": {"all-gather": 3, "all-reduce": 2},
                        "total_bytes": coll[0] + coll[1]},
        "model_flops_per_token": 1.0, "device": "cuda",
    }


FIXTURES = [
    _record("qwen3-4b", "train_4k", "single", "train", flops=4.4e14, bytes_acc=2e12),
    _record("qwen3-4b", "train_4k", "multi", "train", flops=2.2e14, bytes_acc=1e12),
    _record("deepseek-v3-671b", "decode_32k", "single", "serve", "split_kv",
            flops=4.2e11, bytes_acc=5e10, coll=(9e8, 4e7)),
    _record("anytime-ir", "serve_anytime", "single", "serve", flops=0.0, bytes_acc=8e9,
            coll=(4e4, 16.0)),
    _record("bst", "serve_p99", "single", "serve", flops=2e9, bytes_acc=1e8, coll=(0, 0)),
    _record("graphsage-reddit", "ogb_products", "single", "train", "sharded"),
    _record("mind", "train_batch", "single", "train", ok=False),
]


def test_collate_equals_the_references_with_the_h100_constants(tmp_path, monkeypatch):
    for i, rec in enumerate(FIXTURES):
        (tmp_path / f"cell{i:02d}.json").write_text(json.dumps(rec))
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref, name, getattr(port, name))
    want = ref.collate(str(tmp_path))
    # A record of a dry run on fake CPU tensors, which the port skips.
    (tmp_path / "cpu.json").write_text(json.dumps(dict(FIXTURES[0], device="cpu")))
    got = port.collate(str(tmp_path))
    assert len(got) == len(want) == len(FIXTURES) - 1  # the failed cell is skipped
    for g, w in zip(got, want):
        g = dict(g)
        assert g.pop("kernel_launches") == {}
        g["compute_s_hlo"] = g.pop("compute_s_counted")
        g["hlo_flops_total"] = g.pop("counted_flops_total")
        assert g == w
    for mesh in ("single", "multi"):
        assert port.to_markdown(got, mesh) == ref.to_markdown(want, mesh)


def test_main_writes_rows_and_table(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps(FIXTURES[0]))
    out = tmp_path / "roofline.json"
    port.main(["--results-dir", str(tmp_path), "--out", str(out)])
    rows = json.loads(out.read_text())
    assert [r["arch"] for r in rows] == ["qwen3-4b"]
    assert rows[0]["dominant"] in ("compute", "memory", "collective")
    assert "| qwen3-4b | train_4k |" in capsys.readouterr().out


def test_collate_reads_only_records_faked_on_the_card(tmp_path):
    """A run on fake CPU tensors (or a record without a device) is skipped."""
    (tmp_path / "a.json").write_text(json.dumps(FIXTURES[0]))
    (tmp_path / "b.json").write_text(json.dumps(dict(FIXTURES[4], device="cpu")))
    (tmp_path / "c.json").write_text(json.dumps({k: v for k, v in FIXTURES[3].items()
                                                 if k != "device"}))
    assert [r["arch"] for r in port.collate(str(tmp_path))] == ["qwen3-4b"]
