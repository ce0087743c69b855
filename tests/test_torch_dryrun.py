"""The port's dry run (``repro_torch.launch.{mesh,dryrun}``), on the CPU.

Three processes run side by side: two of the port, each rank 0 of a fake
group of 512 ranks (this file run as a script, JAX-free), and one of the
reference with 512 host devices (``--xla_force_host_platform_device_count``):

  * ``make_production_mesh``/``make_ctx``: the reference's shapes, axes
    and data axes, on one pod and on two;
  * every one of the 37 (arch, shape) cells at its reduced config on a
    2 x 4 fake mesh (``anytime-ir`` with a shard per model rank and a
    query per data rank): ``ok``, with the keys of the reference's record
    and nonzero arguments;
  * rank 0's argument bytes of every cell at full size on 16 x 16, equal
    to the reference's: the bytes of every block, for all 37, to its specs
    applied to its ``param_shapes``/``input_specs``/
    ``eval_shape(init_opt_state)`` (FSDP and ZeRO-1 as its dry run lays them
    out), which is arithmetic with no lowering; and the dry run's
    ``argument_size_in_bytes`` (the blocks the step reads) of the 6 cells it
    lowers (``autoint`` x 4, ``anytime-ir`` x 2) to its compiled
    ``memory_analysis()``;
  * the reference's own dry run raising ``ShardingTypeError`` on a cell of
    the other 31 (``bst`` ``serve_p99``), pinned as ROADMAP C8;
  * a hand-counted collective census of one tensor-parallel GQA layer;
  * the shape rule: the kernels' callers on fake and meta tensors return
    their outputs' shapes and count one launch each.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "peak_memory_in_bytes"}
LOWERED = ("autoint/train_batch", "autoint/serve_p99", "autoint/serve_bulk",
           "autoint/retrieval_cand", "anytime-ir/serve_anytime", "anytime-ir/serve_exhaustive")
GQA = dict(B=2, S=64, d=256, heads=8, kv=8, hd=32)


def _cells():
    from repro_torch.configs.registry import all_cells

    return [(a, s) for a, s, _ in all_cells()]


# --------------------------------------------------------------------------
# The port's side (a fake group; no JAX)
# --------------------------------------------------------------------------


def _gqa_census() -> dict:
    """One dense layer of a GQA model, tensor parallel over a 1 x 4 mesh,
    forward only, under the collective census."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import GQAConfig

    g = GQA
    cfg = tfm.LMConfig(name="census", n_layers=1, d_model=g["d"], vocab=512,
                       attn=GQAConfig(d_model=g["d"], n_heads=g["heads"], n_kv_heads=g["kv"],
                                      head_dim=g["hd"]),
                       d_ff=512, max_seq=g["S"], dtype=torch.float32)
    mesh = sh.make_mesh((1, 4), ("data", "model"))
    ctx = sh.ShardCtx(mesh)
    specs = tfm.param_specs(cfg)
    meta = tfm.init_lm(0, cfg, device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True):
        from repro_torch.launch.dryrun import _fake_blocks

        params = _fake_blocks(meta, specs, mesh, torch.device("cpu"))
        x = torch.empty((g["B"], g["S"], g["d"]), dtype=torch.float32)
        rope = tfm.rope_table(cfg, g["S"], torch.device("cpu"))
        with sh.collective_census() as coll, torch.no_grad():
            y, _ = tfm._layer_apply(params["dense"][0], x, rope, cfg,
                                    torch.arange(g["S"]), False, ctx)
        shape = tuple(y.shape)
    return dict(coll, out=shape)


def _port_reduced(out: dict) -> None:
    from repro_torch.launch import dryrun, mesh

    dryrun.ensure_fake_group(device="cpu")
    out["mesh"] = {}
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        ctx = mesh.make_ctx(m)
        out["mesh"][multi] = dict(shape=list(m.mesh.shape), axes=list(m.mesh_dim_names),
                                  data_axes=list(ctx.data_axes), model=ctx.model_axis,
                                  n_data=ctx.n_data, n_model=ctx.n_model)
    out["cells"] = {}
    for a, s in _cells():
        try:
            out["cells"][f"{a}/{s}"] = dryrun.run_cell(a, s, reduced=True, mesh_shape=(2, 4),
                                                         device="cpu")
        except Exception as e:  # noqa: BLE001: recorded, the test names it
            out["cells"][f"{a}/{s}"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    out["gqa"] = _gqa_census()


def _port_full(out: dict) -> None:
    from repro_torch.launch import dryrun

    out["args"] = {f"{a}/{s}": dryrun.argument_bytes(a, s, "single", device="cpu")
                   for a, s in _cells()}
    # The cells the reference lowers, run: the bytes their steps read.
    out["read"] = {cell: dryrun.run_cell(*cell.split("/"), "single", device="cpu")["memory"][
        "argument_size_in_bytes"] for cell in LOWERED}


if __name__ == "__main__":
    torch.set_num_threads(1)
    result: dict = {}
    {"reduced": _port_reduced, "full": _port_full}[sys.argv[1]](result)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(result, f)
    sys.exit(0)


# --------------------------------------------------------------------------
# The reference's side (512 host devices)
# --------------------------------------------------------------------------

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import all_cells, get_arch
from repro.launch.dryrun import run_cell
from repro.launch.mesh import make_ctx, make_production_mesh
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.train.trainer import zero1_spec, zero1_state_specs

out = {"mesh": {}, "args": {}, "lowered": {}}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    ctx = make_ctx(m)
    out["mesh"][str(multi)] = dict(shape=list(m.devices.shape), axes=list(m.axis_names),
                                   data_axes=list(ctx.data_axes), model=ctx.model_axis,
                                   n_data=ctx.n_data, n_model=ctx.n_model)
mesh = make_production_mesh(multi_pod=False)
ctx = make_ctx(mesh)
is_spec = lambda x: isinstance(x, P)

def nbytes(tree, specs):
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    sp = jax.tree.leaves(specs, is_leaf=is_spec)
    assert len(leaves) == len(sp)
    return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape)))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, sp))

for a, s, _ in all_cells():
    arch = get_arch(a)
    cfg = arch.model_config(reduced=False)
    if arch.family == "gnn":
        cfg = arch._resolved(cfg, s)
    psh = arch.param_shapes(cfg)
    psp = arch.param_pspecs(cfg, psh)
    if getattr(arch, "fsdp", False):  # as the reference's dry run places them
        ms = dict(mesh.shape)
        psp = jax.tree.map(lambda sp, p: sp if int(np.prod(p.shape)) < 65536 else zero1_spec(
            sp, p.shape, ctx.n_data, ctx.data_axes, ms), psp, psh, is_leaf=is_spec)
    _, kind = arch.build_step(cfg, s, shard_ctx=ctx)
    n = nbytes(psh, psp) + nbytes(arch.input_specs(cfg, s), arch.batch_pspecs(cfg, s, ctx))
    if kind == "train":
        osh = jax.eval_shape(lambda p: init_opt_state(
            p, AdamWConfig(moment_dtype=arch.moment_dtype(cfg))), psh)
        n += nbytes(osh, zero1_state_specs(psp, psh, osh, ctx.n_data, ctx.data_axes,
                                           mesh_shape=dict(mesh.shape)))
    out["args"][f"{a}/{s}"] = n
for cell in sys.argv[2].split(","):
    a, s = cell.split("/")
    out["lowered"][cell] = run_cell(a, s, "single")["memory"]["argument_size_in_bytes"]
try:
    run_cell("bst", "serve_p99", "single")
    out["raises"] = None
except Exception as e:
    out["raises"] = [type(e).__name__, str(e)[:200]]
json.dump(out, open(sys.argv[1], "w"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the port's reduced runs and census, its full-size argument bytes,
    the reference's answers)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {
        kind: subprocess.Popen([sys.executable, __file__, kind, str(tmp / f"{kind}.pkl")],
                               cwd=ROOT, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        for kind in ("reduced", "full")}
    ref_env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
               "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs["ref"] = subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "ref.json"), ",".join(LOWERED)], cwd=ROOT,
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for k, p in procs.items():
            logs[k] = p.communicate(timeout=TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            p.kill()
    bad = {k: logs[k][-3000:] for k, p in procs.items() if p.returncode != 0}
    assert not bad, bad
    assert "REF_OK" in logs["ref"], logs["ref"][-3000:]
    with open(tmp / "reduced.pkl", "rb") as f:
        reduced = pickle.load(f)
    with open(tmp / "full.pkl", "rb") as f:
        full = pickle.load(f)
    with open(tmp / "ref.json") as f:
        ref = json.load(f)
    return reduced, full, ref


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_and_ctx_equal_the_references(run, multi):
    reduced, _, ref = run
    assert reduced["mesh"][multi] == ref["mesh"][str(multi)]


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in _cells()])
def test_every_cell_runs_reduced_on_a_fake_2x4_mesh(run, cell):
    rec = run[0]["cells"][cell]
    assert rec["ok"], rec.get("error")
    assert MEMORY_KEYS <= set(rec["memory"])
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"]
    assert {"bytes_by_kind", "count_by_kind", "total_bytes"} == set(rec["collectives"])
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    # Fake CPU tensors take the plain routes, which launch no kernel (the
    # card's census, {"traverse": 1} for anytime-ir, is chip_smoke's (i)).
    assert rec["kernel_launches"] == {}
    assert rec["device"] == "cpu"
    if rec["kind"] == "train":
        assert rec["per_device_flops"] > 0 and rec["arguments"]["moments"] > 0


def test_full_size_argument_bytes_equal_the_references(run):
    _, full, ref = run
    assert len(full["args"]) == len(ref["args"]) == 37
    diff = {c: (full["args"][c], ref["args"][c]) for c in ref["args"]
            if full["args"][c] != ref["args"][c]}
    assert diff == {}
    # Where the reference lowers: its compiled memory_analysis, which leaves
    # out the arguments the step never reads, against the bytes the port's
    # step reads (autoint's serve steps skip a 64-byte training leaf).
    for cell in LOWERED:
        assert full["read"][cell] == ref["lowered"][cell], cell
    assert full["args"]["anytime-ir/serve_anytime"] == 2_074_216_516


def test_reference_dry_run_raises_on_gather_cells(run):
    """ROADMAP C8: under jax 0.9.0 the reference's dry run raises on 31 of
    its 37 single-pod cells (an embedding gather with the batch over
    ``data``); ``bst`` ``serve_p99`` is one. The port runs them all."""
    _, _, ref = run
    assert ref["raises"] is not None and ref["raises"][0] == "ShardingTypeError"
    assert run[0]["cells"]["bst/serve_p99"]["ok"]


def test_tensor_parallel_gqa_layer_census_is_hand_counted(run):
    """A dense GQA layer on 1 x 4, forward: the attention's row-sharded
    ``wo`` and the FFN's ``w_down`` each end in one float32 ``psum`` of the
    [B, S, d] activations over ``model``; nothing else moves (the KV heads
    are replicated: 8 of them do not shard)."""
    g = GQA
    census = run[0]["gqa"]
    one = g["B"] * g["S"] * g["d"] * 4
    assert census["out"] == (g["B"], g["S"], g["d"])
    assert census["count_by_kind"] == {"all-reduce": 2}
    assert census["bytes_by_kind"] == {"all-reduce": 2 * one}


def test_shape_rule_counts_one_launch_a_call():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.range_daat import traverse_lanes
    from repro_torch.kernels._abstract import is_abstract, launch_census
    from repro_torch.kernels.embedding_bag.ops import bag_reduce
    from repro_torch.kernels.range_scorer import kernel
    from repro_torch.kernels.range_scorer.ops import score_blocks

    before = (kernel.traverse.launches, kernel.scatter_accumulate.launches)
    k, n = 10, 6
    with FakeTensorMode() as mode, launch_census() as counts:
        dix = None  # the rule answers before the index is read
        i32 = lambda *s: torch.empty(s, dtype=torch.int32)  # noqa: E731
        carry = traverse_lanes(dix, i32(n, 4, 8), i32(n, 4, 8), i32(n, 4), i32(n, 4), i32(n),
                               i32(n), i32(n, 2 * k + 5), s_pad=1024, k=k, impl="cuda")
        assert is_abstract(carry) and carry.shape == (n, 2 * k + 5)
        assert carry.dtype == torch.int32
        acc = score_blocks(None, None, i32(7), i32(7), i32(7), 0, s_pad=256, impl="cuda",
                           docs_format="packed", pack_words=i32(9), pack_dir=i32(7),
                           pack_firsts=i32(7))
        assert acc.shape == (256,) and acc.dtype == torch.int32
        bags = bag_reduce(torch.empty((5, 3, 16), dtype=torch.bfloat16),
                          torch.empty((5, 3), dtype=torch.bfloat16))
        assert bags.shape == (5, 16) and bags.dtype == torch.bfloat16
        del mode
    assert counts == {"traverse": 1, "unpack_locals": 1, "scatter_accumulate": 1,
                      "bag_reduce": 1}
    # On the meta device too; a launch is counted on the cuda route only
    # (the plain routes launch nothing), and the wrappers' own counters
    # never move.
    with launch_census() as counts:
        m = torch.empty((3, 2 * k + 5), dtype=torch.int32, device="meta")
        for impl in ("torch", "cuda"):
            out = traverse_lanes(None, *([m] * 6), m, s_pad=64, k=k, impl=impl)
            assert out.is_meta and out.shape == (3, 2 * k + 5)
        acc = score_blocks(None, None, m[0], m[0], m[0], 0, s_pad=64, impl="torch")
        assert acc.is_meta and acc.shape == (64,)
        bags = bag_reduce(torch.empty((5, 3, 16), device="meta"),
                          torch.empty((5, 3), device="meta"), impl="torch")
        assert bags.is_meta and bags.shape == (5, 16)
    assert counts == {"traverse": 1}
    assert (kernel.traverse.launches, kernel.scatter_accumulate.launches) == before
