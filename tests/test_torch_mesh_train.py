"""The port's sharded train step and elastic restore, on the CPU.

One gloo group of 8 CPU ranks (this file run as a script, JAX-free on the
rank side) and one JAX subprocess (``--xla_force_host_platform_device_count
=8``) start from one pickle of numpy weights and batches, float32:

  * the reduced qwen3-4b ``train_4k`` step on the reference's 2 x 4 (data x
    model) mesh, three steps: parameters placed by ``param_pspecs``, the
    ZeRO-1 optimizer state by ``zero1_state_specs`` (fp32 and bf16
    moments), the batch by ``batch_pspecs``; held against the reference's
    SINGLE-DEVICE step (its own sharded step raises ``ShardingTypeError``,
    ROADMAP C4): loss rel < 1e-4, every parameter (``embed`` named) within
    rtol 2e-4 / atol 2e-5; the reduced qwen2.5-3b (QKV bias) the same;
  * the towers' ``train_batch`` steps on 2 x 4 (row-sharded tables, MIND's
    in-batch softmax over the gathered targets) against the reference's
    single-device steps, and GraphSAGE's ``variant="sharded"`` step on a
    4 x 2 mesh against the port's one-device baseline step (only the
    bfloat16 gather of hidden rows differs);
  * the elastic restore: three steps on a 2 x 2 mesh of ranks 0-3, the
    state gathered and saved in the reference's format, restored with
    ``shardings`` onto 4 x 1 (exactly the saved arrays), then one more
    step there against the uninterrupted 2 x 2 run; the reference's
    ``Checkpointer`` reads the same checkpoint.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 240
LMS = ("qwen3-4b", "qwen2.5-3b")
TOWERS = ("bst", "mind", "autoint", "bert4rec")
STEPS = 3


def make_inputs() -> dict:
    """Weights and per-step batches as numpy, the reference's trees."""
    import jax

    from repro.configs.registry import ARCHS

    rng = np.random.default_rng(0)

    def draw(arch, cfg, scale):
        shapes = jax.eval_shape(lambda: arch.init_params(jax.random.key(0), cfg))
        return jax.tree.map(lambda s: rng.normal(0, scale, s.shape).astype(np.float32), shapes)

    out = {}
    for name in (*LMS, *TOWERS):
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        shape = "train_4k" if arch.family == "lm" else "train_batch"
        out[name] = dict(params=draw(arch, cfg, 0.1 if arch.family == "lm" else 0.5),
                         batches=[arch.make_batch(cfg, shape, seed=s) for s in range(4)])
    return out


_REF = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import ARCHS
from repro.optim.adamw import AdamWConfig, init_opt_state

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name in sys.argv[3].split(","):
    arch = ARCHS[name]
    cfg = arch.model_config(reduced=True)
    shape = "train_4k" if arch.family == "lm" else "train_batch"
    p = jax.tree.map(jnp.asarray, inp[name]["params"])
    runs = {}
    for md in (("fp32", "bf16") if arch.family == "lm" else ("fp32",)):
        arch._moments = md  # the LM's moment dtype, as the port's run sets it
        step, _ = arch.build_step(cfg, shape)
        step = jax.jit(step)
        pp, o = p, init_opt_state(p, AdamWConfig(moment_dtype=md))
        hist = []
        for s in range(len(inp[name]["batches"]) - 1):
            pp, o, m = step(pp, o, jax.tree.map(jnp.asarray, inp[name]["batches"][s]))
            hist.append((float(m["loss"]), float(m["grad_norm"]), jax.tree.map(np.asarray, pp)))
        runs[md] = hist
    out[name] = runs
pickle.dump(out, open(sys.argv[2], "wb"))
print("REF_OK")
"""


def _reference(inputs: Path, out: Path, names) -> subprocess.Popen:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", _REF, str(inputs), str(out),
                             ",".join(names)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# --------------------------------------------------------------------------
# The port: 8 gloo ranks
# --------------------------------------------------------------------------


def _lm_runs(ms, inp, out):
    import torch

    from repro_torch.configs.registry import ARCHS
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer

    mesh = ms.make_mesh((2, 4), ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    for name in LMS:
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        specs = arch.param_pspecs(cfg, None)
        for md in ("fp32", "bf16"):
            arch._moments = md
            step, kind = arch.build_step(cfg, "train_4k", ctx)
            p = ms.place_tree(arch.params_from_numpy(inp[name]["params"], cfg, "cpu"), specs,
                              mesh)
            o = trainer.init_zero1_state(p, AdamWConfig(moment_dtype=md), specs, ctx)
            hist = []
            for s in range(STEPS):
                b = ms.place_tree(inp[name]["batches"][s],
                                  arch.batch_pspecs(cfg, "train_4k", ctx), mesh)
                p, o, m = step(p, o, b)
                hist.append((float(m["loss"]), float(m["grad_norm"]),
                             arch.params_to_numpy(ms.gather_tree(p, specs, mesh))))
            out[name, md] = hist
            if md == "fp32":  # a root gather (one dist.gather a leaf) == the all-gather
                full = ms.gather_tree(p, specs, mesh)
                rooted = ms.gather_tree(p, specs, mesh, root=0)
                go = trainer.gather_opt_state(o, p, specs, ctx)
                ro = trainer.gather_opt_state(o, p, specs, ctx, root=0)
                again = trainer.place_opt_state(go, p, specs, ctx)  # global -> ZeRO-1 parts
                out[name, "replace"] = all(torch.equal(again[k][n], o[k][n])
                                           for k in ("m", "v") for n in o[k])
                if rooted is not None:
                    out[name, "root"] = all(
                        torch.equal(a, b.cpu()) for a, b in zip(
                            rooted.parameters(), full.parameters())) and all(
                        torch.equal(ro[k][n], go[k][n].cpu()) for k in ("m", "v")
                        for n in go[k])
        arch._moments = "fp32"
        out[name, "kind"] = kind
        try:  # int8 moments are sliced over data ranks as zero1_state_specs says
            o8 = trainer.init_zero1_state(p, AdamWConfig(moment_dtype="int8"), specs, ctx)
            out[name, "int8"] = sorted({str(v["q"].dtype) for v in o8["m"].values()
                                        if isinstance(v, dict)})
        except ValueError as e:
            out[name, "int8"] = str(e)


def _tower_runs(ms, inp, out):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer

    mesh = ms.make_mesh((2, 4), ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    for name in TOWERS:
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        p = arch.params_from_numpy(inp[name]["params"], cfg, "cpu")
        specs = arch.param_pspecs(cfg, p)
        p = ms.place_tree(p, specs, mesh)
        step, _ = arch.build_step(cfg, "train_batch", ctx)
        o = trainer.init_zero1_state(p, AdamWConfig(), specs, ctx)
        hist = []
        for s in range(STEPS):
            b = ms.place_tree(inp[name]["batches"][s],
                              arch.batch_pspecs(cfg, "train_batch", ctx), mesh)
            p, o, m = step(p, o, b)
            hist.append((float(m["loss"]), float(m["grad_norm"]),
                         arch.params_to_numpy(ms.gather_tree(p, specs, mesh))))
        out[name] = hist


def _gnn_runs(ms, out):
    import copy

    from repro_torch.configs.registry import ARCHS
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train import trainer

    mesh = ms.make_mesh((4, 2), ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    arch = ARCHS["graphsage-reddit"]
    cfg = arch.model_config(reduced=True)
    # ogb_products' reduced graph: 400 nodes in four blocks of 128 (the
    # last mostly padding), its edges in bins of 1.3x headroom.
    rcfg = arch._resolved(cfg, "ogb_products")
    one = arch.init_params(0, rcfg, device="cpu")
    base_step, _ = arch.build_step(cfg, "ogb_products")
    p1 = copy.deepcopy(one)
    o1 = init_opt_state(p1, AdamWConfig())
    batch = arch.make_batch(cfg, "ogb_products")
    specs = arch.param_pspecs(rcfg, None)
    step, _ = arch.build_step(cfg, "ogb_products", ctx, variant="sharded")
    p2 = ms.place_tree(copy.deepcopy(one), specs, mesh)
    o2 = trainer.init_zero1_state(p2, AdamWConfig(), specs, ctx)
    sharded = arch.sharded_batch(cfg, "ogb_products", 4, device="cpu")
    b2 = ms.place_tree(sharded, arch.batch_pspecs(cfg, "ogb_products", ctx, "sharded"), mesh)
    hist = []
    for _ in range(STEPS):
        p1, o1, m1 = base_step(p1, o1, batch)
        p2, o2, m2 = step(p2, o2, b2)
        hist.append((float(m1["loss"]), float(m2["loss"]), arch.params_to_numpy(p1),
                     arch.params_to_numpy(ms.gather_tree(p2, specs, mesh))))
    out["gnn"] = hist
    # The baseline variant on the mesh: nodes replicated, edges sharded.
    p3 = ms.place_tree(copy.deepcopy(one), specs, mesh)
    batch = arch.make_batch(cfg, "full_graph_sm")
    one = arch.init_params(0, arch._resolved(cfg, "full_graph_sm"), device="cpu")
    specs = arch.param_pspecs(arch._resolved(cfg, "full_graph_sm"), None)
    p3 = ms.place_tree(copy.deepcopy(one), specs, mesh)
    base_step, _ = arch.build_step(cfg, "full_graph_sm")
    o3 = trainer.init_zero1_state(p3, AdamWConfig(), specs, ctx)
    step3, _ = arch.build_step(cfg, "full_graph_sm", ctx)
    b3 = ms.place_tree(batch, arch.batch_pspecs(cfg, "full_graph_sm", ctx), mesh)
    p4 = copy.deepcopy(one)
    o4 = init_opt_state(p4, AdamWConfig())
    p3, o3, m3 = step3(p3, o3, b3)
    p4, o4, m4 = base_step(p4, o4, batch)
    out["gnn_base"] = (float(m4["loss"]), float(m3["loss"]), arch.params_to_numpy(p4),
                       arch.params_to_numpy(ms.gather_tree(p3, specs, mesh)))


def _restore_run(ms, inp, tmp, out):
    """2 x 2 for three steps, save, restore onto 4 x 1, one more step; and
    the uninterrupted 2 x 2 run's fourth step."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCHS
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import Checkpointer

    name = "qwen3-4b"
    arch = ARCHS[name]
    cfg = arch.model_config(reduced=True)
    specs = arch.param_pspecs(cfg, None)
    opt = AdamWConfig()
    m22, m41 = ms.make_mesh((2, 2), ("data", "model")), ms.make_mesh((4, 1), ("data", "model"))
    # Four rows a step, so that the batch splits over four data ranks.
    batches = [{"tokens": np.concatenate([inp[name]["batches"][s]["tokens"],
                                          inp[name]["batches"][(s + 1) % 4]["tokens"]])}
               for s in range(4)]
    if m22.get_coordinate() is None:  # ranks 4-7 take no part
        dist.barrier()
        dist.barrier()
        return
    ctx = ms.ShardCtx(m22)
    step, _ = arch.build_step(cfg, "train_4k", ctx)
    p = ms.place_tree(arch.params_from_numpy(inp[name]["params"], cfg, "cpu"), specs, m22)
    o = trainer.init_zero1_state(p, opt, specs, ctx)
    bspec = arch.batch_pspecs(cfg, "train_4k", ctx)
    for s in range(STEPS):
        p, o, _ = step(p, o, ms.place_tree(batches[s], bspec, m22))
    gp = ms.gather_tree(p, specs, m22)
    go = trainer.gather_opt_state(o, p, specs, ctx)
    saved = {"params": arch.params_to_numpy(gp), "opt_state": arch.opt_state_to_numpy(go)}
    ck = Checkpointer(str(tmp / "ck"))
    if dist.get_rank() == 0:
        ck.save(saved, step=STEPS, blocking=True)
    dist.barrier()
    # The uninterrupted run's fourth step.
    p, o, m = step(p, o, ms.place_tree(batches[STEPS], bspec, m22))
    out["restore", "uninterrupted"] = (float(m["loss"]), arch.params_to_numpy(
        ms.gather_tree(p, specs, m22)))
    # Onto 4 x 1.
    ctx4 = ms.ShardCtx(m41)
    shapes = arch.param_shapes(cfg)
    o_specs = trainer.zero1_state_specs(specs, shapes, trainer.init_opt_state(shapes, opt),
                                        4, ("data",), {"data": 4, "model": 1})
    shard = {"params": specs, "opt_state": o_specs}
    shardings = _named(ms, shard, m41)
    tree = ck.restore(STEPS, shardings=shardings)
    back = ms.gather_tree(tree, shard, m41)
    out["restore", "saved"] = saved
    out["restore", "back"] = _to_numpy(back)
    p4 = __import__("repro_torch.models.layers", fromlist=["params_from_tree"]
                    ).params_from_tree(tree["params"], "cpu", stacked=arch.stacked)
    o4 = trainer.opt_state_from_tree(tree["opt_state"], arch.stacked, "cpu",
                                     specs=o_specs, mesh=m41)
    step4, _ = arch.build_step(cfg, "train_4k", ctx4)
    p4, o4, m4 = step4(p4, o4, ms.place_tree(batches[STEPS],
                                              arch.batch_pspecs(cfg, "train_4k", ctx4), m41))
    out["restore", "resumed"] = (float(m4["loss"]), arch.params_to_numpy(
        ms.gather_tree(p4, specs, m41)))
    out["restore", "blocks"] = {n: tuple(o4["m"][n].shape) for n in (
        "embed", "dense.0.ffn.w_gate", "dense.1.attn.k_norm")}
    dist.barrier()


def _named(ms, specs, mesh):
    if isinstance(specs, ms.P):
        return ms.NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named(ms, v, mesh) for k, v in specs.items()}
    return [_named(ms, v, mesh) for v in specs]


def _to_numpy(tree):
    from repro_torch.models.layers import host_array

    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return host_array(tree)


def _rank_main(rank: str, world: str, init: str, inputs: str, path: str) -> None:
    import torch

    from repro_torch.distributed import sharding as ms

    torch.set_num_threads(1)
    rt = ms.init_mesh_group(device="cpu", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world), timeout_s=GROUP_TIMEOUT_S - 30)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    out: dict = {}
    _lm_runs(ms, inp, out)
    _tower_runs(ms, inp, out)
    _gnn_runs(ms, out)
    _restore_run(ms, inp, Path(path).parent, out)
    if rt.rank == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    ms.close_mesh_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
    sys.exit(0)


def _spawn_group(world: int, tmp: Path, inputs: Path):
    init, path = tmp / "group.init", tmp / "port.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(init), str(inputs), str(path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)], path


def _wait(procs) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return logs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the port's answers on 8 ranks, the reference's single-device runs,
    the run directory)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(make_inputs(), f)
    refs = [_reference(tmp / "inputs.pkl", tmp / f"ref{i}.pkl", names)
            for i, names in enumerate((LMS, TOWERS))]
    procs, port_path = _spawn_group(8, tmp, tmp / "inputs.pkl")
    _wait(procs)
    want = {}
    for i, ref in enumerate(refs):
        log = _wait([ref])[0]
        assert "REF_OK" in log, log[-3000:]
        with open(tmp / f"ref{i}.pkl", "rb") as f:
            want.update(pickle.load(f))
    with open(port_path, "rb") as f:
        got = pickle.load(f)
    return got, want, tmp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _close_trees(got, want, rtol, atol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", LMS)
@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_sharded_lm_step_matches_reference_single_device(run, name, moments):
    """Three ZeRO-1 steps on 2 x 4 against the reference's single-device
    steps: loss rel < 1e-4, ``embed`` (and every other parameter) within
    rtol 2e-4 / atol 2e-5."""
    got, want, _ = run
    for (gl, gn, gp), (wl, wn, wp) in zip(got[name, moments], want[name][moments]):
        assert abs(gl - wl) / abs(wl) < 1e-4
        assert abs(gn - wn) / abs(wn) < 1e-4
        np.testing.assert_allclose(gp["embed"], wp["embed"], rtol=2e-4, atol=2e-5)
        _close_trees(gp, wp, 2e-4, 2e-5)
    assert got[name, "kind"] == "train"
    assert got[name, "root"] is True  # gathers onto rank 0's host give the same arrays
    assert got[name, "replace"] is True  # the gathered state placed again: the same parts


@pytest.mark.parametrize("name", LMS)
def test_int8_moments_over_data_ranks_raise(run, name):
    """Int8 moments under ZeRO-1 on 2 x 4 no longer raise: the state holds
    int8 blocks laid out by ``zero1_state_specs`` (the steps themselves
    against the reference's: tests/test_torch_mesh_fsdp.py)."""
    got, _, _ = run
    assert got[name, "int8"] == ["torch.int8"]


@pytest.mark.parametrize("name", TOWERS)
def test_sharded_tower_steps_match_reference_single_device(run, name):
    got, want, _ = run
    for (gl, gn, gp), (wl, wn, wp) in zip(got[name], want[name]["fp32"]):
        assert abs(gl - wl) / abs(wl) < 1e-4
        assert abs(gn - wn) / abs(wn) < 1e-4
        _close_trees(gp, wp, 2e-4, 2e-5)


def test_sharded_graphsage_step_matches_one_device(run):
    """``variant="sharded"`` on 4 x 2 against the one-device baseline step:
    the losses within the bfloat16 gather's error, the parameters close."""
    got, _, _ = run
    for l1, l2, p1, p2 in got["gnn"]:
        assert abs(l1 - l2) / abs(l1) < 1e-2
        _close_trees(p2, p1, 2e-2, 2e-3)


def test_graphsage_baseline_on_a_mesh_matches_one_device(run):
    """The baseline variant with a context: edges sharded over data, the
    aggregate completed by a psum; float32 throughout."""
    got, _, _ = run
    l1, l2, p1, p2 = got["gnn_base"]
    assert abs(l1 - l2) / abs(l1) < 1e-5
    _close_trees(p2, p1, 1e-4, 1e-5)


def test_elastic_restore_gives_back_the_saved_state(run):
    got, _, _ = run
    saved, back = got["restore", "saved"], got["restore", "back"]
    g, w = dict(_leaves(back)), dict(_leaves(saved))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_step_after_elastic_restore_matches_uninterrupted_run(run):
    """The fourth step on 4 x 1 from the restored state against the fourth
    step of the 2 x 2 run (another mesh: float32 sums in another order)."""
    got, _, _ = run
    l1, p1 = got["restore", "uninterrupted"]
    l2, p2 = got["restore", "resumed"]
    assert abs(l1 - l2) / abs(l1) < 1e-5
    _close_trees(p2, p1, 1e-4, 1e-5)
    # Rank 0's ZeRO-1 parts on 4 x 1: a quarter of the rows of embed [512,
    # 64] and of each layer's w_gate [64, 128] (the stack of 2 layers does
    # not split four ways), and of k_norm [16].
    assert got["restore", "blocks"] == {"embed": (128, 64), "dense.0.ffn.w_gate": (16, 128),
                                        "dense.1.attn.k_norm": (4,)}


def test_reference_reads_the_port_mesh_checkpoint(run):
    from repro.train.checkpoint import Checkpointer as RefCheckpointer

    got, _, tmp = run
    tree = RefCheckpointer(str(tmp / "ck")).restore(STEPS)
    g, w = dict(_leaves(tree)), dict(_leaves(got["restore", "saved"]))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=k)
