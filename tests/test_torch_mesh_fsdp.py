"""Int8 moments under ZeRO-1 on many data ranks, and FSDP, on the CPU.

One gloo group of 8 CPU ranks (this file run as a script, JAX-free on the
rank side) and one JAX subprocess start from one pickle of numpy weights
and batches (float32, reduced configs):

  * the reduced deepseek-v3 ``train_4k`` step with int8 moments laid out
    by ``zero1_state_specs`` on 2 x 4 and on 4 x 2 (data x model): one step
    from a seeded state (parameters and moments) against the reference's
    single-device int8 step from the same state. Parameters within the
    float32 tolerance (rtol 2e-4 / atol 2e-5), each moment within one
    quantum (``q`` by at most 1, the decoded value by at most its block's
    scale: a few float32 ulps in the update move a value across a
    rounding edge of the int8 grid, the per-step rule of ROADMAP C4);
  * FSDP on 2 x 4: the reduced deepseek-67b and moonshot-v1-16b-a3b placed
    by ``fsdp_param_specs`` (``FSDP_MIN_SIZE`` 256, so that the reduced leaves
    split; the reference's 65,536 splits none of them) take two train steps
    and one prefill chunk from a seeded fp32 state three steps in, against
    the same step placed without FSDP and
    against the reference's single-device step, within the same float32
    tolerance (the prefill logits rtol 1e-4 / atol 1e-5). MoE runs without
    capacity drops (capacity factor = the expert count) in both packages:
    on a mesh the capacity is a data rank's, on one device the batch's;
  * the FSDP state after the first step saved through ``Checkpointer``
    (gathered on rank 0), restored with ``shardings`` by the FSDP specs
    (``params_from_tree``, ``opt_state_from_tree``: blocks that carry no
    trace of how they were placed) and stepped under the FSDP context:
    bitwise the live second step.
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
INT8 = "deepseek-v3-671b"
FSDP = ("deepseek-67b", "moonshot-v1-16b-a3b")
MESHES = ((2, 4), (4, 2))
FSDP_STEPS = 2
MIN_SIZE = 256


def make_inputs() -> dict:
    """Weights, an int8 moment state one step in, and batches, as numpy."""
    import jax

    from repro.configs.registry import ARCHS
    from repro.optim.adamw import _q8

    rng = np.random.default_rng(0)

    def draw(arch, cfg, scale):
        shapes = jax.eval_shape(lambda: arch.init_params(jax.random.key(0), cfg))
        return jax.tree.map(lambda s: rng.normal(0, scale, s.shape).astype(np.float32), shapes)

    out = {}
    for name in (INT8, *FSDP):
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        out[name] = dict(params=draw(arch, cfg, 0.1),
                         batches=[arch.make_batch(cfg, "train_4k", seed=s) for s in range(2)],
                         prefill=arch.make_batch(cfg, "prefill_32k", seed=7))
    # Four rows, so that the batch splits over 4 data ranks too.
    cfg = ARCHS[INT8].model_config(reduced=True)
    out[INT8]["batches"] = [{"tokens": rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)}]
    # Seeded states three steps in: m drawn, v within a factor 2 of its
    # block's max. From zero moments Adam's first steps are sign-like (an
    # element whose gradient is a few ulps from 0 steps by +-lr whichever
    # sign the reduction order gives it), and an int8 v of 0 makes the
    # update m / eps; neither is what these tests look at.
    for name in (INT8, *FSDP):
        p = out[name]["params"]
        m = jax.tree.map(lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32), p)
        v = jax.tree.map(lambda a: rng.uniform(0.5e-4, 1e-4, a.shape).astype(np.float32), p)
        if name == INT8:  # quantized by the reference's q8
            m, v = (jax.tree.map(lambda a: jax.tree.map(np.asarray, _q8(a)), t)
                    for t in (m, v))
        out[name]["opt"] = {"m": m, "v": v, "step": np.int32(3)}
    return out


_REF = r"""
import dataclasses, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import ARCHS
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name in sys.argv[3].split(","):
    arch = ARCHS[name]
    cfg = arch.model_config(reduced=True)
    if name != sys.argv[3].split(",")[0] and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    p = jax.tree.map(jnp.asarray, inp[name]["params"])
    step = jax.jit(arch.build_step(cfg, "train_4k")[0])
    o = jax.tree.map(jnp.asarray, inp[name]["opt"])
    if name == sys.argv[3].split(",")[0]:
        pp, o, m = step(p, o, jax.tree.map(jnp.asarray, inp[name]["batches"][0]))
        out[name] = dict(params=jax.tree.map(np.asarray, pp), opt=jax.tree.map(np.asarray, o),
                         loss=float(m["loss"]))
        continue
    hist, pp = [], p
    for b in inp[name]["batches"]:
        pp, o, m = step(pp, o, jax.tree.map(jnp.asarray, b))
        hist.append((float(m["loss"]), jax.tree.map(np.asarray, pp)))
    prefill = arch.build_step(cfg, "prefill_32k")[0]
    logits, _ = prefill(p, jax.tree.map(jnp.asarray, inp[name]["prefill"]))
    out[name] = dict(hist=hist, logits=np.asarray(logits))
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


def _int8_runs(ms, inp, out):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.train import trainer

    arch = ARCHS[INT8]
    cfg = arch.model_config(reduced=True)
    specs = arch.param_pspecs(cfg, None)
    for shape in MESHES:
        mesh = ms.make_mesh(shape, ("data", "model"))
        ctx = ms.ShardCtx(mesh)
        step, _ = arch.build_step(cfg, "train_4k", ctx)
        p = ms.place_tree(arch.params_from_numpy(inp[INT8]["params"], cfg, "cpu"), specs, mesh)
        o = trainer.place_opt_state(inp[INT8]["opt"], p, specs, ctx, "int8")
        b = ms.place_tree(inp[INT8]["batches"][0], arch.batch_pspecs(cfg, "train_4k", ctx), mesh)
        p, o, m = step(p, o, b)
        full = arch.params_to_numpy(ms.gather_tree(p, specs, mesh))
        state = trainer.gather_opt_state(o, p, specs, ctx, "int8")
        out[INT8, shape] = dict(params=full, loss=float(m["loss"]),
                                opt=arch.opt_state_to_numpy(state))


def no_drops(cfg):
    """``cfg`` with MoE capacity for every routed slot (no drops)."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _restored_step(ms, arch, cfg, p, o, specs, ctx, step, batch, directory):
    """The state (``p``, ``o``) saved from rank 0, restored onto ``ctx``'s
    mesh by ``specs`` with ``shardings`` and stepped: the gathered
    parameters after the step."""
    import torch.distributed as dist

    from repro_torch.models.layers import params_from_tree
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train import trainer
    from repro_torch.train.checkpoint import Checkpointer

    mesh, rt = ctx.mesh, ms.runtime()
    gp = ms.gather_tree(p, specs, mesh, root=0)
    go = trainer.gather_opt_state(o, p, specs, ctx, root=0)
    ck = Checkpointer(directory)
    if rt.rank == 0:
        ck.save({"params": arch.params_to_numpy(gp), "opt_state": arch.opt_state_to_numpy(go)},
                step=1, blocking=True)
    dist.barrier(group=rt.control)
    shapes = arch.param_shapes(cfg)
    o_specs = trainer.zero1_state_specs(
        specs, shapes, init_opt_state(shapes, AdamWConfig()), ctx.n_data, ctx.data_axes,
        dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))

    def named(t):
        if isinstance(t, ms.P):
            return ms.NamedSharding(mesh, t)
        if isinstance(t, dict):
            return {k: named(v) for k, v in t.items()}
        return [named(v) for v in t]

    tree = ck.restore(1, shardings=named({"params": specs, "opt_state": o_specs}))
    rp = params_from_tree(tree["params"], rt.device, stacked=arch.stacked)
    ro = trainer.opt_state_from_tree(tree["opt_state"], arch.stacked, rt.device,
                                     specs=o_specs, mesh=mesh)
    rp, _, _ = step(rp, ro, batch)
    dist.barrier(group=rt.control)
    return arch.params_to_numpy(ms.gather_tree(rp, specs, mesh))


def _fsdp_runs(ms, inp, out, directory):
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.train import trainer

    mesh = ms.make_mesh((2, 4), ("data", "model"))
    tp_ctx = ms.ShardCtx(mesh)
    for name in FSDP:
        arch = ARCHS[name]
        cfg = no_drops(arch.model_config(reduced=True))
        base = arch.param_pspecs(cfg, None)
        fsdp = trainer.fsdp_param_specs(arch, cfg, base, arch.param_shapes(cfg), tp_ctx)
        fsdp_ctx = dataclasses.replace(tp_ctx, fsdp_specs=fsdp)
        for tag, specs, ctx in (("fsdp", fsdp, fsdp_ctx), ("tp", base, tp_ctx)):
            step, _ = arch.build_step(cfg, "train_4k", ctx)
            p = ms.place_tree(arch.params_from_numpy(inp[name]["params"], cfg, "cpu"),
                              specs, mesh)
            prefill, _ = arch.build_step(cfg, "prefill_32k", ctx)
            pb = ms.place_tree(inp[name]["prefill"],
                               arch.batch_pspecs(cfg, "prefill_32k", ctx), mesh)
            logits, _ = prefill(p, pb)
            out[name, tag, "logits"] = ms.gather(logits, prefill.out_specs[0], mesh).numpy()
            o = trainer.place_opt_state(inp[name]["opt"], p, specs, ctx)
            hist = []
            for i, b in enumerate(inp[name]["batches"][:FSDP_STEPS]):
                b = ms.place_tree(b, arch.batch_pspecs(cfg, "train_4k", ctx), mesh)
                if tag == "fsdp" and i == 1:
                    out[name, "restored"] = _restored_step(
                        ms, arch, cfg, p, o, specs, ctx, step, b,
                        os.path.join(directory, f"ckpt-{name}"))
                p, o, m = step(p, o, b)
                hist.append((float(m["loss"]),
                             arch.params_to_numpy(ms.gather_tree(p, specs, mesh))))
            out[name, tag] = hist
            out[name, tag, "split"] = sorted(
                n for n, _ in p.named_parameters()
                if ctx.fsdp_specs is not None
                and any(e == ("data",) or e == "data"
                        for e in ms.spec_at(ctx.fsdp_specs, n.split("."))))


def _rank_main(rank: str, world: str, init: str, inputs: str, path: str) -> None:
    import torch

    from repro_torch.distributed import sharding as ms

    torch.set_num_threads(1)
    rt = ms.init_mesh_group(device="cpu", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world), timeout_s=GROUP_TIMEOUT_S - 30)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    out: dict = {}
    _int8_runs(ms, inp, out)
    from repro_torch.train import trainer

    trainer.FSDP_MIN_SIZE = MIN_SIZE  # this rank process's reduced leaves split too
    _fsdp_runs(ms, inp, out, os.path.dirname(path))
    if rt.rank == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    ms.close_mesh_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
    sys.exit(0)


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
    """(the port's answers on 8 ranks, the reference's single-device runs)."""
    tmp = tmp_path_factory.mktemp("mesh_fsdp")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(make_inputs(), f)
    ref = _reference(inputs, tmp / "ref.pkl", (INT8, *FSDP))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "8", str(tmp / "group.init"), str(inputs),
         str(tmp / "port.pkl")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(8)]
    _wait(procs)
    log = _wait([ref])[0]
    assert "REF_OK" in log, log[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        got = pickle.load(f)
    return got, want


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _close_trees(got, want, rtol=2e-4, atol=2e-5):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_int8_zero1_step_matches_reference_single_device(run, shape):
    got, want = run
    g, w = got[INT8, shape], want[INT8]
    assert abs(g["loss"] - w["loss"]) / abs(w["loss"]) < 1e-4
    _close_trees(g["params"], w["params"])
    gm, wm = dict(_leaves(g["opt"])), dict(_leaves(w["opt"]))
    assert gm.keys() == wm.keys()
    n_q = 0
    for k in wm:
        if k.endswith("/q"):
            n_q += 1
            sk = k[:-1] + "scale"
            assert gm[k].dtype == np.int8 and gm[k].shape == wm[k].shape, k
            assert gm[sk].shape == wm[sk].shape, sk
            d = np.abs(gm[k].astype(np.int32) - wm[k].astype(np.int32))
            assert d.max() <= 1, (k, int(d.max()))
            # decoded, within one quantum of the reference's
            dg, dw = gm[k] * gm[sk], wm[k] * wm[sk]
            assert np.all(np.abs(dg - dw) <= 1.001 * wm[sk] + 1e-30), k
    assert n_q > 0
    assert int(gm["step"]) == int(wm["step"]) == 4


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_steps_match_tp_and_reference_single_device(run, name):
    got, want = run
    assert got[name, "fsdp", "split"], "no leaf was split over data"
    assert got[name, "tp", "split"] == []
    for tag in ("fsdp", "tp"):
        for (gl, gp), (wl, wp) in zip(got[name, tag], want[name]["hist"]):
            assert abs(gl - wl) / abs(wl) < 1e-4
            _close_trees(gp, wp)
    for (fl, fp), (tl, tp) in zip(got[name, "fsdp"], got[name, "tp"]):
        assert abs(fl - tl) / abs(tl) < 1e-5
        _close_trees(fp, tp, 1e-4, 1e-5)


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_state_restored_from_checkpoint_steps_as_the_live_one(run, name):
    """Blocks restored by the FSDP specs carry nothing of their placement;
    the context's specs alone make the step gather and update them."""
    got, _ = run
    restored, live = dict(_leaves(got[name, "restored"])), dict(_leaves(got[name, "fsdp"][1][1]))
    assert restored.keys() == live.keys()
    for k in live:
        np.testing.assert_array_equal(restored[k], live[k], err_msg=k)


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_prefill_chunk_matches_tp_and_reference(run, name):
    got, want = run
    np.testing.assert_allclose(got[name, "fsdp", "logits"], want[name]["logits"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[name, "fsdp", "logits"], got[name, "tp", "logits"],
                               rtol=1e-4, atol=1e-5)
