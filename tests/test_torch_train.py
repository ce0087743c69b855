"""The port's training loop and checkpoints against the reference's.

On the CPU, both packages from one state (the reference's parameters,
carried with ``Arch.params_from_numpy``), GraphSAGE's reduced ``molecule``
shape and the reduced qwen3-4b:

  * ``Trainer``: a run's history (loss, grad_norm a step), exit, last step
    and final parameters (after an update as ``_close_updated`` says); a
    resume from step 2 of a 4-step run continues with the uninterrupted
    run's losses (the port's own bit for bit, the
    reference's within rtol 1e-4 / atol 1e-5), also across packages (either
    package resumes the other's checkpoint); a preemption flag at step 3
    leaves a checkpoint of step 3 and exits ``preempted``;
  * ``make_train_step``'s ``accum``: with ``accum = 1`` the gradients keep
    the parameters' dtype (bfloat16), with ``accum = 2`` they are a float32
    sum divided by 2; a linear loss (exact gradients) pins the rule bit for
    bit, the reduced LM at ``accum = 2`` within the tolerance;
  * checkpoints: the same tree saved by both gives the same manifest and
    byte-equal ``.npy`` members (a bfloat16 leaf as ``'<V2'`` bits); each
    package restores the other's; the reference's restore gives a bfloat16
    leaf back as ``|V2`` (ROADMAP C4) and the port's as bfloat16 with the
    same bits; ``keep_last``, invisible partial writes, and a restore onto
    a mesh raising A7;
  * ``launch/train`` on the CPU: a run, a resume, the reference's launcher
    resuming the port's checkpoint, and the final step saved twice when
    ``--steps`` is a multiple of ``--ckpt-every`` (both packages).
"""

from __future__ import annotations

import json
import os
import signal
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.launch import train as ref_launch
from repro.models import gnn as ref_gnn
from repro.models import transformer as ref_tfm
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.train import trainer as ref_trainer
from repro.train.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import train as launch
from repro_torch.models import gnn, transformer
from repro_torch.models.layers import params_from_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer
from repro_torch.train.checkpoint import Checkpointer

RTOL, ATOL = 1e-4, 1e-5


def _ref_init(ref, cfg):
    """The reference's parameters (jitted: eager initialisation is slow)."""
    return jax.jit(ref.init_params, static_argnums=1)(jax.random.key(0), cfg)
GNN = "graphsage-reddit"
SHAPE = "molecule"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    return {prefix: np.asarray(tree)}


def _close_updated(got, want, lr, what=""):
    """Parameters after AdamW updates: within rtol 1e-4 / atol 1e-5, except
    elements whose gradient lies within the gradients' float32 error of 0.
    Such an element's update ``lr (g / (|g| + eps) + wd p)`` may take either
    sign, but it is bounded by lr (1 + wd |p|) in each package: these (at
    most 0.1% of a leaf) are held within 2.2 lr a step taken."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert off.mean() <= 1e-3, (what, off.mean())
    assert np.abs(got - want).max() <= max(ATOL + RTOL * np.abs(want).max(), 2.2 * lr), what


def _sage():
    """Reduced GraphSAGE molecule: (reference params, loss, port loss, data_fn)."""
    ref, arch = REF_ARCHS[GNN], ARCHS[GNN]
    rcfg = ref._resolved(ref.model_config(True), SHAPE)
    pcfg = arch._resolved(arch.model_config(True), SHAPE)
    tree = jax.tree.map(np.asarray, _ref_init(ref, rcfg))

    def rloss(p, b):
        return ref_gnn.sage_loss(ref_gnn.sage_forward_graphs(
            p, b["feats"], b["edges"], b["graph_ids"], b["labels"].shape[0], rcfg), b["labels"])

    def ploss(p, b):
        return gnn.sage_loss(gnn.sage_forward_graphs(
            p, b["feats"], b["edges"], b["graph_ids"], b["labels"].shape[0], pcfg), b["labels"])

    def data_fn(step):
        return ref.make_batch(ref.model_config(True), SHAPE, seed=step)

    return tree, rloss, ploss, data_fn


def _cfg(**kw):
    base = dict(total_steps=4, log_every=1, checkpoint_every=2, lr=1e-2, warmup=2)
    base.update(kw)
    return base


def _both(tmp_path, tag, ckpt=True, **kw):
    tree, rloss, ploss, data_fn = _sage()
    rck = RefCheckpointer(str(tmp_path / f"ref_{tag}")) if ckpt else None
    pck = Checkpointer(str(tmp_path / f"port_{tag}")) if ckpt else None
    rt = ref_trainer.Trainer(rloss, jax.tree.map(jnp.asarray, tree),
                             ref_trainer.TrainerConfig(**_cfg(**kw)), data_fn, rck)
    pt = trainer.Trainer(ploss, params_from_tree(tree, "cpu"),
                         trainer.TrainerConfig(**_cfg(**kw)), data_fn, pck)
    return rt, pt, rck, pck


def _same_history(got, want, exact=False):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            if exact:
                assert g[k] == w[k], (g["step"], k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


def _drop(ck, step):
    import shutil
    shutil.rmtree(os.path.join(ck.dir, f"step_{step:08d}"))


def test_trainer_run_is_the_references(tmp_path):
    rt, pt, _, _ = _both(tmp_path, "run", ckpt=False, total_steps=5)
    rout, pout = rt.run(install_signal_handlers=False), pt.run(install_signal_handlers=False)
    for k in ("exit", "last_step", "slow_steps"):
        assert pout[k] == rout[k]
    _same_history(pout["history"], rout["history"])
    got = _flat(ARCHS[GNN].params_to_numpy(pt.params))
    for k, w in _flat(jax.tree.map(np.asarray, rt.params)).items():
        _close_updated(got[k], w, 5 * 1e-2, k)
    assert int(pt.opt_state["step"]) == int(rt.opt_state["step"]) == 5
    assert pt.history is pout["history"] and all(not p.requires_grad
                                                  for p in pt.params.parameters())


def test_trainer_watchdog_counts_slow_steps(tmp_path):
    _, pt, _, _ = _both(tmp_path, "slow", ckpt=False, total_steps=3, step_timeout_s=1e-9)
    assert pt.run(install_signal_handlers=False)["slow_steps"] == 3


def test_trainer_resume_continues_the_uninterrupted_run(tmp_path):
    rt, pt, rck, pck = _both(tmp_path, "u")
    rout, pout = rt.run(install_signal_handlers=False), pt.run(install_signal_handlers=False)
    assert pck.list_steps() == rck.list_steps() == [2, 4]
    for ck in (rck, pck):
        _drop(ck, 4)
    # Each package resumes its own checkpoint of step 2 ...
    rt2, pt2, _, _ = _both(tmp_path, "u")
    rt2.checkpointer, pt2.checkpointer = rck, pck
    r2, p2 = rt2.run(install_signal_handlers=False), pt2.run(install_signal_handlers=False)
    assert [h["step"] for h in p2["history"]] == [3, 4]
    _same_history(p2["history"], pout["history"][2:], exact=True)
    _same_history(r2["history"], rout["history"][2:])
    _same_history(p2["history"], r2["history"])
    # ... and the other's.
    for ck in (rck, pck):
        _drop(ck, 4)
    rt3, pt3, _, _ = _both(tmp_path, "x", ckpt=False)
    rt3.checkpointer = RefCheckpointer(pck.dir)
    pt3.checkpointer = Checkpointer(rck.dir)
    r3, p3 = rt3.run(install_signal_handlers=False), pt3.run(install_signal_handlers=False)
    _same_history(p3["history"], pout["history"][2:])
    _same_history(r3["history"], rout["history"][2:])


def test_trainer_preemption_checkpoints_and_exits(tmp_path):
    rt, pt, rck, pck = _both(tmp_path, "p", checkpoint_every=100)
    for t in (rt, pt):
        orig = t.data_fn

        def data_fn(step, t=t, orig=orig):
            if step == 2:  # during the third step
                t._handle_preemption(signal.SIGTERM, None)
            return orig(step)

        t.data_fn = data_fn
    rout, pout = rt.run(install_signal_handlers=False), pt.run(install_signal_handlers=False)
    assert pout["exit"] == rout["exit"] == "preempted"
    assert pout["last_step"] == rout["last_step"] == 3
    assert pck.list_steps() == rck.list_steps() == [3]
    got = _flat(pck.restore(3, device="cpu"))
    want = _flat(rck.restore(3))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(got["opt_state/step/"]) == 3


def _linear(lib):
    def loss(p, b):
        x, y = b["x"], b["y"]
        if lib is torch:
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            return torch.sum(p["w"].float() * x) + torch.sum(p["b"] * y)
        return jnp.sum(p["w"].astype(jnp.float32) * x) + jnp.sum(p["b"] * y)
    return loss


@pytest.mark.parametrize("accum", [1, 2])
def test_accumulated_gradients_take_the_references_dtype(accum):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 300)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    lead = (accum,) if accum > 1 else ()
    batch = {"x": (rng.standard_normal((*lead, 4, 300)) * 1e-3).astype(np.float32),
             "y": (rng.standard_normal((*lead, 7)) * 1e-3).astype(np.float32)}
    rstep = ref_trainer.make_train_step(_linear(jnp), RefAdamW(), accum=accum)
    pstep = trainer.make_train_step(_linear(torch), AdamWConfig(), accum=accum)
    rp = jax.tree.map(jnp.asarray, tree)
    from repro.optim.adamw import init_opt_state as ref_init
    from repro_torch.optim.adamw import init_opt_state
    rs = ref_init(rp, RefAdamW())
    params = params_from_tree(tree, "cpu")
    ps = init_opt_state(params, AdamWConfig())
    rp, rs, rm = rstep(rp, rs, batch)
    params, ps, pm = pstep(params, ps, batch)
    assert float(rm["grad_norm"]) < 1.0  # no clipping: the update is exact
    assert params["w"].dtype == torch.bfloat16
    want = _flat(jax.tree.map(np.asarray, {"p": rp, "s": rs}))
    got = _flat({"p": ARCHS[GNN].params_to_numpy(params),
                 "s": ARCHS[GNN].opt_state_to_numpy(ps)})
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-6)
    assert float(pm["lr"]) == float(rm["lr"])


def test_lm_step_with_accumulation_is_the_references():
    name = "qwen3-4b"
    ref, arch = REF_ARCHS[name], ARCHS[name]
    rcfg, pcfg = ref.model_config(True), arch.model_config(True)
    tree = jax.tree.map(np.asarray, _ref_init(ref, rcfg))
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, size=(2, 2, 64)).astype(np.int32)
    rstep = jax.jit(ref_trainer.make_train_step(
        lambda p, b: ref_tfm.lm_loss(p, b["tokens"], rcfg), RefAdamW(), accum=2))
    pstep = trainer.make_train_step(
        lambda p, b: transformer.lm_loss(p, b["tokens"], pcfg), AdamWConfig(), accum=2)
    from repro.optim.adamw import init_opt_state as ref_init
    from repro_torch.optim.adamw import init_opt_state
    rp = jax.tree.map(jnp.asarray, tree)
    rp, rs, rm = rstep(rp, ref_init(rp, RefAdamW()), {"tokens": tokens})
    params = arch.params_from_numpy(tree, pcfg, device="cpu")
    params, ps, pm = pstep(params, init_opt_state(params, AdamWConfig()), {"tokens": tokens})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=RTOL, atol=ATOL)
    got = _flat(arch.params_to_numpy(params))
    for k, w in _flat(jax.tree.map(np.asarray, rp)).items():
        _close_updated(got[k], w, float(rm["lr"]), k)


# -------------------------------------------------------------- checkpoints


def _state():
    """A reduced LM's parameters and a bf16-moment state, the reference's
    tree (bfloat16 as ``ml_dtypes``), plus a bfloat16 parameter."""
    from repro.optim.adamw import init_opt_state as ref_init
    ref = REF_ARCHS["deepseek-v3-671b"]
    tree = jax.tree.map(np.asarray, _ref_init(ref, ref.model_config(True)))
    tree["extra_bf16"] = np.random.default_rng(1).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    opt = jax.tree.map(np.asarray, ref_init(tree, RefAdamW(moment_dtype="bf16")))
    opt["m"]["embed"] = np.random.default_rng(2).standard_normal(
        tree["embed"].shape).astype(ml_dtypes.bfloat16)
    opt["step"] = np.int32(7)
    return {"params": tree, "opt_state": opt}


def _members(path):
    with zipfile.ZipFile(os.path.join(path, "shard0.npz")) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_checkpoint_format_is_the_references_both_ways(tmp_path):
    state = _state()
    RefCheckpointer(str(tmp_path / "ref")).save(state, step=5, blocking=True)
    # The port saves its own copy: the parameters and moments as tensors.
    arch = ARCHS["deepseek-v3-671b"]
    cfg = arch.model_config(True)
    params = params_from_tree(state["params"], "cpu", stacked=arch.stacked)
    opt = arch.opt_state_from_numpy(state["opt_state"], cfg, device="cpu")
    assert opt["m"]["embed"].dtype == torch.bfloat16
    Checkpointer(str(tmp_path / "port")).save(
        {"params": arch.params_to_numpy(params), "opt_state": arch.opt_state_to_numpy(opt)},
        step=5, blocking=True)
    rdir, pdir = tmp_path / "ref" / "step_00000005", tmp_path / "port" / "step_00000005"
    assert json.loads((pdir / "manifest.json").read_text()) == json.loads(
        (rdir / "manifest.json").read_text())
    assert json.loads((pdir / "manifest.json").read_text())["arrays"][
        "params/extra_bf16"]["dtype"] == "bfloat16"
    rm, pm = _members(rdir), _members(pdir)
    assert rm.keys() == pm.keys()
    for k in rm:
        assert pm[k] == rm[k], k
    assert b"'descr': '<V2'" in pm["params/extra_bf16.npy"]
    # The reference restores the port's checkpoint, the port the reference's.
    want = _flat(state)
    back = _flat(RefCheckpointer(str(tmp_path / "port")).restore(5))
    mine = _flat(Checkpointer(str(tmp_path / "ref")).restore(5, device="cpu"))
    for k, w in want.items():
        assert np.asarray(back[k]).tobytes() == w.tobytes(), k
        t = mine[k]
        if w.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            assert t.view(torch.int16).numpy().tobytes() == w.tobytes(), k
        else:
            assert t.numpy().dtype == w.dtype and t.numpy().tobytes() == w.tobytes(), k


def test_reference_restores_bfloat16_as_void(tmp_path):
    """The reference's property (ROADMAP C4): its restore gives a bfloat16
    leaf back as a ``|V2`` array, which JAX refuses; the port's gives
    bfloat16 with the same bits."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    RefCheckpointer(str(tmp_path)).save({"params": {"w": w}}, step=1, blocking=True)
    got = RefCheckpointer(str(tmp_path)).restore(1)["params"]["w"]
    assert got.dtype.kind == "V" and got.dtype.itemsize == 2 and got.tobytes() == w.tobytes()
    with pytest.raises(TypeError):
        jnp.asarray(got)
    mine = Checkpointer(str(tmp_path)).restore(1, device="cpu")["params"]["w"]
    assert mine.dtype == torch.bfloat16 and mine.float().tolist() == w.astype(
        np.float32).tolist()


def test_checkpoint_gc_atomicity_and_mesh_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3):
        ck.save({"w": torch.full((4,), float(s))}, step=s)
    ck.wait()
    assert ck.list_steps() == [2, 3]
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000010")  # no manifest: a write cut short
    assert ck.list_steps() == [2, 3]
    assert ck.restore_latest(device="cpu")["w"].tolist() == [3.0] * 4
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(device="cpu") is None
    with pytest.raises(NotImplementedError, match="A7"):
        ck.restore(3, shardings={"w": None})
    with pytest.raises(NotImplementedError, match="A7"):
        trainer.zero1_spec(None, (4,), 2, "data")
    with pytest.raises(NotImplementedError, match="A7"):
        trainer.zero1_state_specs(None, None, None, 2, "data")


def test_save_snapshots_the_state_before_it_changes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(1000)
    ck.save({"w": w}, step=1)
    w += 1.0  # training goes on in place while the writer runs
    ck.wait()
    assert not ck.restore(1, device="cpu")["w"].any()


# ---------------------------------------------------------------- launcher


def test_launch_train_runs_resumes_and_crosses(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--arch", GNN, "--shape", SHAPE, "--ckpt-dir", d, "--ckpt-every", "5"]
    launch.main([*args, "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out and "done" in out
    launch.main([*args, "--steps", "4", "--device", "cpu"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert Checkpointer(d).list_steps() == [3, 4]
    ref_launch.main([*args, "--steps", "6"])  # the reference resumes the port's run
    assert "resumed from step 4" in capsys.readouterr().out
    launch.main([*args, "--steps", "7", "--device", "cpu"])
    assert "resumed from step 6" in capsys.readouterr().out
    state = Checkpointer(d).restore(7, device="cpu")
    assert int(state["opt_state"]["step"]) == 7


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_launch_train_saves_the_last_step_twice(tmp_path, pkg):
    """With --steps a multiple of --ckpt-every the launcher saves the last
    step twice; the second rename fails in the writer thread and leaves its
    ``.tmp`` directory, the first copy stands (ROADMAP C4)."""
    d = str(tmp_path / "ck")
    args = ["--arch", GNN, "--shape", SHAPE, "--ckpt-dir", d, "--ckpt-every", "2",
            "--steps", "2"]
    if pkg == "ref":
        ref_launch.main(args)
    else:
        launch.main([*args, "--device", "cpu"])
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000002.tmp"]
