"""Every ``train`` shape's ``Arch.build_step`` against the reference's.

The reference's own parameters and ``make_batch`` arrays (as in
tests/test_torch_train_archs.py, which holds each loss and gradient), on
the CPU, float32:

  * three steps of ``Arch.build_step`` (the reference's jitted): loss, lr,
    grad_norm and every parameter after each step within rtol 1e-4 / atol
    1e-5, except elements whose gradient lies within the gradients'
    float32 error of 0: such an element's update ``lr (g / (|g| + eps) + wd
    p)`` may take either sign, but it is bounded by lr (1 + wd |p|) in each
    package, so these (at most 0.1% of a leaf) are held within 2.2 lr a
    step taken. Under int8 moments (deepseek-v3's) a moment that lies within
    float32 ulps of a rounding boundary of its block may be stored one
    quantum apart by the two packages, and from the next step on that
    element's update may differ by any amount (a second moment rounded to
    0 divides the first by eps alone). So each step starts both packages
    from the reference's state; the stored int8 moments are held within one
    quantum, and the parameters within the tolerance except the elements
    whose stored second moment decodes to 0: their update divides the first
    moment by ``sqrt((1 - b2) g^2 / bc2)`` alone, which turns the
    gradients' float32 differences into any difference of the update;
  * the data copy ``data/graphs.py`` and ``GNNArch.make_batch`` array for
    array, and GraphSAGE's sharded variant on a one-process mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.data import graphs as ref_graphs
from repro.models import gnn as ref_gnn
from repro.optim import adamw as ref_adamw
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro_torch.configs.registry import ARCHS
from repro_torch.data import graphs
from repro_torch.models import gnn
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from train_cells import ATOL, CELLS, RTOL, _close, _flat, _losses, _ref_init, _start


@pytest.mark.parametrize("name,shape", CELLS)
def test_build_step_three_steps_are_the_references(name, shape):
    ref, arch = REF_ARCHS[name], ARCHS[name]
    tree, params, _ = _start(name, shape)
    _, _, rcfg, pcfg = _losses(name, shape)
    rstep, kind = ref.build_step(ref.model_config(True), shape)
    pstep, pkind = arch.build_step(arch.model_config(True), shape)
    assert kind == pkind == "train"
    md = ref.moment_dtype(rcfg) if ref.family == "lm" else "fp32"
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_init_opt_state(rp, RefAdamW(moment_dtype=md))
    ps = init_opt_state(params, AdamWConfig(moment_dtype=md))
    rstep = jax.jit(rstep)
    for i in range(3):
        batch = ref.make_batch(ref.model_config(True), shape, seed=10 + i)
        v0 = _flat(jax.tree.map(lambda s, p: np.asarray(ref_adamw._dq8(s, p)) == 0, rs["v"],
                                rp, is_leaf=ref_adamw.is_q8_leaf)) if md == "int8" else {}
        rp, rs, rm = rstep(rp, rs, batch)
        params, ps, pm = pstep(params, ps, batch)
        for k in ("loss", "lr", "grad_norm"):
            _close(pm[k], rm[k], f"step {i + 1} {k}")
        got = _flat(arch.params_to_numpy(params, pcfg))
        want = _flat(jax.tree.map(np.asarray, rp))
        for k in want:
            keep = ~v0.get(k, np.zeros(want[k].shape, bool)) if i else True
            assert np.isfinite(got[k]).all()
            g = np.where(keep, got[k], want[k])
            off = np.abs(g - want[k]) > ATOL + RTOL * np.abs(want[k])
            assert off.mean() <= 1e-3, (i, k, off.mean())
            lr_sum = 3 * float(rm["lr"]) if md != "int8" else float(rm["lr"])
            assert np.abs(g - want[k]).max() <= max(
                ATOL + RTOL * np.abs(want[k]).max(), 2.2 * lr_sum), (i, k)
        if md == "int8":
            gs = _flat(arch.opt_state_to_numpy(ps, pcfg))
            ws = _flat(jax.tree.map(np.asarray, rs))
            for k in ws:
                if ws[k].dtype == np.int8:
                    assert np.abs(gs[k].astype(int) - ws[k].astype(int)).max() <= 1, k
            params = arch.params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, device="cpu")
            ps = arch.opt_state_from_numpy(jax.tree.map(np.asarray, rs), pcfg, device="cpu")
    assert int(ps["step"]) == int(rs["step"]) == 3


def test_graphs_copy_is_the_references():
    for n, e, d, c, seed in ((200, 800, 32, 7, 0), (513, 3000, 5, 3, 4)):
        a, b = graphs.make_graph(n, e, d, c, seed), ref_graphs.make_graph(n, e, d, c, seed)
        assert a.n_nodes == b.n_nodes
        for f in ("edges", "feats", "labels"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        ptr, nbrs = graphs.to_csr(n, a.edges)
        rptr, rnbrs = ref_graphs.to_csr(n, b.edges)
        assert np.array_equal(ptr, rptr) and np.array_equal(nbrs, rnbrs)
        batch = np.random.default_rng(seed).choice(n, size=16, replace=False)
        s = graphs.sample_subgraph(ptr, nbrs, a.feats, a.labels, batch, (15, 10), seed)
        r = ref_graphs.sample_subgraph(rptr, rnbrs, b.feats, b.labels, batch, (15, 10), seed)
        assert s.keys() == r.keys() and s["n_batch"] == r["n_batch"]
        for f in ("nodes", "feats", "labels"):
            assert s[f].dtype == r[f].dtype and np.array_equal(s[f], r[f]), f
        for (ss, sd), (rs_, rd) in zip(s["hops"], r["hops"]):
            assert np.array_equal(ss, rs_) and np.array_equal(sd, rd)
    for x, y in zip(graphs.make_molecule_batch(8, 10, 20, 16, 4, 3),
                    ref_graphs.make_molecule_batch(8, 10, 20, 16, 4, 3)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("shape", list(REF_ARCHS["graphsage-reddit"].shapes()))
def test_gnn_make_batch_and_params_are_the_references(shape):
    ref, arch = REF_ARCHS["graphsage-reddit"], ARCHS["graphsage-reddit"]
    rcfg, pcfg = ref.model_config(True), arch.model_config(True)
    want, got = ref.make_batch(rcfg, shape, seed=2), arch.make_batch(pcfg, shape, seed=2)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rc = ref._resolved(rcfg, shape)
    tree = jax.tree.map(np.asarray, _ref_init(ref, rc))
    params = arch.params_from_numpy(tree, arch._resolved(pcfg, shape), device="cpu")
    back = _flat(arch.params_to_numpy(params))
    for k, v in _flat(tree).items():
        assert back[k].tobytes() == v.tobytes(), k
    mine = arch.init_params(0, arch._resolved(pcfg, shape), device="cpu")
    spec = {k: (v.shape, v.dtype) for k, v in _flat(tree).items()}
    assert {k: (v.shape, v.dtype) for k, v in _flat(arch.params_to_numpy(mine)).items()} == spec


def test_gnn_mesh_functions_raise():
    """The sharded GraphSAGE on a one-process mesh (one node block: the
    whole padded graph) is the one-device forward but for the bfloat16
    gather of hidden rows; its specs are the reference's; the registry's
    ``variant="sharded"`` step takes a step. (Four data ranks:
    tests/test_torch_mesh_models.py and tests/test_torch_mesh_train.py.)"""
    from repro_torch.distributed.sharding import LocalMesh, ShardCtx

    ctx = ShardCtx(LocalMesh())
    arch = ARCHS["graphsage-reddit"]
    cfg = arch.model_config(True)
    rcfg = arch._resolved(cfg, "ogb_products")
    assert [{k: tuple(v) for k, v in layer.items()} for layer in gnn.sage_param_specs(
        rcfg)["layers"]] == [{k: tuple(v) for k, v in layer.items()} for layer in
                             ref_gnn.sage_param_specs(rcfg)["layers"]]
    params = arch.init_params(0, rcfg, device="cpu")
    b = arch.make_batch(cfg, "ogb_products")
    sb = arch.sharded_batch(cfg, "ogb_products", 1, device="cpu")
    got = gnn.sage_forward_sharded(params, sb["feats"], sb["agg0"], sb["edges"], rcfg,
                                   sb["feats"].shape[0], ctx)
    want = gnn.sage_forward(params, b["feats"], b["edges"], rcfg)
    n = want.shape[0]
    assert float((got[:n] - want).abs().max() / want.abs().max()) < 1e-2
    step, kind = arch.build_step(cfg, "ogb_products", shard_ctx=ctx, variant="sharded")
    state = init_opt_state(params, AdamWConfig())
    _, state, metrics = step(params, state, sb)
    assert kind == "train" and int(state["step"]) == 1 and torch.isfinite(metrics["loss"])
