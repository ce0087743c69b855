"""Every ``train`` shape of the port's registry against the reference's.

The reference's own parameters (``init_params`` with a JAX key, carried
with ``Arch.params_from_numpy``) and its ``make_batch`` arrays go through
both packages on the CPU, float32:

  * the loss and the gradient of every leaf (``jax.value_and_grad`` against
    autograd) within rtol 1e-4 / atol 1e-5, for the five reduced LMs'
    ``train_4k``, the four towers' ``train_batch`` and GraphSAGE's four
    shapes; every MoE call of the LMs' first forward routes each token to
    the same experts (``topi`` exactly);
  * three steps of ``Arch.build_step`` (the reference's jitted): loss, lr,
    grad_norm and every parameter after each step within the same
    tolerance, except elements whose gradient lies within the gradients'
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
    array.
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
from repro.models import moe as ref_moe
from repro.models import recsys as ref_rec
from repro.models import transformer as ref_tfm
from repro.optim import adamw as ref_adamw
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro_torch.configs.registry import ARCHS
from repro_torch.data import graphs
from repro_torch.models import gnn, moe, recsys, transformer
from repro_torch.models.layers import flat_to_tree, param_leaves, trainable
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

RTOL, ATOL = 1e-4, 1e-5


def _ref_init(ref, cfg):
    """The reference's parameters (jitted: eager initialisation is slow)."""
    return jax.jit(ref.init_params, static_argnums=1)(jax.random.key(0), cfg)
CELLS = [(n, s) for n, a in REF_ARCHS.items() for s, i in a.shapes().items()
         if i.kind == "train"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def _losses(name, shape):
    """(reference loss, port loss, reference cfg, port cfg) of a cell."""
    ref, arch = REF_ARCHS[name], ARCHS[name]
    rcfg, pcfg = ref.model_config(True), arch.model_config(True)
    if ref.family == "lm":
        return (lambda p, b: ref_tfm.lm_loss(p, b["tokens"], rcfg),
                lambda p, b: transformer.lm_loss(p, b["tokens"], pcfg), rcfg, pcfg)
    if ref.family == "recsys":
        return (lambda p, b: ref_rec.rec_train_loss(p, b, rcfg),
                lambda p, b: recsys.rec_train_loss(p, b, pcfg), rcfg, pcfg)
    rcfg, pcfg = ref._resolved(rcfg, shape), arch._resolved(pcfg, shape)

    def make(m, c):
        if shape in ("full_graph_sm", "ogb_products"):
            return lambda p, b: m.sage_loss(m.sage_forward(p, b["feats"], b["edges"], c),
                                            b["labels"])
        if shape == "minibatch_lg":
            return lambda p, b: m.sage_loss(m.sage_forward_sampled(
                p, b["feats"], [(b["hop0_src"], b["hop0_dst"]), (b["hop1_src"], b["hop1_dst"])],
                c, b["labels"].shape[0]), b["labels"])
        return lambda p, b: m.sage_loss(m.sage_forward_graphs(
            p, b["feats"], b["edges"], b["graph_ids"], b["labels"].shape[0], c), b["labels"])
    return make(ref_gnn, rcfg), make(gnn, pcfg), rcfg, pcfg


def _start(name, shape):
    """The reference's parameters (numpy), the port's copy, and a batch."""
    _, _, rcfg, pcfg = _losses(name, shape)
    ref, arch = REF_ARCHS[name], ARCHS[name]
    tree = jax.tree.map(np.asarray, _ref_init(ref, rcfg))
    batch = ref.make_batch(ref.model_config(True), shape, seed=1)
    return tree, arch.params_from_numpy(tree, pcfg, device="cpu"), batch


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name,shape", CELLS)
def test_loss_and_every_gradient_are_the_references(name, shape, monkeypatch):
    rloss, ploss, _, _ = _losses(name, shape)
    tree, params, batch = _start(name, shape)
    want_loss, want_g = jax.jit(jax.value_and_grad(rloss))(tree, batch)
    leaves = param_leaves(params)
    routes = []
    orig = moe._route

    def logged(router_w, x, cfg):
        out = orig(router_w, x, cfg)
        if torch.is_grad_enabled() and not routes_done:
            routes.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "_route", logged)
    routes_done = False
    with trainable(params):
        loss = ploss(params, batch)
        routes_done = True  # the recomputation in the backward pass routes again
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    _close(loss.detach(), want_loss, "loss")
    got = _flat(flat_to_tree(dict(zip(leaves, grads)), params.stacked))
    want = _flat(jax.tree.map(np.asarray, want_g))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        _close(got[k], want[k], k)
    assert all(not p.requires_grad for p in params.parameters())
    if REF_ARCHS[name].family == "lm" and REF_ARCHS[name].model_config(True).moe is not None:
        ref_routes = []
        orig_ref = ref_moe._route

        def ref_logged(router_w, x, cfg):
            out = orig_ref(router_w, x, cfg)
            jax.debug.callback(lambda t: ref_routes.append(np.asarray(t)), out[1])
            return out

        monkeypatch.setattr(ref_moe, "_route", ref_logged)
        jax.block_until_ready(rloss(tree, batch))
        assert len(routes) == len(ref_routes) > 0
        for g, w in zip(routes, ref_routes):
            assert g.tolist() == w.tolist()


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
    cfg = ARCHS["graphsage-reddit"].model_config(True)
    with pytest.raises(NotImplementedError, match="A7"):
        gnn.sage_param_specs(cfg)
    with pytest.raises(NotImplementedError, match="A7"):
        gnn.sage_forward_sharded(None, None, None, None, cfg, 8, object())
    with pytest.raises(NotImplementedError, match="A7"):
        ARCHS["graphsage-reddit"].build_step(cfg, "full_graph_sm", shard_ctx=object(),
                                             variant="sharded")
