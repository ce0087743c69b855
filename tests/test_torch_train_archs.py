"""Every ``train`` shape's loss and gradient against the reference's.

The reference's own parameters (``init_params`` with a JAX key, carried
with ``Arch.params_from_numpy``) and its ``make_batch`` arrays go through
both packages on the CPU, float32: the loss and the gradient of every leaf
(``jax.value_and_grad`` against autograd) within rtol 1e-4 / atol 1e-5, for
the five reduced LMs' ``train_4k``, the four towers' ``train_batch`` and
GraphSAGE's four shapes; every MoE call of the LMs' first forward routes
each token to the same experts (``topi`` exactly). The three-step runs of
``Arch.build_step`` and the data copies are tests/test_torch_train_steps.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import moe as ref_moe
from repro_torch.models import moe
from repro_torch.models.layers import flat_to_tree, param_leaves, trainable
from train_cells import CELLS, _close, _flat, _losses, _start


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
