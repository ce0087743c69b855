"""The ``train`` cells both packages share, for the tests that hold the
port's training against the reference's (tests/test_torch_train_archs.py,
tests/test_torch_train_steps.py): the cells, the reference's parameters,
each cell's loss in either package, and the tolerance."""

from __future__ import annotations

import jax
import numpy as np

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_rec
from repro.models import transformer as ref_tfm
from repro_torch.configs.registry import ARCHS
from repro_torch.models import gnn, recsys, transformer

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
