"""The port's four recommendation towers against the reference's, on the CPU.

BST, MIND, AutoInt and BERT4Rec at their reduced configs: the reference's
parameters carried across (``Arch.params_from_numpy``), the same
``make_batch`` arrays, and the registry's ``serve_p99``, ``serve_bulk`` and
``retrieval_cand`` steps of both packages, in float32, within rtol 1e-4 /
atol 1e-5; ``rec_user_embedding`` for the two dot-product towers. The
steps' pieces (``SERVE_CHUNK`` examples, ``CAND_CHUNK`` candidates) give
the scores of one piece. Training and mesh functions raise naming their
ROADMAP item.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import recsys as ref_rec
from repro_torch.configs.registry import ARCHS
from repro_torch.models import recsys

RTOL, ATOL = 1e-4, 1e-5
TOWERS = ["bst", "mind", "autoint", "bert4rec"]
SHAPES = ["serve_p99", "serve_bulk", "retrieval_cand"]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def towers():
    """Each reduced tower's reference parameters and the port's copy."""
    out = {}
    for name in TOWERS:
        cfg = REF_ARCHS[name].model_config(True)
        p = jax.jit(ref_rec.init_rec, static_argnums=1)(jax.random.key(0), cfg)
        tree = jax.tree.map(np.asarray, p)
        out[name] = (p, ARCHS[name].params_from_numpy(tree, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", TOWERS)
def test_tower_step_is_the_references(name, shape, towers):
    ra, pa = REF_ARCHS[name], ARCHS[name]
    rcfg, cfg = ra.model_config(True), pa.model_config(True)
    p, pp = towers[name]
    rb, pb = ra.make_batch(rcfg, shape, seed=3), pa.make_batch(cfg, shape, seed=3)
    assert rb.keys() == pb.keys()
    for k in rb:
        assert rb[k].dtype == pb[k].dtype and np.array_equal(rb[k], pb[k]), k
    step, kind = ra.build_step(rcfg, shape)
    pstep, pkind = pa.build_step(cfg, shape)
    assert pkind == kind
    want = jax.jit(step)(p, rb)
    got = pstep(pp, pb)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("name", ["mind", "bert4rec"])
def test_user_embedding_is_the_references(name, towers):
    rcfg, cfg = REF_ARCHS[name].model_config(True), ARCHS[name].model_config(True)
    p, pp = towers[name]
    batch = ARCHS[name].make_batch(cfg, "serve_p99", seed=4)
    feats = {"history": batch["history"]}
    want = jax.jit(lambda p, f: ref_rec.rec_user_embedding(p, f, rcfg))(p, feats)
    got = recsys.rec_user_embedding(pp, feats, cfg)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("name", TOWERS)
def test_pieces_give_one_pieces_scores(name, towers, monkeypatch):
    """Serve batches and candidate lists cut into pieces of 5 and 300 score
    as one piece does (every example and candidate is independent)."""
    cfg = ARCHS[name].model_config(True)
    _, pp = towers[name]
    whole = {}
    for shape in ("serve_bulk", "retrieval_cand"):
        step, _ = ARCHS[name].build_step(cfg, shape)
        whole[shape] = (step, ARCHS[name].make_batch(cfg, shape, seed=5))
    want = {s: step(pp, b) for s, (step, b) in whole.items()}
    monkeypatch.setattr(recsys, "SERVE_CHUNK", 5)
    monkeypatch.setattr(recsys, "CAND_CHUNK", 300)
    for s, (step, b) in whole.items():
        torch.testing.assert_close(step(pp, b), want[s], rtol=RTOL, atol=ATOL)


def test_training_and_mesh_functions_raise(towers):
    cfg = ARCHS["bst"].model_config(True)
    _, pp = towers["bst"]
    # rec_train_loss is ported (tests/test_torch_train_archs.py holds it
    # against the reference); its mesh form raises.
    train = ARCHS["bst"].make_batch(cfg, "train_batch")
    loss = recsys.rec_train_loss(pp, train, cfg)
    assert loss.shape == () and torch.isfinite(loss)
    # On a one-process mesh (every axis of size 1) the mesh forms are the
    # one-device ones; the specs are the reference's. (Eight ranks:
    # tests/test_torch_mesh_models.py and tests/test_torch_mesh_train.py.)
    from repro_torch.distributed.sharding import LocalMesh, ShardCtx

    ctx = ShardCtx(LocalMesh())
    torch.testing.assert_close(recsys.rec_train_loss(pp, train, cfg, shard_ctx=ctx), loss)
    specs = recsys.rec_param_specs(pp, cfg)
    want = ref_rec.rec_param_specs(jax.eval_shape(
        lambda: REF_ARCHS["bst"].init_params(jax.random.key(0), REF_ARCHS["bst"].model_config(
            True))), REF_ARCHS["bst"].model_config(True))
    assert jax.tree.structure(jax.tree.map(tuple, specs, is_leaf=lambda t: isinstance(
        t, tuple))) == jax.tree.structure(jax.tree.map(tuple, want, is_leaf=lambda t: isinstance(
            t, tuple)))
    assert tuple(specs["item_emb"]) == tuple(want["item_emb"]) == ("model", None)
    assert tuple(specs["field_emb"]) == tuple(want["field_emb"]) == ("model", None)
    batch = ARCHS["bst"].make_batch(cfg, "serve_p99")
    torch.testing.assert_close(recsys.rec_serve_scores(pp, batch, cfg, shard_ctx=ctx),
                               recsys.rec_serve_scores(pp, batch, cfg))
    with pytest.raises(ValueError, match="no dot-product user embedding"):
        recsys.rec_user_embedding(pp, batch, cfg)
