"""The port's sharding specs against the JAX package's, spec for spec.

Pure arithmetic, no process group: every ``param_pspecs`` (both LM
variants), every ``batch_pspecs`` of every shape, the transformer's
``param_specs``/``cache_specs``/``param_specs_splitkv``, GraphSAGE's and
the towers' specs, and ``zero1_state_specs`` over the published parameter
shapes (the reference's ``jax.eval_shape``, the port's meta device) at
three moment dtypes, for all 11 arch names, compared as nested tuples.
The meshes are stand-ins that carry only their axis sizes (the specs read
nothing else), so a 2 x 4 or a 2 x 2 x 4 (pod x data x model) mesh needs no
ranks here.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.distributed.sharding import ShardCtx as JaxCtx
from repro.models import gnn as jax_gnn
from repro.models import transformer as jax_tfm
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_opt_state as jax_init_opt
from repro.train import trainer as jax_trainer
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.sharding import P, ShardCtx
from repro_torch.models import gnn, transformer
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train import trainer

NAMES = sorted(ARCHS)
LM_NAMES = [n for n in NAMES if ARCHS[n].family == "lm"]
MESHES = {"2x4": (("data", "model"), (2, 4), ("data",)),
          "2x2x4": (("pod", "data", "model"), (2, 2, 4), ("pod", "data")),
          "16x16": (("data", "model"), (16, 16), ("data",))}


class _JaxMesh:
    """The axis sizes a reference spec function reads (``mesh.shape``)."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))
        self.axis_names = tuple(names)


class _TorchMesh:
    """The axis sizes a port spec function reads (a DeviceMesh's)."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.empty(sizes, device="meta")

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)


def _ctxs(mesh: str):
    names, sizes, da = MESHES[mesh]
    return (JaxCtx(mesh=_JaxMesh(names, sizes), data_axes=da),
            ShardCtx(mesh=_TorchMesh(names, sizes), data_axes=da))


def plain(tree):
    """Specs and structure as nested builtins: a spec its tuple of entries."""
    if isinstance(tree, (JP, P)):
        return ("P", tuple(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


def _cfgs(name: str, reduced: bool):
    return JAX_ARCHS[name].model_config(reduced=reduced), ARCHS[name].model_config(
        reduced=reduced)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_and_batch_specs_are_the_references(name, mesh):
    ja, pa = JAX_ARCHS[name], ARCHS[name]
    jctx, pctx = _ctxs(mesh)
    for reduced in (False, True):
        jcfg, pcfg = _cfgs(name, reduced)
        variants = getattr(ja, "variants", ("baseline",))
        if pa.family == "recsys":
            jp = jax.eval_shape(lambda: ja.init_params(jax.random.key(0), jcfg))
            got, want = pa.param_pspecs(pcfg, pa.param_shapes(pcfg)), ja.param_pspecs(jcfg, jp)
            assert plain(got) == plain(want), (name, reduced)
            for shape in ja.shapes():
                assert plain(pa.batch_pspecs(pcfg, shape, pctx)) == plain(
                    ja.batch_pspecs(jcfg, shape, jctx)), (name, shape)
            continue
        for variant in variants:
            want = ja.param_pspecs(jcfg, None, variant=variant, ctx=jctx)
            got = pa.param_pspecs(pcfg, None, variant=variant, ctx=pctx)
            assert plain(got) == plain(want), (name, variant, reduced)
            for shape in ja.shapes():
                assert plain(pa.batch_pspecs(pcfg, shape, pctx, variant=variant)) == plain(
                    ja.batch_pspecs(jcfg, shape, jctx, variant=variant)), (name, shape,
                                                                             variant)


@pytest.mark.parametrize("name", LM_NAMES)
def test_transformer_spec_functions_are_the_references(name):
    for reduced in (False, True):
        jcfg, pcfg = _cfgs(name, reduced)
        assert plain(transformer.param_specs(pcfg)) == plain(jax_tfm.param_specs(jcfg))
        assert plain(transformer.param_specs(pcfg, "tp")) == plain(
            jax_tfm.param_specs(jcfg, "tp"))
        for da in (("data",), ("pod", "data")):
            for layout in ("batch", "split"):
                assert plain(transformer.cache_specs(pcfg, da, layout)) == plain(
                    jax_tfm.cache_specs(jcfg, da, layout))
        for ok in (True, False):
            assert plain(transformer.param_specs_splitkv(pcfg, ep_grid_ok=ok)) == plain(
                jax_tfm.param_specs_splitkv(jcfg, ep_grid_ok=ok))
        assert plain(transformer._attn_specs(pcfg, "m")) == plain(
            jax_tfm._attn_specs(jcfg, "m"))
        for moe in (False, True):
            if moe and jcfg.moe is None:
                continue
            assert plain(transformer._layer_specs(pcfg, moe, "m")) == plain(
                jax_tfm._layer_specs(jcfg, moe, "m"))


def test_sage_param_specs_are_the_references():
    for n_layers in (1, 2, 3):
        jcfg = jax_gnn.SAGEConfig(n_layers=n_layers, d_in=8, d_hidden=16, n_classes=3)
        pcfg = gnn.SAGEConfig(n_layers=n_layers, d_in=8, d_hidden=16, n_classes=3)
        assert plain(gnn.sage_param_specs(pcfg)) == plain(jax_gnn.sage_param_specs(jcfg))


SPEC_CASES = [
    (JP(None, "model"), (64, 512), 2, ("data",), None),
    (JP(None, "model"), (3, 512), 2, ("data",), {"data": 2, "model": 4}),
    (JP(), (7, 9), 4, ("data",), None),
    (JP(None, None, "model"), (4, 6, 8), 4, ("pod", "data"), {"pod": 2, "data": 2,
                                                              "model": 4}),
    (JP(("data", "model"), None), (8, 4), 2, ("data",), {"data": 2, "model": 4}),
    (JP(None, "model", None), (2, 5, 256), 2, ("data",), {"data": 2, "model": 4}),
    (JP("model"), (6,), 3, ("data",), {"data": 3, "model": 4}),
    (JP(None), (0, 4), 2, ("data",), None),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_zero1_spec_arithmetic_is_the_references(case):
    spec, shape, n, da, mesh_shape = SPEC_CASES[case]
    pspec = P(*spec)
    assert plain(trainer.zero1_spec(pspec, shape, n, da, mesh_shape)) == plain(
        jax_trainer.zero1_spec(spec, shape, n, da, mesh_shape))
    if mesh_shape is not None:
        assert plain(trainer._fit_spec(pspec, shape, mesh_shape)) == plain(
            jax_trainer._fit_spec(spec, shape, mesh_shape))
    for axes in (None, "data", ("pod", "data"), ("data", "model")):
        assert trainer._axes_size(axes, mesh_shape or {}) == jax_trainer._axes_size(
            axes, mesh_shape or {})
        parts = list(pspec)
        if axes is not None:
            assert trainer._uses_axes(parts, (axes,) if isinstance(axes, str) else axes) \
                == jax_trainer._uses_axes(list(spec), (axes,) if isinstance(axes, str)
                                          else axes)


def _shape_cfg(arch, cfg, family):
    if family == "gnn":
        return arch._resolved(cfg, "ogb_products")
    return cfg


@pytest.mark.parametrize("name", [n for n in NAMES if ARCHS[n].family != "ir"])
@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_zero1_state_specs_are_the_references(name, moments):
    """At the published shapes, on a 2 x 4 and a 2 x 2 x 4 mesh."""
    ja, pa = JAX_ARCHS[name], ARCHS[name]
    jcfg, pcfg = _cfgs(name, False)
    jcfg, pcfg = _shape_cfg(ja, jcfg, pa.family), _shape_cfg(pa, pcfg, pa.family)
    jp = jax.eval_shape(lambda: ja.init_params(jax.random.key(0), jcfg))
    jo = jax.eval_shape(lambda: jax_init_opt(jp, JaxAdamW(moment_dtype=moments)))
    pp = pa.param_shapes(pcfg)
    po = init_opt_state(pp, AdamWConfig(moment_dtype=moments))
    jspecs, pspecs = ja.param_pspecs(jcfg, jp), pa.param_pspecs(pcfg, pp)
    for mesh in ("2x4", "2x2x4"):
        names, sizes, da = MESHES[mesh]
        shape = dict(zip(names, sizes))
        n_data = int(np.prod([shape[a] for a in da]))
        want = jax_trainer.zero1_state_specs(jspecs, jp, jo, n_data, da, mesh_shape=shape)
        got = trainer.zero1_state_specs(pspecs, pp, po, n_data, da, mesh_shape=shape)
        assert plain(got) == plain(want), (name, mesh, moments)
        assert plain(trainer.zero1_state_specs(pspecs, pp, po, n_data, da)) == plain(
            jax_trainer.zero1_state_specs(jspecs, jp, jo, n_data, da)), (name, mesh)


@pytest.mark.parametrize("spec", [P("model", None), P(None, "model"), P(("data", "model")),
                                  P()])
def test_place_keeps_only_the_block(spec):
    """A placed block owns its memory: the global tensor it came from can
    be freed (a view would keep it whole on every rank)."""
    from repro_torch.distributed.sharding import place

    mesh = _TorchMesh(("data", "model"), (2, 4))
    mesh.get_coordinate = lambda: [1, 3]
    x = torch.arange(64.0) if len(spec) == 1 else torch.arange(64.0).reshape(8, 8)
    blk = place(x, spec, mesh, "cpu")
    want = {P("model", None): lambda: x[6:8], P(None, "model"): lambda: x[:, 6:8],
            P(("data", "model")): lambda: x[56:64], P(): lambda: x}[spec]()
    assert torch.equal(blk, want)
    if blk.numel() < x.numel():
        assert blk.untyped_storage().nbytes() == blk.numel() * blk.element_size()
