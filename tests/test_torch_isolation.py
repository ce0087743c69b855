"""The port stands alone: no JAX, nothing of the reference package.

``repro_torch`` and ``chip_smoke.py`` import ``torch`` and numpy and never
``jax`` or any ``repro`` module (they keep their own copies of what they
need), and the port's entry points run on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_modules_import_neither_jax_nor_reference():
    """Every module of the port, imported in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 15, names\n"
        "serving = {'repro_torch.serving.bucketing', 'repro_torch.serving.batch_engine',\n"
        "           'repro_torch.serving.microbatch', 'repro_torch.serving.inflight',\n"
        "           'repro_torch.serving.sharded'}\n"
        "assert serving <= set(names), names\n"
        "later = {'repro_torch.index_io.artifact', 'repro_torch.index_io.corpus_io',\n"
        "         'repro_torch.index_io.__main__', 'repro_torch.control.journal',\n"
        "         'repro_torch.obs.__main__'} | {'repro_torch.obs.' + m for m in (\n"
        "         'catalog', 'clock', 'detect', 'export', 'instrument', 'metrics',\n"
        "         'profiler', 'report', 'slo', 'trace', 'watch')}\n"
        "later |= {'repro_torch.control.' + m for m in (\n"
        "          'health', 'reshard', 'replica', 'plane')}\n"
        "later |= {'repro_torch.serve', 'repro_torch.serve.distributed_ir',\n"
        "          'repro_torch.serve.retrieval'}\n"
        "later |= {'repro_torch.configs.' + m for m in (\n"
        "          'base', 'lm_archs', 'other_archs', 'anytime_ir', 'registry')}\n"
        "later |= {'repro_torch.models.' + m for m in (\n"
        "          'layers', 'attention', 'moe', 'transformer', 'recsys', 'gnn')}\n"
        "later |= {'repro_torch.core.' + m for m in ('saat', 'boolean', 'bound_sum')}\n"
        "later |= {'repro_torch.distributed', 'repro_torch.distributed.sharding'}\n"
        "later |= {'repro_torch.optim', 'repro_torch.train', 'repro_torch.launch.train',\n"
        "          'repro_torch.data.graphs'} | {'repro_torch.optim.' + m for m in (\n"
        "          'adamw', 'schedule', 'compression')} | {'repro_torch.train.' + m\n"
        "          for m in ('trainer', 'checkpoint')}\n"
        "assert later <= set(names), sorted(later - set(names))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_names_jax_or_reference():
    """Static check of every import statement in the port and the smoke."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: {names}"


def _tiny_index():
    from repro_torch.core.clustered_index import build_index
    from repro_torch.data.synth import make_corpus

    corpus = make_corpus(n_docs=120, n_terms=200, n_topics=2, mean_doc_len=20, seed=3)
    return build_index(corpus, n_ranges=2, strategy="clustered", bits=8)


def test_engine_without_card_raises_and_names_cpu(monkeypatch):
    from repro_torch.core.range_daat import Engine

    index = _tiny_index()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(index)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(index, device="cuda")
    eng = Engine(index, device="cpu")
    assert (eng.device.type, eng.impl) == ("cpu", "torch")
    res = eng.traverse(eng.plan(np.array([0, 1, 2], np.int32)))
    assert res.state.vals.device.type == "cpu"


def test_serve_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "build_preset", lambda *a, **k: (None, _tiny_index()))
    monkeypatch.setattr(serve, "make_query_log", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--queries", "4"])


@pytest.mark.parametrize("mode", ["inflight", "sharded", "control"])
def test_serve_cli_new_modes_default_to_the_card(monkeypatch, mode):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "build_preset", lambda *a, **k: (None, _tiny_index()))
    monkeypatch.setattr(serve, "make_query_log", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", mode, "--queries", "4"])


def test_sharded_and_inflight_run_on_the_engine_device(monkeypatch):
    from repro_torch.core.range_daat import Engine
    from repro_torch.serving import (
        BatchEngine, InflightServer, ShardedEngine, SlaBudgeter)

    eng = Engine(_tiny_index(), k=3, device="cpu")
    se = ShardedEngine(eng, 2)
    assert {t.device.type for t in se.dix if t is not None} == {"cpu"}
    assert se.doc_base.device.type == "cpu" and se.impl == "torch"
    srv = InflightServer(BatchEngine(eng), SlaBudgeter(sla_ms=float("inf")), n_slots=2)
    served = srv.replay([np.array([0, 1, 2], np.int32), np.array([3, 4], np.int32)])
    assert [s.rid for s in sorted(served, key=lambda s: s.rid)] == [0, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedEngine(Engine(_tiny_index(), k=3), 2)


def test_control_and_serve_entry_points_default_to_the_card(monkeypatch):
    """The control plane serves on its engine's device; the partitioned IR
    and MIPS builders put their arrays on the card unless asked for the CPU."""
    from repro_torch.control import ControlPlane
    from repro_torch.core.range_daat import Engine
    from repro_torch.data.synth import make_corpus
    from repro_torch.serve.distributed_ir import build_sharded_index
    from repro_torch.serve.retrieval import build_clustered_candidates

    plane = ControlPlane(Engine(_tiny_index(), k=3, device="cpu"), n_shards=2)
    assert plane.sengine.dix.docs.device.type == "cpu" and plane.sengine.impl == "torch"
    emb = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    assert build_clustered_candidates(emb, 3, device="cpu").emb.device.type == "cpu"
    corpus = make_corpus(n_docs=60, n_terms=80, n_topics=2, mean_doc_len=10, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControlPlane(Engine(_tiny_index(), k=3), n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_clustered_candidates(emb, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sharded_index(corpus, 2, n_ranges_per_shard=2, strategy="clustered")


def test_table_from_numpy_defaults_to_the_card(monkeypatch):
    from repro_torch.models.embedding import table_from_numpy

    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_from_numpy(table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_from_numpy(table, device="cuda")
    t = table_from_numpy(table, device="cpu")
    assert t.device.type == "cpu" and t.tolist() == table.tolist()


def test_arch_entry_points_default_to_the_card(monkeypatch):
    """The registry's parameters, carried weights and decode caches go to
    the card unless the caller asks for the CPU; the meta device allocates
    nothing and needs no card."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.transformer import init_cache

    lm, rec = ARCHS["qwen3-4b"], ARCHS["mind"]
    lcfg, rcfg = lm.model_config(True), rec.model_config(True)
    tree = {"item_emb": np.zeros((4, 2), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lm.init_params(0, lcfg), lambda: rec.init_params(0, rcfg),
                 lambda: rec.params_from_numpy(tree, rcfg),
                 lambda: lm.make_batch(lcfg, "decode_32k"),
                 lambda: init_cache(lcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = lm.init_params(0, lcfg, device="cpu")
    assert {t.device.type for t in p.parameters()} == {"cpu"}
    assert {t.device.type for t in lm.param_shapes(lm.model_config()).parameters()} == {
        "meta"}
    assert rec.params_from_numpy(tree, rcfg, device="cpu")["item_emb"].device.type == "cpu"


@pytest.mark.parametrize("module", ["range_scorer", "embedding_bag"])
def test_kernel_library_is_named_by_source_and_flags(monkeypatch, tmp_path, module):
    """``build`` finds a library named by the hash of its source and flags.

    The name is the one the range scorer used before the build moved to
    ``kernels/_nvcc.py``, so a warm cache stays warm; without ``nvcc`` a
    cold cache raises.
    """
    import hashlib
    import importlib

    from repro_torch.kernels import _nvcc

    kernel = importlib.import_module(f"repro_torch.kernels.{module}.kernel")
    source = PORT / "kernels" / module / "csrc" / f"{module}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(kernel.NVCC_FLAGS).encode())
    assert _nvcc.BUILD_DIR == ROOT / ".cache" / "repro_torch_kernels"
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()
    lib = tmp_path / f"lib{module}-{digest.hexdigest()[:16]}.so"
    lib.write_bytes(b"")
    assert kernel.build() == (lib, 0.0, "")


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``launch.train``, GraphSAGE's parameters, a checkpoint restore and a
    ``Trainer`` over default parameters go to the card unless the caller
    asks for the CPU."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gnn, lm = ARCHS["graphsage-reddit"], ARCHS["qwen3-4b"]
    gcfg = gnn._resolved(gnn.model_config(True), "molecule")
    ck = Checkpointer(str(tmp_path))
    ck.save({"w": torch.ones(3)}, step=1, blocking=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: train.main(["--arch", "qwen3-4b", "--steps", "1"]),
                 lambda: train.main(["--arch", "qwen3-4b", "--steps", "1", "--device",
                                     "cuda"]),
                 lambda: gnn.init_params(0, gcfg),
                 lambda: gnn.params_from_numpy({"layers": []}, gcfg),
                 lambda: ck.restore(1),
                 lambda: lm.opt_state_from_numpy({"m": {}, "v": {}, "step": np.int32(0)}),
                 lambda: Trainer(lambda p, b: None, lm.init_params(0, lm.model_config(True)),
                                 TrainerConfig(), lambda s: {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    t = Trainer(lambda p, b: None, lm.init_params(0, lm.model_config(True), device="cpu"),
                TrainerConfig(), lambda s: {})
    assert t.device.type == "cpu" and t.opt_state["step"].device.type == "cpu"
    assert ck.restore(1, device="cpu")["w"].device.type == "cpu"
