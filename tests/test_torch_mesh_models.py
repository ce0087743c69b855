"""The port's model paths over a mesh against the JAX package's, on the CPU.

One gloo group of 8 CPU ranks (this file run as a script, JAX-free on the
rank side, ``file://`` rendezvous under ``tmp_path``) and one JAX
subprocess on ``--xla_force_host_platform_device_count=8`` run the same
cases side by side from one pickle of numpy inputs, float32 throughout:

  * split-KV decode, two steps through the split cache, GQA (qk-norm) and
    MLA with MoE, on the reference's 2 x 4 (data x model) mesh, and the
    baseline decode with a context (tensor-parallel heads); the GQA
    seq-parallel prefill in chunks of one model rank's slice, then a
    decode; each against the reference's decode with the same context and
    its single-device decode (rel < 2e-4);
  * ``moe_ffn`` with EP over model and ``moe_ffn_decode_ep_all`` over the
    grid, against the reference's (rel < 1e-5; aux against its ``pmean``);
  * ``sage_forward_sharded`` on a 4 x 2 mesh on the reference's host-side
    inputs (rel < 3e-2 against the reference's, whose bfloat16 gather is
    the port's; tighter against the port's one-device forward);
  * ``compress_psum_pod`` on a 2 x 2 (pod x data) mesh of ranks 0-3
    (rel < 2e-2 against the mean gradient; error buffers of the
    reference's shape);
  * the four towers with row-sharded tables on 2 x 4: serve scores,
    retrieval scores and the training loss against the reference's
    single-device tower.
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
B, S_MAX = 4, 32
TOWERS = ("bst", "mind", "autoint", "bert4rec")


# --------------------------------------------------------------------------
# Inputs, drawn once with numpy in the test process
# --------------------------------------------------------------------------


def _lm_cfgs(jnp_or_torch_f32, GQAConfig, MLAConfig, MoEConfig, LMConfig):
    gqa = LMConfig(
        name="t", n_layers=2, d_model=64, vocab=128,
        attn=GQAConfig(d_model=64, n_heads=8, n_kv_heads=4, head_dim=8, qk_norm=True),
        d_ff=96, max_seq=32, dtype=jnp_or_torch_f32, attn_chunk=16, remat=False)
    mla = LMConfig(
        name="t2", n_layers=2, d_model=64, vocab=128,
        attn=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                       qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        d_ff=96, moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1),
        n_dense_layers=1, max_seq=32, dtype=jnp_or_torch_f32, attn_chunk=16, remat=False)
    return {"gqa": gqa, "mla": mla}


def _draw(shapes, rng, scale=0.2):
    import jax

    return jax.tree.map(lambda s: (rng.normal(0, scale, s.shape)).astype(np.float32), shapes)


def make_inputs() -> dict:
    """Every case's weights and inputs as numpy (the reference's trees)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import ARCHS
    from repro.data.graphs import make_graph
    from repro.models.attention import GQAConfig, MLAConfig
    from repro.models.gnn import SAGEConfig, init_sage
    from repro.models.moe import MoEConfig, init_moe
    from repro.models.transformer import LMConfig, init_lm

    rng = np.random.default_rng(0)
    out: dict = {"lm": {}}
    for name, cfg in _lm_cfgs(jnp.float32, GQAConfig, MLAConfig, MoEConfig,
                              LMConfig).items():
        shapes = jax.eval_shape(lambda c=cfg: init_lm(jax.random.key(0), c))
        out["lm"][name] = dict(
            params=_draw(shapes, rng), warm=rng.integers(0, 128, (B, 8)).astype(np.int32),
            nxt=rng.integers(0, 128, (B, 1)).astype(np.int32),
            nxt2=rng.integers(0, 128, (B, 1)).astype(np.int32),
            prompt=rng.integers(0, 128, (B, S_MAX)).astype(np.int32))
    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1, capacity_factor=4.0)
    out["moe"] = dict(params=_draw(jax.eval_shape(
        lambda: init_moe(jax.random.key(0), 32, mcfg, dtype=jnp.float32)), rng),
        x=rng.normal(0, 1, (16, 32)).astype(np.float32))

    N, E, D, C = 512, 2048, 24, 6
    g = make_graph(N, E, D, C, seed=3)
    scfg = SAGEConfig(n_layers=2, d_in=D, d_hidden=32, n_classes=C)
    agg0 = np.zeros((N, D), np.float32)
    deg = np.zeros(N, np.float32)
    np.add.at(agg0, g.edges[:, 1], g.feats[g.edges[:, 0]])
    np.add.at(deg, g.edges[:, 1], 1.0)
    agg0 /= np.maximum(deg, 1.0)[:, None]
    owner = g.edges[:, 1] // (N // 4)
    bins = [g.edges[owner == s] for s in range(4)]
    w = max(len(b) for b in bins)
    edges_sh = np.full((4 * w, 2), -1, np.int32)
    for s, b in enumerate(bins):
        edges_sh[s * w:s * w + len(b)] = b
    out["gnn"] = dict(params=_draw(jax.eval_shape(
        lambda: init_sage(jax.random.key(0), scfg)), rng), feats=g.feats, edges=g.edges,
        labels=g.labels, agg0=agg0, edges_sh=edges_sh)

    out["pod"] = dict(w=np.linspace(-1, 1, 64, dtype=np.float32),
                      batch=rng.normal(size=(8, 64)).astype(np.float32))

    out["towers"] = {}
    for name in TOWERS:
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        shapes = jax.eval_shape(lambda a=arch, c=cfg: a.init_params(jax.random.key(0), c))
        out["towers"][name] = dict(
            params=_draw(shapes, rng, 0.5), serve=arch.make_batch(cfg, "serve_p99", seed=1),
            train=arch.make_batch(cfg, "train_batch", seed=2),
            retrieval=arch.make_batch(cfg, "retrieval_cand", seed=3))
    return out


# --------------------------------------------------------------------------
# The reference: a JAX process with 8 host devices
# --------------------------------------------------------------------------

_REF = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[3])
from test_torch_mesh_models import _lm_cfgs, TOWERS
from repro.configs.registry import ARCHS
from repro.distributed.sharding import ShardCtx
from repro.models.attention import GQAConfig, MLAConfig
from repro.models.gnn import SAGEConfig, sage_forward, sage_forward_sharded
from repro.models.moe import MoEConfig, moe_ffn, moe_ffn_decode_ep_all
from repro.models.recsys import rec_train_loss
from repro.models.transformer import LMConfig, init_cache, lm_decode_step
from repro.optim.compression import compress_psum_pod, init_error_buffers
from jax.sharding import NamedSharding, PartitionSpec as P

inp = pickle.load(open(sys.argv[1], "rb"))
part = sys.argv[4]
tree = lambda t: jax.tree.map(jnp.asarray, t)
def host(t):
    if isinstance(t, dict):
        return {k: host(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(host(v) for v in t)
    return np.asarray(t)
mesh = jax.make_mesh((2, 4), ("data", "model"))
ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
out = {}

def decoder(cfg, shard_ctx=None, impl="batch"):
    return jax.jit(lambda p, t, c, pos: lm_decode_step(p, t, c, pos, cfg, shard_ctx=shard_ctx,
                                                        decode_impl=impl))

if part == "lm":
    for name, cfg in _lm_cfgs(jnp.float32, GQAConfig, MLAConfig, MoEConfig, LMConfig).items():
        d = inp["lm"][name]
        p = tree(d["params"])
        base = decoder(cfg)
        _, cache = base(p, jnp.asarray(d["warm"]), init_cache(cfg, 4, 32), jnp.int32(0))
        o = out[name] = {}
        o["base1"], c1 = base(p, jnp.asarray(d["nxt"]), cache, jnp.int32(8))
        o["base2"], _ = base(p, jnp.asarray(d["nxt2"]), c1, jnp.int32(9))
        for impl in ("split_kv", "batch"):
            step = decoder(cfg, ctx, impl)
            try:
                o[impl, 1], c2 = step(p, jnp.asarray(d["nxt"]), cache, jnp.int32(8))
                o[impl, 2], _ = step(p, jnp.asarray(d["nxt2"]), c2, jnp.int32(9))
            except Exception as e:  # ROADMAP C: the reference's own mesh path raises
                o[impl, "raised"] = type(e).__name__
        if name == "gqa":
            toks = jnp.asarray(d["prompt"])
            split = decoder(cfg, ctx, "split_kv")
            o["prefill_ref"], cr = base(p, toks[:, :24], init_cache(cfg, 4, 32), jnp.int32(0))
            cs = init_cache(cfg, 4, 32)
            for c in range(3):
                o["prefill_sp"], cs = split(p, toks[:, c*8:(c+1)*8], cs, jnp.int32(c*8))
            o["after_ref"], _ = base(p, jnp.asarray(d["nxt"]), cr, jnp.int32(24))
            o["after_sp"], _ = split(p, jnp.asarray(d["nxt"]), cs, jnp.int32(24))
        out[name] = host(o)

    mcfg = MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1, capacity_factor=4.0)
    mp, x = tree(inp["moe"]["params"]), jnp.asarray(inp["moe"]["x"])
    out["moe"] = host(dict(
        local=jax.jit(lambda a, b: moe_ffn(a, b, mcfg, None))(mp, x),
        ep=jax.jit(lambda a, b: moe_ffn(a, b, mcfg, ctx))(mp, x),
        ep_all=jax.jit(lambda a, b: moe_ffn_decode_ep_all(a, b, mcfg, ctx))(mp, x)))
else:
    g = inp["gnn"]
    scfg = SAGEConfig(n_layers=2, d_in=24, d_hidden=32, n_classes=6)
    gp = tree(g["params"])
    mesh42 = jax.make_mesh((4, 2), ("data", "model"))
    ctx42 = ShardCtx(mesh=mesh42, data_axes=("data",), model_axis="model")
    out["gnn"] = host(dict(
        base=jax.jit(lambda a, f, e: sage_forward(a, f, e, scfg))(
            gp, jnp.asarray(g["feats"]), jnp.asarray(g["edges"])),
        sharded=jax.jit(lambda a, f, a0, e: sage_forward_sharded(a, f, a0, e, scfg, 512, ctx42))(
            gp, jnp.asarray(g["feats"]), jnp.asarray(g["agg0"]), jnp.asarray(g["edges_sh"]))))

    pod = jax.make_mesh((2, 2), ("pod", "data"), devices=jax.devices()[:4])
    params = {"w": jnp.asarray(inp["pod"]["w"])}
    def loss(pp, batch):
        return jnp.mean((jnp.dot(batch, pp["w"]) - 1.0) ** 2)
    def grad_fn(batch_shard):
        return jax.grad(loss)(params, batch_shard)
    batch = inp["pod"]["batch"]
    err = jax.device_put(init_error_buffers(params, n_pods=2), NamedSharding(pod, P("pod", None)))
    grads, new_err = jax.jit(compress_psum_pod(grad_fn, pod))(
        jax.device_put(batch, NamedSharding(pod, P("pod", None))), err)
    g0 = jax.grad(loss)(params, jnp.asarray(batch[:4]))["w"]
    g1 = jax.grad(loss)(params, jnp.asarray(batch[4:]))["w"]
    out["pod"] = host(dict(grads=grads, err=new_err, mean=(g0 + g1) / 2))

    out["towers"] = {}
    for name in TOWERS:
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        d = inp["towers"][name]
        tp = tree(d["params"])
        serve, _ = arch.build_step(cfg, "serve_p99")
        retr, _ = arch.build_step(cfg, "retrieval_cand")
        out["towers"][name] = host(dict(
            serve=jax.jit(serve)(tp, tree(d["serve"])),
            retrieval=jax.jit(retr)(tp, tree(d["retrieval"])),
            loss=jax.jit(lambda a, b, c=cfg: rec_train_loss(a, b, c))(tp, tree(d["train"]))))
pickle.dump(out, open(sys.argv[2], "wb"))
print("REF_OK")
"""


def _reference(inputs: Path, out: Path, part: str) -> subprocess.Popen:
    """The reference's half ``part`` ("lm": the LMs and MoE; "rest": the
    graph, the pod exchange and the towers), in a process of its own."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-c", _REF, str(inputs), str(out),
                             str(ROOT / "tests"), part], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# --------------------------------------------------------------------------
# The port: 8 gloo ranks
# --------------------------------------------------------------------------


def _rank_lm(ms, inp, ctx, mesh, out):
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import GQAConfig, MLAConfig
    from repro_torch.models.layers import params_from_tree
    from repro_torch.models.moe import MoEConfig

    for name, cfg in _lm_cfgs(torch.float32, GQAConfig, MLAConfig, MoEConfig,
                              tfm.LMConfig).items():
        d = inp["lm"][name]
        one = params_from_tree(d["params"], "cpu", stacked=tfm.STACKED)
        cache = tfm.init_cache(cfg, B, S_MAX, device="cpu")
        tfm.lm_decode_step(one, d["warm"], cache, 0, cfg)
        o = out[name] = {}
        for impl in ("split_kv", "batch"):
            layout = "split" if impl == "split_kv" else "batch"
            pspecs = (tfm.param_specs_splitkv(cfg, ep_grid_ok=cfg.moe is not None)
                      if impl == "split_kv" else tfm.param_specs(cfg))
            cspecs = tfm.cache_specs(cfg, ctx.data_axes, layout)
            p = ms.place_tree(params_from_tree(d["params"], "cpu", stacked=tfm.STACKED),
                              pspecs, mesh)
            c = ms.place_tree({k: {n: t.clone() for n, t in v.items()}
                               for k, v in cache.items()}, cspecs, mesh)
            for i, tok in ((1, d["nxt"]), (2, d["nxt2"])):
                logits, c = tfm.lm_decode_step(p, ms.place(tok, ms.P("data", None), mesh), c,
                                               7 + i, cfg, ctx, decode_impl=impl)
                o[impl, i] = ms.gather(logits, tfm.logits_spec(ctx), mesh).numpy()
            o[impl, "cache"] = {k: {n: ms.gather(t, cspecs[k][n], mesh).numpy()
                                    for n, t in v.items()} for k, v in c.items()}
        if name == "gqa":
            pspecs = tfm.param_specs_splitkv(cfg)
            p = ms.place_tree(one, pspecs, mesh)
            cspecs = tfm.cache_specs(cfg, ctx.data_axes, "split")
            c = ms.place_tree(tfm.init_cache(cfg, B, S_MAX, device="cpu"), cspecs, mesh)
            toks = ms.place(d["prompt"], ms.P("data", None), mesh)
            for k in range(3):
                logits, c = tfm.lm_decode_step(p, toks[:, k * 8:(k + 1) * 8], c, k * 8, cfg,
                                               ctx, decode_impl="split_kv")
            o["prefill_sp"] = ms.gather(logits, tfm.logits_spec(ctx), mesh).numpy()
            logits, _ = tfm.lm_decode_step(p, ms.place(d["nxt"], ms.P("data", None), mesh),
                                           c, 24, cfg, ctx, decode_impl="split_kv")
            o["after_sp"] = ms.gather(logits, tfm.logits_spec(ctx), mesh).numpy()


def _rank_moe(ms, inp, ctx, mesh, out):
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import params_from_tree

    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1, capacity_factor=4.0)
    shared = {"w_gate": ms.P(None, "model"), "w_up": ms.P(None, "model"),
              "w_down": ms.P("model", None)}
    x = ms.place(inp["moe"]["x"], ms.P("data", None), mesh)
    for label, ax in (("ep", "model"), ("ep_all", ("data", "model"))):
        specs = {"router": ms.P(), "shared": shared,
                 **{w: ms.P(ax, None, None) for w in ("w_gate", "w_up", "w_down")}}
        p = ms.place_tree(params_from_tree(inp["moe"]["params"], "cpu"), specs, mesh)
        fn = moe.moe_ffn if label == "ep" else moe.moe_ffn_decode_ep_all
        y, aux = fn(p, x, cfg, ctx)
        out["moe", label] = (ms.gather(y, ms.P("data", None), mesh).numpy(),
                             float(aux) if torch.is_tensor(aux) else aux)


def _rank_gnn(ms, inp, out):
    from repro_torch.models import gnn
    from repro_torch.models.layers import params_from_tree

    mesh = ms.make_mesh((4, 2), ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    g = inp["gnn"]
    cfg = gnn.SAGEConfig(n_layers=2, d_in=24, d_hidden=32, n_classes=6)
    p = params_from_tree(g["params"], "cpu")
    place = {k: ms.place(g[k], ms.P("data", None), mesh) for k in ("feats", "agg0", "edges_sh")}
    logits = gnn.sage_forward_sharded(p, place["feats"], place["agg0"], place["edges_sh"],
                                      cfg, 512, ctx)
    out["gnn", "sharded"] = ms.gather(logits, ms.P("data", None), mesh).numpy()
    out["gnn", "one"] = gnn.sage_forward(p, g["feats"], g["edges"], cfg).numpy()
    # The port's own host-side preparation, on the same graph.
    mine = gnn.shard_graph(g["feats"], g["edges"], g["labels"], 4, 512, g["edges_sh"].shape[0],
                           "cpu")
    out["gnn", "shard_graph"] = {k: v.numpy() for k, v in mine.items()}
    blocks = {k: ms.place(mine[k], ms.P("data", None) if mine[k].ndim == 2 else ms.P("data"),
                          mesh) for k in mine}
    logits = gnn.sage_forward_sharded(p, blocks["feats"], blocks["agg0"], blocks["edges"],
                                      cfg, 512, ctx)
    out["gnn", "own_inputs"] = ms.gather(logits, ms.P("data", None), mesh).numpy()


def _rank_pod(ms, inp, out):
    import torch

    from repro_torch.optim.compression import compress_psum_pod

    mesh = ms.make_mesh((2, 2), ("pod", "data"))
    w = torch.from_numpy(inp["pod"]["w"])

    def grad_fn(batch_shard):
        with torch.enable_grad():
            wg = w.clone().requires_grad_(True)
            loss = torch.mean((batch_shard @ wg - 1.0) ** 2)
            return {"w": torch.autograd.grad(loss, wg)[0]}

    err = {"w": torch.zeros((2, 64))}
    res = compress_psum_pod(grad_fn, mesh)(torch.from_numpy(inp["pod"]["batch"]), err)
    if res is not None:
        grads, new_err = res
        out["pod"] = dict(grads=grads["w"].numpy(), err=new_err["w"].numpy())


def _rank_towers(ms, inp, ctx, mesh, out):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.recsys import rec_train_loss

    for name in TOWERS:
        arch = ARCHS[name]
        cfg = arch.model_config(reduced=True)
        d = inp["towers"][name]
        p = arch.params_from_numpy(d["params"], cfg, "cpu")
        p = ms.place_tree(p, arch.param_pspecs(cfg, p), mesh)
        res = {}
        for shape in ("serve_p99", "retrieval_cand"):
            step, _ = arch.build_step(cfg, shape, ctx)
            b = ms.place_tree(d["serve" if shape == "serve_p99" else "retrieval"],
                              arch.batch_pspecs(cfg, shape, ctx), mesh)
            res[shape] = ms.gather(step(p, b), step.out_specs, mesh).numpy()
        b = ms.place_tree(d["train"], arch.batch_pspecs(cfg, "train_batch", ctx), mesh)
        res["loss"] = float(rec_train_loss(p, b, cfg, ctx))
        out["towers", name] = res


def _rank_main(rank: str, world: str, init: str, inputs: str, path: str) -> None:
    import torch

    from repro_torch.distributed import sharding as ms

    torch.set_num_threads(1)
    rt = ms.init_mesh_group(device="cpu", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world), timeout_s=GROUP_TIMEOUT_S - 30)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    mesh = ms.make_mesh((2, 4), ("data", "model"))
    ctx = ms.ShardCtx(mesh)
    out: dict = {}
    with torch.no_grad():
        _rank_lm(ms, inp, ctx, mesh, out)
        _rank_moe(ms, inp, ctx, mesh, out)
        _rank_gnn(ms, inp, out)
        _rank_pod(ms, inp, out)
        _rank_towers(ms, inp, ctx, mesh, out)
    if rt.rank == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    ms.close_mesh_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
    sys.exit(0)


def _spawn_group(world: int, tmp: Path, inputs: Path) -> list:
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
    """(the port's answers on 8 ranks, the reference's, the inputs)."""
    tmp = tmp_path_factory.mktemp("mesh_models")
    inputs = make_inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    refs = {part: _reference(tmp / "inputs.pkl", tmp / f"ref_{part}.pkl", part)
            for part in ("lm", "rest")}
    procs, port_path = _spawn_group(8, tmp, tmp / "inputs.pkl")
    _wait(procs)
    want = {}
    for part, ref in refs.items():
        log = _wait([ref])[0]
        assert "REF_OK" in log, log[-3000:]
        with open(tmp / f"ref_{part}.pkl", "rb") as f:
            want.update(pickle.load(f))
    with open(port_path, "rb") as f:
        got = pickle.load(f)
    return got, want, inputs


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("name", ["gqa", "mla"])
@pytest.mark.parametrize("step", [1, 2])
def test_split_kv_decode_matches_reference(run, name, step):
    """Split-KV decode through the seq-sharded cache equals the reference's
    split decode and its single-device decode (the second step reads the
    first's write)."""
    got, want, _ = run
    assert rel(got[name]["split_kv", step], want[name]["split_kv", step]) < 2e-4
    assert rel(got[name]["split_kv", step], want[name][f"base{step}"]) < 2e-4


@pytest.mark.parametrize("name", ["gqa", "mla"])
@pytest.mark.parametrize("step", [1, 2])
def test_tensor_parallel_decode_matches_reference(run, name, step):
    """The baseline decode with a context (heads and FFN over model, MoE EP
    over model, the batch cache replicated over model). The reference's own
    MLA baseline decode with a context raises ``ShardingTypeError`` (its
    cache write under GSPMD, ROADMAP C7): there the port is held against
    the reference's single-device decode alone."""
    got, want, _ = run
    if name == "mla":
        assert want[name]["batch", "raised"] == "ShardingTypeError"
    else:
        assert rel(got[name]["batch", step], want[name]["batch", step]) < 2e-4
    assert rel(got[name]["batch", step], want[name][f"base{step}"]) < 2e-4


@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_split_cache_holds_the_batch_caches_tokens(run, name):
    """After two steps the split cache, gathered, is the batch layout's."""
    got, _, _ = run
    split, batch = got[name]["split_kv", "cache"], got[name]["batch", "cache"]
    for seg in split:
        for leaf in split[seg]:
            assert rel(split[seg][leaf], batch[seg][leaf]) < 2e-4, (seg, leaf)


def test_seq_parallel_prefill_then_decode_matches_reference(run):
    got, want, _ = run
    g, w = got["gqa"], want["gqa"]
    assert rel(g["prefill_sp"][:, -1], w["prefill_sp"][:, -1]) < 2e-4
    assert rel(g["prefill_sp"][:, -1], w["prefill_ref"][:, -1]) < 2e-4
    assert rel(g["after_sp"], w["after_sp"]) < 2e-4
    assert rel(g["after_sp"], w["after_ref"]) < 2e-4


@pytest.mark.parametrize("label", ["ep", "ep_all"])
def test_moe_expert_parallel_matches_reference(run, label):
    got, want, _ = run
    y, aux = got["moe", label]
    y_ref, aux_ref = want["moe"][label]
    assert rel(y, y_ref) < 1e-5
    assert rel(y, want["moe"]["local"][0]) < 1e-5
    # The aux loss is each data block's averaged: as the reference's pmean.
    assert abs(aux - float(aux_ref)) <= 1e-5 * max(abs(float(aux_ref)), 1e-9)
    if label == "ep":
        aux_local = float(want["moe"]["local"][1])
        assert aux > 0 and abs(aux - aux_local) / aux_local < 0.5


def test_sharded_sage_matches_reference(run):
    got, want, _ = run
    assert rel(got["gnn", "sharded"], want["gnn"]["sharded"]) < 3e-2
    assert rel(got["gnn", "sharded"], want["gnn"]["base"]) < 3e-2
    # Against the port's own one-device forward: only the bfloat16 gather
    # of the hidden rows differs.
    assert rel(got["gnn", "sharded"], got["gnn", "one"]) < 1e-2
    assert rel(got["gnn", "one"], want["gnn"]["base"]) < 1e-5


def test_shard_graph_builds_the_references_inputs(run):
    """``gnn.shard_graph`` gives the reference test's host-side layout:
    the first hop's mean and the edges binned by destination block."""
    got, _, inp = run
    mine = got["gnn", "shard_graph"]
    g = inp["gnn"]
    assert rel(mine["agg0"][:512], g["agg0"]) < 1e-6
    w_ref, w = g["edges_sh"].shape[0] // 4, mine["edges"].shape[0] // 4
    for s in range(4):
        a = g["edges_sh"][s * w_ref:(s + 1) * w_ref]
        b = mine["edges"][s * w:(s + 1) * w]
        np.testing.assert_array_equal(a[a[:, 0] >= 0], b[b[:, 0] >= 0])
    assert rel(got["gnn", "own_inputs"], got["gnn", "sharded"]) < 1e-6


def test_compressed_pod_exchange_matches_reference(run):
    got, want, _ = run
    assert rel(got["pod"]["grads"], want["pod"]["mean"]) < 2e-2
    assert rel(got["pod"]["grads"], want["pod"]["grads"]["w"]) < 1e-6
    assert got["pod"]["err"].shape == want["pod"]["err"]["w"].shape == (2, 64)
    assert np.abs(got["pod"]["err"]).max() > 0
    # Each pod's residue of the same quantizer; the float32 gradients it
    # quantizes differ in their last bits between the packages.
    assert rel(got["pod"]["err"], want["pod"]["err"]["w"]) < 1e-3


@pytest.mark.parametrize("name", TOWERS)
def test_towers_on_row_sharded_tables_match_reference(run, name):
    got, want, _ = run
    g, w = got["towers", name], want["towers"][name]
    assert rel(g["serve_p99"], w["serve"]) < 1e-5
    assert rel(g["retrieval_cand"], w["retrieval"]) < 1e-5
    assert abs(g["loss"] - float(w["loss"])) <= 1e-5 * abs(float(w["loss"]))
