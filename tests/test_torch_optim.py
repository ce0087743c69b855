"""The port's optimizer, schedule and compression against the reference's.

The same numpy parameters and gradients go through both packages'
``adamw_update`` (JAX eager on the CPU against the port on the CPU), three
steps, for the three moment dtypes:

  * without clipping (global norm < ``grad_clip``) the parameters, both
    moments and the step are equal bit for bit; ``grad_norm`` is within
    4 ulps (float32 sums of squares: XLA's reduction order is not
    torch's);
  * with clipping the clip scale inherits that ulp, so every leaf is held
    within rtol 1e-5 and atol 1e-6 x the leaf's largest magnitude.

The schedule is equal bit for bit except where ``cos`` enters: there a
1-ulp difference between XLA's float32 cos and torch's (cos(0.8 pi) =
-0.809) becomes 4 ulps of ``1 + cos`` = 0.191 and 2 ulps of the rate, so
the rate is held within 4 ulps. The int8 moment quantizer
(``_q8``/``_dq8``, half-to-even ties, padding of the last axis) and the
compression's quantizer are bitwise. The state's layout, stacked
``[L, ...]`` for the LM segments, is the reference's ``init_opt_state``
tree leaf for leaf (shapes and dtypes), and the leaves are visited in the
reference's flattening order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_sched
from repro_torch.configs.registry import ARCHS
from repro_torch.models.layers import param_leaves, params_from_tree, params_to_tree, tree_to_flat
from repro_torch.optim import adamw, compression, schedule
from repro_torch.train.trainer import opt_state_to_tree

MOMENTS = ["fp32", "bf16", "int8"]
STACKED = ("dense",)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"w": rng.standard_normal((3, 5, 300)).astype(np.float32),
                  "b": rng.standard_normal((3, 7)).astype(np.float32)},
        "embed": rng.standard_normal((11, 260)).astype(np.float32),
        "blocks": [{"ln": rng.standard_normal((9,)).astype(np.float32)},
                   {"ln": rng.standard_normal((9,)).astype(np.float32)}],
    }


def _grads(rng, tree, scale):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _ulps(a, b) -> int:
    return int(abs(np.int64(np.float32(a).view(np.int32)) - np.int64(np.float32(b).view(np.int32))))


def _run_both(md: str, scale: float, steps: int = 3):
    tree = _tree(0)
    rng = np.random.default_rng(1)
    rcfg, pcfg = ref_adamw.AdamWConfig(moment_dtype=md), adamw.AdamWConfig(moment_dtype=md)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_adamw.init_opt_state(rp, rcfg)
    pp = params_from_tree(tree, "cpu", stacked=STACKED)
    ps = adamw.init_opt_state(pp, pcfg)
    out = []
    for _ in range(steps):
        g = _grads(rng, tree, scale)
        lr = ref_sched.cosine_with_warmup(rs["step"], peak=3e-4, warmup=2, total=10)
        plr = schedule.cosine_with_warmup(ps["step"], peak=3e-4, warmup=2, total=10)
        assert _bits(np.asarray(lr)) == _bits(plr.numpy())
        rp, rs, rm = ref_adamw.adamw_update(rp, jax.tree.map(jnp.asarray, g), rs, rcfg, lr)
        pg = {k: torch.from_numpy(v) for k, v in tree_to_flat(g, STACKED).items()}
        pp, ps, pm = adamw.adamw_update(pp, pg, ps, pcfg, plr)
        want = _flat(jax.tree.map(np.asarray, {"params": rp, "opt_state": rs}))
        got = _flat({"params": params_to_tree(pp), "opt_state": opt_state_to_tree(ps, STACKED)})
        assert got.keys() == want.keys()
        out.append((got, want, float(pm["grad_norm"]), float(rm["grad_norm"])))
    return out


@pytest.mark.parametrize("md", MOMENTS)
def test_adamw_is_the_references_bitwise_without_clipping(md):
    for got, want, gn, rgn in _run_both(md, 1e-3):
        assert rgn < 1.0
        assert _ulps(gn, rgn) <= 4, (gn, rgn)
        for k in want:
            assert got[k].dtype.itemsize == want[k].dtype.itemsize and got[k].shape == \
                want[k].shape, k
            assert _bits(got[k]) == _bits(want[k]), k


@pytest.mark.parametrize("md", MOMENTS)
def test_adamw_is_the_references_within_ulps_with_clipping(md):
    for got, want, gn, rgn in _run_both(md, 1.0):
        assert rgn > 1.0
        assert _ulps(gn, rgn) <= 4, (gn, rgn)
        for k in want:
            g, w = got[k], want[k]
            if w.dtype.kind == "V" or w.dtype.name == "bfloat16":
                g, w = g.view(np.uint16).view(np.int16), w.view(np.uint16).view(np.int16)
                g = torch.from_numpy(g.copy()).view(torch.bfloat16).float().numpy()
                w = torch.from_numpy(w.copy()).view(torch.bfloat16).float().numpy()
                rtol = 2 ** -7  # one bfloat16 ulp of a 1-ulp float32 difference
            else:
                rtol = 1e-5
            if w.dtype == np.int8:  # int8 moments: one quantum
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, k
                continue
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=1e-6 * float(np.abs(w).max() + 1e-30), err_msg=k)


def test_schedule_is_the_references():
    worst = 0
    for step in range(0, 30):
        for warmup, total in ((0, 10), (5, 20), (10, 12), (3, 3)):
            want = np.asarray(ref_sched.cosine_with_warmup(
                jnp.int32(step), peak=3e-4, warmup=warmup, total=total))
            got = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32), peak=3e-4,
                                              warmup=warmup, total=total).numpy()
            assert got.dtype == np.float32
            if step < warmup:
                assert _bits(got) == _bits(want), (step, warmup, total)
            worst = max(worst, _ulps(got, want))
    assert worst <= 4
    assert float(schedule.cosine_with_warmup(4, peak=1.0, warmup=10, total=20)) == \
        float(ref_sched.cosine_with_warmup(4, peak=1.0, warmup=10, total=20))
    c = schedule.constant(torch.tensor(3), peak=3e-4)
    assert c.dtype == torch.float32 and _bits(c.numpy()) == _bits(
        np.asarray(ref_sched.constant(jnp.int32(3), peak=3e-4)))


@pytest.mark.parametrize("shape", [(300,), (4, 256), (2, 3, 513), (1,)])
def test_q8_is_the_references(shape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    ties = np.array([127.0, -63.5, 0.0], np.float32)  # -63.5 is a half-way tie
    x.reshape(-1)[:3] = ties[:x.size]
    want = ref_adamw._q8(jnp.asarray(x))
    got = adamw._q8(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert _bits(got["scale"].numpy()) == _bits(np.asarray(want["scale"]))
    back = adamw._dq8(got, torch.from_numpy(x))
    assert _bits(back.numpy()) == _bits(np.asarray(ref_adamw._dq8(want, jnp.asarray(x))))
    assert adamw.is_q8_leaf(got) and not adamw.is_q8_leaf(back)


def test_moments_take_the_steps_dtype():
    """An fp32 state given to an int8 step comes back int8, in both."""
    tree = _tree(3)
    g = _grads(np.random.default_rng(4), tree, 1e-3)
    rp = jax.tree.map(jnp.asarray, tree)
    rs = ref_adamw.init_opt_state(rp, ref_adamw.AdamWConfig())
    _, rs, _ = ref_adamw.adamw_update(rp, jax.tree.map(jnp.asarray, g), rs,
                                      ref_adamw.AdamWConfig(moment_dtype="int8"), 1e-3)
    pp = params_from_tree(tree, "cpu", stacked=STACKED)
    ps = adamw.init_opt_state(pp, adamw.AdamWConfig())
    assert not any(adamw.is_q8_leaf(m) for m in ps["m"].values())
    pg = {k: torch.from_numpy(v) for k, v in tree_to_flat(g, STACKED).items()}
    _, ps, _ = adamw.adamw_update(pp, pg, ps, adamw.AdamWConfig(moment_dtype="int8"),
                                  torch.tensor(1e-3))
    assert all(adamw.is_q8_leaf(m) for m in ps["m"].values())
    want = _flat(jax.tree.map(np.asarray, rs))
    got = _flat(opt_state_to_tree(ps, STACKED))
    assert got.keys() == want.keys()
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


@pytest.mark.parametrize("name,md", [("qwen3-4b", "fp32"), ("deepseek-v3-671b", "int8"),
                                     ("moonshot-v1-16b-a3b", "bf16"), ("bert4rec", "fp32")])
def test_state_layout_and_leaf_order_are_the_references(name, md):
    ref, arch = REF_ARCHS[name], ARCHS[name]
    cfg = ref.model_config(True)
    tree = jax.tree.map(np.asarray, jax.jit(ref.init_params, static_argnums=1)(
        jax.random.key(0), cfg))
    params = arch.params_from_numpy(tree, arch.model_config(True), device="cpu")
    # jax.tree.leaves' order, leaf by leaf (a stacked leaf's layers together).
    want_order = [jax.tree_util.keystr(path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(tree)[0]]
    got_order = []
    for n in param_leaves(params):
        parts = n.split(".")
        if parts[0] in arch.stacked:
            parts = [parts[0], *parts[2:]]
        key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts)
        if not got_order or got_order[-1] != key:
            got_order.append(key)
    assert got_order == want_order
    ref_state = jax.tree.map(np.asarray, jax.jit(ref_adamw.init_opt_state, static_argnums=1)(
        tree, ref_adamw.AdamWConfig(moment_dtype=md)))
    want = _flat(ref_state)
    state = adamw.init_opt_state(params, adamw.AdamWConfig(moment_dtype=md))
    got = _flat(arch.opt_state_to_numpy(state, cfg))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype.itemsize == \
            want[k].dtype.itemsize, k
        assert _bits(got[k]) == _bits(want[k]), k
    back = arch.opt_state_from_numpy(ref_state, cfg, device="cpu")
    assert back.keys() == state.keys() and back["m"].keys() == state["m"].keys()


@pytest.mark.parametrize("shape", [(1000, 37), (256,), (3, 5)])
def test_compression_quantizer_is_the_references(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    q, s = ref_comp._quantize(jnp.asarray(x))
    pq, ps = compression._quantize(torch.from_numpy(x))
    assert np.array_equal(pq.numpy(), np.asarray(q)) and _bits(ps.numpy()) == _bits(np.asarray(s))
    assert _bits(compression._dequantize(pq, ps, x.shape).numpy()) == _bits(
        np.asarray(ref_comp._dequantize(q, s, x.shape)))


def test_error_buffers_and_the_pod_exchange():
    tree = _tree(6)
    bufs = compression.init_error_buffers(params_from_tree(tree, "cpu"), 2)
    want = _flat(jax.tree.map(np.asarray, ref_comp.init_error_buffers(tree, 2)))
    got = {"/".join(n.split(".")) + "/": b.numpy() for n, b in bufs.items()}
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape and not v.any()
    # The pod exchange on one pod (a one-process mesh, pod x data = 1 x 1):
    # the gradient through the int8 quantizer, bit for bit the reference's,
    # and its residue kept for the next step. (Eight ranks, two pods:
    # tests/test_torch_mesh_models.py.)
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro_torch.distributed.sharding import LocalMesh

    batch = np.random.default_rng(9).standard_normal((4, 300)).astype(np.float32)
    err0 = np.random.default_rng(10).standard_normal((1, 300)).astype(np.float32) * 1e-3
    mesh = jax.make_mesh((1, 1), ("pod", "data"))
    wgrads, werr = jax.jit(ref_comp.compress_psum_pod(lambda b: {"w": b.sum(0)}, mesh))(
        jax.device_put(jnp.asarray(batch), NamedSharding(mesh, JP("pod"))),
        {"w": jnp.asarray(err0)})
    ggrads, gerr = compression.compress_psum_pod(lambda b: {"w": b.sum(0)}, LocalMesh(
        ("pod", "data")))(torch.from_numpy(batch), {"w": torch.from_numpy(err0)})
    assert _bits(ggrads["w"].numpy()) == _bits(np.asarray(wgrads["w"]))
    assert gerr["w"].shape == (1, 300)
    np.testing.assert_allclose(gerr["w"].numpy(), np.asarray(werr["w"]), rtol=0, atol=1e-6)
