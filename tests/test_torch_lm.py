"""The port's LM blocks and steps against the reference's, on the CPU.

The same numpy inputs and the reference's own parameters (``init_*`` with
a JAX key, carried across with ``params_from_tree`` /
``Arch.params_from_numpy``) go through both packages, in float32, within
rtol 1e-4 / atol 1e-5 (``np.testing.assert_allclose``): the layers (RMSNorm,
the RoPE table bit for bit, RoPE, SwiGLU), GQA and MLA with and without a
cache (the cache written at ``lax.dynamic_update_slice``'s clamped start),
MoE (a constructed routing tie, capacity drops, the routing indices
``topi`` and dispatch ranks exactly), then ``lm_forward`` and the
``prefill_32k``/``decode_32k`` steps of each of the five reduced LM
configs, both variants. Every mesh function raises naming its ROADMAP item
(training is held in ``test_torch_train*.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tfm
from repro_torch.configs.registry import ARCHS
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.models.layers import params_from_tree

RTOL, ATOL = 1e-4, 1e-5
LM_NAMES = ["qwen3-4b", "qwen2.5-3b", "deepseek-67b", "deepseek-v3-671b",
            "moonshot-v1-16b-a3b"]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _port(params):
    """A reference parameter dict as the port's ``Params`` on the CPU."""
    return params_from_tree(_tree(params), "cpu")


# ------------------------------------------------------------------ layers


def test_rope_table_is_the_references_bit_for_bit():
    for hd, n, theta in ((16, 64, 10000.0), (128, 300, 1_000_000.0), (64, 7, 500.0)):
        want = np.asarray(ref_layers.rope_freqs(hd, n, theta))
        got = layers.rope_freqs(hd, n, theta).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 5, 3, 16)
    w = _np(rng, 16)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    rope = ref_layers.rope_freqs(16, 64)
    pos = np.array([0, 3, 9, 63, 70], np.int32)  # 70: past the table, clamped
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(rope)),
                             torch.from_numpy(pos)),
           ref_layers.apply_rope(jnp.asarray(x), rope, jnp.asarray(pos)))
    p = ref_layers.swiglu_init(jax.random.key(1), 16, 24, jnp.float32)
    xs = _np(rng, 4, 16)
    _close(layers.swiglu(_port(p), torch.from_numpy(xs)), ref_layers.swiglu(p, jnp.asarray(xs)))


def test_bfloat16_crosses_bit_for_bit():
    cfg = dataclasses.replace(REF_ARCHS["deepseek-v3-671b"].model_config(True),
                              dtype=jnp.bfloat16)
    tree = _tree(jax.jit(ref_tfm.init_lm, static_argnums=1)(jax.random.key(0), cfg))
    params = ARCHS["deepseek-v3-671b"].params_from_numpy(tree, cfg, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["moe"][0]["moe"]["router"].dtype == torch.float32
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        layered = keys[0] in ("dense", "moe")
        for i in range(leaf.shape[0] if layered else 1):
            node = params[keys[0]][i] if layered else params[keys[0]]
            for k in keys[1:]:
                node = node[k]
            want = leaf[i] if layered else leaf
            bits = np.int16 if want.dtype.itemsize == 2 else np.int32
            got = node.detach().view(torch.int16 if bits is np.int16 else torch.int32)
            assert np.array_equal(got.numpy(), np.ascontiguousarray(want).view(bits)), keys
            n += 1
    assert n == len(list(params.state_dict()))
    assert "mtp.block.attn.w_uq" in params.state_dict()


# --------------------------------------------------------------- attention

GQA_CFGS = [
    ref_attn.GQAConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True),
    ref_attn.GQAConfig(d_model=32, n_heads=4, n_kv_heads=1, head_dim=8, qkv_bias=True),
    ref_attn.GQAConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8),
]
MLA_CFG = ref_attn.MLAConfig(d_model=32, n_heads=4, q_lora_rank=16, kv_lora_rank=8,
                             qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8)


def _port_cfg(cfg):
    kind = attention.MLAConfig if isinstance(cfg, ref_attn.MLAConfig) else attention.GQAConfig
    return kind(**dataclasses.asdict(cfg))


def _nonzero_bias(p, rng):
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = jnp.asarray(_np(rng, *p[b].shape, scale=0.1))
    return p


@pytest.mark.parametrize("which", ["gqa-qknorm", "gqa-bias", "gqa-mha", "mla"])
@pytest.mark.parametrize("cached", [False, True], ids=["nocache", "cache"])
def test_attention_is_the_references(which, cached):
    rng = np.random.default_rng(3)
    if which == "mla":
        cfg, init, fn, port_fn = MLA_CFG, ref_attn.init_mla, ref_attn.mla, attention.mla
        cache_shape = {"c_kv": (2, 24, 8), "k_rope": (2, 24, 4)}
        rope = ref_layers.rope_freqs(cfg.qk_rope_head_dim, 64)
    else:
        cfg = GQA_CFGS[["gqa-qknorm", "gqa-bias", "gqa-mha"].index(which)]
        init, fn, port_fn = ref_attn.init_gqa, ref_attn.gqa, attention.gqa
        cache_shape = {k: (2, 24, cfg.n_kv_heads, cfg.head_dim) for k in ("k", "v")}
        rope = ref_layers.rope_freqs(cfg.head_dim, 64)
    p = _nonzero_bias(init(jax.random.key(2), cfg, jnp.float32), rng)
    pp = _port(p)
    fn = jax.jit(fn, static_argnames=("cfg", "chunk"))
    prope = torch.from_numpy(np.array(rope))
    # chunk 4 divides S = 8 (two query chunks); S = 6 falls back to one chunk.
    for S, chunk, pos in ((8, 4, 0), (6, 4, 5), (8, 4, 20), (1, 4, 23)):
        x = _np(rng, 2, S, cfg.d_model)
        kw = dict(chunk=chunk)
        if cached:
            cache = {k: _np(rng, *s) for k, s in cache_shape.items()}
            positions = np.arange(S, dtype=np.int32) + pos
            want, wc = fn(p, jnp.asarray(x), rope, cfg=cfg, positions=jnp.asarray(positions),
                          cache={k: jnp.asarray(v) for k, v in cache.items()},
                          cache_pos=jnp.int32(pos), **kw)
            pc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
            got, gc = port_fn(pp, torch.from_numpy(x), prope, _port_cfg(cfg),
                              positions=torch.from_numpy(positions), cache=pc,
                              cache_pos=pos, **kw)
            assert gc is pc  # updated in place
            for k in cache:  # pos 20 with S 8 writes at the clamped start 16
                _close(gc[k], wc[k])
        else:
            positions = np.arange(S, dtype=np.int32)
            want, _ = fn(p, jnp.asarray(x), rope, cfg=cfg, positions=jnp.asarray(positions),
                         **kw)
            got, gc = port_fn(pp, torch.from_numpy(x), prope, _port_cfg(cfg),
                              positions=torch.from_numpy(positions), **kw)
            assert gc is None
        _close(got, want)


# --------------------------------------------------------------------- MoE

MOE_CFG = ref_moe.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1)


def _port_moe_cfg(cfg):
    return moe.MoEConfig(**dataclasses.asdict(cfg))


def _route_both(p, x, cfg):
    rv, ri, ra = ref_moe._route(p["router"], jnp.asarray(x), cfg)
    pv, pi, pa = moe._route(torch.from_numpy(np.array(p["router"])), torch.from_numpy(x),
                            _port_moe_cfg(cfg))
    assert pi.tolist() == np.asarray(ri).tolist()  # routing indices exactly
    _close(pv, rv)
    _close(pa, ra)
    return np.asarray(ri)


@pytest.mark.parametrize("case", ["random", "tie", "capacity"])
def test_moe_is_the_references(case):
    rng = np.random.default_rng(7)
    cfg = MOE_CFG
    p = ref_moe.init_moe(jax.random.key(4), 16, cfg, jnp.float32)
    T = 24
    x = _np(rng, T, 16)
    if case == "tie":
        # Experts 2 and 5 (and 6 and 1) get equal logits on every token:
        # lax.top_k takes the lower index first.
        router = np.asarray(p["router"]).copy()
        router[:, 5] = router[:, 2]
        router[:, 1] = router[:, 6]
        p = dict(p, router=jnp.asarray(router))
        x[:4] = 0.0  # every expert ties on these tokens
    elif case == "capacity":
        # A router biased to experts 0 and 3 overflows their capacity.
        router = np.zeros((16, cfg.n_experts), np.float32)
        router[:, 0], router[:, 3] = 1.0, 0.5
        p = dict(p, router=jnp.asarray(router))
        T = 64
        x = np.abs(_np(rng, T, 16)) + 0.1
    topi = _route_both(p, x, cfg)
    if case == "tie":
        assert topi[:4].tolist() == [[0, 1]] * 4
    flat = np.where(topi.reshape(-1) < cfg.n_experts, topi.reshape(-1), cfg.n_experts)
    want_rank = np.asarray(ref_moe._dispatch_ranks(jnp.asarray(flat, jnp.int32),
                                                   cfg.n_experts + 1))
    got_rank = moe._dispatch_ranks(torch.from_numpy(flat).long(), cfg.n_experts + 1)
    assert got_rank.tolist() == want_rank.tolist()
    C = moe._capacity(T, _port_moe_cfg(cfg))
    assert C == ref_moe._capacity(T, cfg)
    if case == "capacity":
        assert (want_rank >= C).sum() > 0  # slots dropped past capacity
    want, waux = jax.jit(ref_moe.moe_ffn, static_argnums=2)(p, jnp.asarray(x), cfg)
    got, gaux = moe.moe_ffn(_port(p), torch.from_numpy(x), _port_moe_cfg(cfg))
    _close(got, want)
    _close(gaux, waux)


def test_moe_and_attention_mesh_paths_raise():
    p = moe.init_moe(torch.Generator().manual_seed(0), 8, _port_moe_cfg(MOE_CFG),
                     torch.float32, "cpu")
    x = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError, match="A7"):
        moe.moe_ffn(p, x, _port_moe_cfg(MOE_CFG), shard_ctx=object())
    with pytest.raises(NotImplementedError, match="A7"):
        moe.moe_ffn_decode_ep_all(p, x, _port_moe_cfg(MOE_CFG), object())
    for fn in (attention.gqa_decode_splitkv, attention.mla_decode_splitkv,
               attention.gqa_prefill_splitkv):
        with pytest.raises(NotImplementedError, match="A7"):
            fn(None, None, None, None, None, 0, object())
    cfg = ARCHS["qwen3-4b"].model_config(True)
    for fn, args in ((transformer.param_specs, (cfg,)),
                     (transformer.cache_specs, (cfg, ("data",))),
                     (transformer.param_specs_splitkv, (cfg,))):
        with pytest.raises(NotImplementedError, match="A7"):
            fn(*args)
    # lm_loss is ported (tests/test_torch_train_archs.py); its mesh form raises.
    with pytest.raises(NotImplementedError, match="A7"):
        transformer.lm_loss(None, None, cfg, shard_ctx=object())


# ------------------------------------------------------------------- the LM


@pytest.fixture(scope="module")
def lm_params():
    """Each reduced LM's reference parameters and the port's carried copy."""
    out = {}
    for name in LM_NAMES:
        cfg = REF_ARCHS[name].model_config(True)
        p = jax.jit(ref_tfm.init_lm, static_argnums=1)(jax.random.key(0), cfg)
        out[name] = (p, ARCHS[name].params_from_numpy(_tree(p), cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_forward_is_the_references(name, lm_params):
    rcfg = REF_ARCHS[name].model_config(True)
    cfg = ARCHS[name].model_config(True)
    p, pp = lm_params[name]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 64)).astype(np.int32)
    want_h, want_aux = jax.jit(lambda p, t: ref_tfm.lm_forward(p, t, rcfg))(p, tokens)
    got_h, got_aux = transformer.lm_forward(pp, tokens, cfg)
    _close(got_h, want_h)
    _close(got_aux, want_aux)
    assert transformer.count_params(cfg) == ref_tfm.count_params(rcfg)


def _moe_inputs(name, p, pp, tokens):
    """Each MoE layer's input on both packages (the reference's layer by
    layer), for an exact routing comparison."""
    rcfg = REF_ARCHS[name].model_config(True)
    cfg = ARCHS[name].model_config(True)
    rope = ref_layers.rope_freqs(rcfg.attn.qk_rope_head_dim if isinstance(
        rcfg.attn, ref_attn.MLAConfig) else rcfg.attn.head_dim, rcfg.max_seq,
        rcfg.attn.rope_theta)
    prope = transformer.rope_table(cfg, cfg.max_seq, "cpu")
    pos = np.arange(tokens.shape[1])
    x = p["embed"][tokens]
    xp = pp["embed"][torch.from_numpy(tokens).long()]
    out = []
    for seg, use_moe in (("dense", False), ("moe", True)):
        n = jax.tree.leaves(p[seg])[0].shape[0]
        for i in range(n):
            layer = jax.tree.map(lambda a: a[i], p[seg])
            players = pp[seg][i]
            if use_moe:
                h, _ = ref_tfm._attn(layer["attn"], ref_layers.rms_norm(x, layer["ln1"]),
                                     rope, rcfg, positions=jnp.asarray(pos))
                z = ref_layers.rms_norm(x + h, layer["ln2"])
                hp, _ = transformer._attn(players["attn"], layers.rms_norm(xp, players["ln1"]),
                                          prope, cfg, positions=torch.from_numpy(pos))
                zp = layers.rms_norm(xp + hp, players["ln2"])
                out.append((layer["moe"], z.reshape(-1, z.shape[-1]),
                            zp.reshape(-1, zp.shape[-1])))
            x, _ = ref_tfm._layer_apply(layer, x, rope, rcfg, jnp.asarray(pos), use_moe, None)
            xp, _ = transformer._layer_apply(players, xp, prope, cfg,
                                             torch.from_numpy(pos), use_moe, None)
    return out


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "moonshot-v1-16b-a3b"])
def test_lm_moe_routing_is_exact(name, lm_params):
    """Every MoE layer of the forward pass routes each token to the same
    experts as the reference (``topi`` exactly)."""
    rcfg = REF_ARCHS[name].model_config(True)
    p, pp = lm_params[name]
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, size=(2, 64)).astype(np.int32)
    for lp, z, zp in _moe_inputs(name, p, pp, tokens):
        _close(zp, z)
        _, ri, _ = ref_moe._route(lp["router"], z, rcfg.moe)
        _, gi, _ = moe._route(torch.from_numpy(np.array(lp["router"])), zp,
                              ARCHS[name].model_config(True).moe)
        assert gi.tolist() == np.asarray(ri).tolist()


def _filled_cache(ref_batch, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                        ref_batch["cache"])


@pytest.mark.parametrize("variant", ["baseline", "split_kv"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_step_is_the_references(name, shape, variant, lm_params):
    """The registry's serve steps: prefill over 64 tokens in chunks, decode
    at pos 32 over a filled 64-slot cache (``long_500k``, a cell the
    reference skips, builds the decode step at batch 1); logits and the
    cache after."""
    ra, pa = REF_ARCHS[name], ARCHS[name]
    rcfg, cfg = ra.model_config(True), pa.model_config(True)
    p, pp = lm_params[name]
    rb = ra.make_batch(rcfg, shape, seed=0)
    pb = pa.make_batch(cfg, shape, seed=0, device="cpu")
    assert np.array_equal(np.asarray(rb["tokens"]), pb["tokens"])
    if shape != "prefill_32k":
        filled = _filled_cache(rb, 1)
        rb = dict(rb, cache=jax.tree.map(jnp.asarray, filled))
        pb = dict(pb, cache=jax.tree.map(lambda a: torch.from_numpy(a.copy()), filled))
        assert int(pb["pos"]) == int(rb["pos"]) == 32
    step, kind = ra.build_step(rcfg, shape, variant=variant)
    pstep, pkind = pa.build_step(cfg, shape, variant=variant)
    assert pkind == kind == "serve"
    want_logits, want_cache = jax.jit(step)(p, rb)
    got_logits, got_cache = pstep(pp, pb)
    assert got_logits.dtype == torch.float32 and got_logits.shape == want_logits.shape
    _close(got_logits, want_logits)
    assert jax.tree.structure(jax.tree.map(np.asarray, want_cache)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), got_cache))
    for g, w in zip(jax.tree.leaves(got_cache), jax.tree.leaves(want_cache)):
        _close(g, w)


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-v3-671b"])
def test_lm_decode_appends_what_a_longer_prefill_computes(name, lm_params):
    """Decode consistency on the CPU: a token appended at position 40 by the
    cached decode step has the logits of an uncached pass over 41 tokens.
    An MoE's capacity drops depend on the batch's other tokens, so the MoE
    config runs with a capacity that drops nothing (``capacity_factor`` =
    n_experts / top_k)."""
    cfg = ARCHS[name].model_config(True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    _, pp = lm_params[name]
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 41)).astype(np.int32)
    cache = transformer.init_cache(cfg, 2, 64, device="cpu")
    _, cache = transformer.lm_decode_step(pp, tokens[:, :40], cache, 0, cfg)
    step, _ = ARCHS[name].build_step(cfg, "decode_32k")
    got, _ = step(pp, {"tokens": tokens[:, 40:], "cache": cache, "pos": np.int32(40)})
    h, _ = transformer.lm_forward(pp, tokens, cfg)
    want = layers.dot_f32(h[:, -1:], pp["lm_head"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
