"""Port EmbeddingBag path vs the JAX reference: bag reduce and lookups.

The same inputs, made with numpy from a seed, go through the JAX package's
``kernels/embedding_bag`` and ``models/embedding`` (the Pallas kernel in
interpret mode, as its own tests run it) and through the port. Each port
implementation is held against its own JAX counterpart:

  * ``impl="cuda"`` (on CPU tensors the kernel wrapper returns its plain
    version, which sums in float32) against JAX ``impl="pallas"``;
  * ``impl="torch"`` (a contraction in the inputs' dtype) against JAX
    ``impl="xla"``.

For float32 the two semantics agree; for bfloat16 they round at other
places. Tolerances are the JAX package's own
(``tests/test_kernels_embedding_bag.py``): 1e-6 for float32, 2e-2 for
bfloat16. ``tests/test_torch_cuda.py`` holds the CUDA kernel against its
plain version on the card.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs.other_archs import _autoint_reduced, _mind_reduced
from repro.kernels.embedding_bag.ops import bag_reduce as jax_bag_reduce
from repro.models import embedding as jemb
from repro.models.recsys import init_rec
from repro_torch.kernels.embedding_bag import kernel, ops, ref
from repro_torch.models import embedding as temb
from repro_torch.models.embedding import table_from_numpy

SHAPES = [(4, 3, 8), (17, 20, 32), (128, 200, 64), (33, 7, 130)]
DTYPES = ["float32", "bfloat16"]
# port impl -> JAX impl with the same semantics
IMPL_PAIRS = [("cuda", "pallas"), ("torch", "xla")]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """One float32 array as (JAX array, torch tensor) of ``dtype``, same bits."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, table_from_numpy(np.asarray(j), device="cpu")


def _ids(a: np.ndarray):
    return jnp.asarray(a, jnp.int32), torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("B,L,D", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bag_reduce_matches_jax(impl, jax_impl, B, L, D, dtype):
    rng = np.random.default_rng(B * 1000 + L)
    jrows, rows = _pair(rng.normal(0, 1, size=(B, L, D)).astype(np.float32), dtype)
    jw, w = _pair(rng.normal(0, 1, size=(B, L)).astype(np.float32), dtype)
    got = ops.bag_reduce(rows, w, impl=impl)
    want = jax_bag_reduce(jrows, jw, impl=jax_impl)
    assert got.dtype == rows.dtype and tuple(got.shape) == (B, D)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_sums_in_float32(dtype):
    """The kernel's plain version rounds once, at the end (as _bag_kernel)."""
    rows = torch.full((1, 300, 4), 1.0).to(getattr(torch, dtype))
    w = torch.full((1, 300), 1 / 256).to(getattr(torch, dtype))
    want = torch.full((1, 4), 300 / 256).to(getattr(torch, dtype))
    assert torch.equal(ref.bag_reduce_plain(rows, w), want)
    assert torch.equal(kernel.bag_reduce(rows, w), want)


@pytest.mark.parametrize("B,L,D", [(0, 5, 8), (3, 0, 8), (3, 5, 0)])
def test_bag_reduce_empty_shapes(B, L, D):
    rows, w = torch.ones(B, L, D), torch.ones(B, L)
    got = kernel.bag_reduce(rows, w)
    assert tuple(got.shape) == (B, D) and torch.equal(got, torch.zeros(B, D))


@pytest.mark.parametrize(
    "rows,w,err",
    [
        (torch.ones(2, 3, 4, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64),
         TypeError),
        (torch.ones(2, 3, 4), torch.ones(2, 3, dtype=torch.bfloat16), TypeError),
        (torch.ones(2, 3), torch.ones(2, 3), ValueError),
        (torch.ones(2, 3, 4), torch.ones(2, 4), ValueError),
        (np.ones((2, 3, 4), np.float32), torch.ones(2, 3), TypeError),
    ],
)
def test_bag_reduce_wrapper_rejects_bad_inputs(rows, w, err):
    with pytest.raises(err):
        kernel.bag_reduce(rows, w)


def _bag_case(rng, V, B, L, dtype):
    table = rng.normal(0, 1, size=(V, 16)).astype(np.float32)
    ids = rng.integers(0, V + 5, size=(B, L)).astype(np.int32)  # some ids >= V
    n_pad = rng.integers(0, L + 1, size=B)
    ids[np.arange(L)[None, :] >= (L - n_pad)[:, None]] = -1  # trailing padding
    weights = rng.normal(0, 1, size=(B, L)).astype(np.float32)
    return _pair(table, dtype), _ids(ids), _pair(weights, dtype)


@pytest.mark.parametrize("impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_bag_matches_jax(impl, jax_impl, combine, weighted, dtype):
    rng = np.random.default_rng(5)
    (jtable, table), (jids, ids), (jw, w) = _bag_case(rng, 50, 12, 9, dtype)
    got = temb.embedding_bag(table, ids, w if weighted else None, combine, impl=impl)
    want = jemb.embedding_bag(jtable, jids, jw if weighted else None, combine,
                              impl=jax_impl)
    assert got.dtype == table.dtype and tuple(got.shape) == (12, 16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("impl,jax_impl", IMPL_PAIRS + [(None, "xla")])
def test_embedding_bag_clamps_ids_past_the_table(impl, jax_impl):
    """An id >= V reads row V-1, as JAX's clamped gather does; -1 adds nothing."""
    a = np.arange(20, dtype=np.float32).reshape(10, 2)
    ids = np.array([[12, 1], [-1, 9]], np.int32)
    got = temb.embedding_bag(torch.from_numpy(a), torch.from_numpy(ids), impl=impl)
    want = jemb.embedding_bag(jnp.asarray(a), jnp.asarray(ids), impl=jax_impl)
    assert got.tolist() == [[20.0, 22.0], [18.0, 19.0]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_bag_rejects_unknown_options():
    table, ids = torch.ones(4, 2), torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="combine"):
        temb.embedding_bag(table, ids, combine="max")
    with pytest.raises(ValueError, match="impl"):
        temb.embedding_bag(table, ids, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.bag_reduce(torch.ones(2, 3, 4), torch.ones(2, 3), impl="pallas")


def _ragged_manual(table, flat, seg, n_bags, combine):
    out = np.zeros((n_bags, table.shape[1]), np.float32)
    cnt = np.zeros(n_bags, np.float32)
    for i, s in zip(flat, seg):
        if 0 <= s < n_bags and i >= 0:
            out[s] += table[min(i, table.shape[0] - 1)]
            cnt[s] += 1
    return out / np.maximum(cnt, 1.0)[:, None] if combine == "mean" else out


@pytest.mark.parametrize("combine", ["sum", "mean"])
@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_bags=st.integers(1, 12),
    n_ids=st.integers(1, 64),
)
def test_property_ragged_matches_jax_and_grouping(combine, seed, n_bags, n_ids):
    """Ragged bags == JAX's segment_sum bags == manual per-bag sums."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(30, 4)).astype(np.float32)
    flat = rng.integers(-1, 30, size=n_ids).astype(np.int32)
    seg = np.sort(rng.integers(0, n_bags, size=n_ids)).astype(np.int32)
    got = temb.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                    torch.from_numpy(seg), n_bags, combine)
    want = jemb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                     jnp.asarray(seg), n_bags, combine)
    _close(got, want, 1e-6)
    np.testing.assert_allclose(got.numpy(), _ragged_manual(table, flat, seg, n_bags, combine),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_drops_segments_outside_the_bags(combine, dtype):
    rng = np.random.default_rng(11)
    (jtable, table), _, _ = _bag_case(rng, 20, 1, 1, dtype)
    flat = rng.integers(-1, 25, size=40).astype(np.int32)  # padding and ids >= V
    seg = rng.integers(-2, 9, size=40).astype(np.int32)  # n_bags = 6: 6..8 and <0 drop
    (jflat, tflat), (jseg, tseg) = _ids(flat), _ids(seg)
    got = temb.embedding_bag_ragged(table, tflat, tseg, 6, combine)
    want = jemb.embedding_bag_ragged(jtable, jflat, jseg, 6, combine)
    assert tuple(got.shape) == (6, 16) and got.dtype == table.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(7,), (5, 3)])
def test_sharded_field_lookup_unsharded_matches_jax(dtype, shape):
    rng = np.random.default_rng(3)
    (jtable, table), _, _ = _bag_case(rng, 40, 1, 1, dtype)
    jids, ids = _ids(rng.integers(-1, 45, size=shape).astype(np.int32))
    got = temb.sharded_field_lookup(table, ids, None)
    want = jemb.sharded_field_lookup(jtable, jids, None)
    assert tuple(got.shape) == (*shape, 16)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


def test_sharded_field_lookup_with_a_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="A7"):
        temb.sharded_field_lookup(torch.ones(4, 2), torch.zeros(3, dtype=torch.int32),
                                  shard_ctx=object())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg,name", [(_mind_reduced, "item_emb"),
                                      (_autoint_reduced, "field_emb")])
def test_table_from_numpy_is_bit_exact(dtype, cfg, name):
    """A JAX-built table crosses into the port bit for bit, and the lookup agrees."""
    c = dataclasses.replace(cfg(), dtype=getattr(jnp, dtype))
    src = np.asarray(init_rec(jax.random.PRNGKey(0), c)[name])
    assert str(src.dtype) == dtype
    t = table_from_numpy(src, device="cpu")
    bits = np.int32 if dtype == "float32" else np.int16
    assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == src.shape
    np.testing.assert_array_equal(t.view(getattr(torch, bits.__name__)).numpy(),
                                  src.view(bits))
    jids, ids = _ids(np.random.default_rng(0).integers(-1, src.shape[0], size=(6, 5)))
    for impl, jax_impl in IMPL_PAIRS:
        _close(temb.embedding_bag(t, ids, impl=impl),
               jemb.embedding_bag(jnp.asarray(src), jids, impl=jax_impl), TOL[dtype])


def test_table_from_numpy_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        table_from_numpy(np.ones((3, 2), np.float64), device="cpu")
